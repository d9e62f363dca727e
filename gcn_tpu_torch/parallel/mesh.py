"""The ranks' layout and where each tensor lives (counterpart of
``gcn_tpu.parallel.mesh``, its ``data`` axis only).

A ``Mesh`` lays the process group's ranks out as ``data`` × ``model``,
one device a rank.  The port runs the ``data`` axis: every rank holds a
whole copy of every parameter and optimizer state tensor
(``param_shardings`` / ``opt_shardings`` say ``REPLICATED`` for each) and
takes its rows of each batch.  The ``model`` axis of gcn_tpu (a
vocabulary-sharded word table, hidden-sharded bilinear weights and MLP,
graph partitioning) is ``ROADMAP.md`` §1 item 8: a ``model`` axis above 1
raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

REPLICATED = "replicated"


@dataclass(frozen=True)
class Mesh:
    data: int
    model: int = 1

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    def coords(self, rank: int) -> tuple[int, int]:
        """(data index, model index) of ``rank``, model fastest."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        return divmod(rank, self.model)


def make_mesh(world_size: int, data: Optional[int] = None,
              model: int = 1) -> Mesh:
    """A (data × model) layout of ``world_size`` ranks; ``data=None`` (or
    0) puts every rank on ``data``."""
    if model > 1:
        raise NotImplementedError(
            f"a mesh model axis of {model}: the model axis (vocabulary and "
            f"hidden sharding, graph partitioning) is ROADMAP.md §1 item 8, "
            f"not ported to gcn_tpu_torch yet")
    model = max(model, 1)
    if not data:
        if world_size % model:
            raise ValueError(f"{world_size} ranks over a model axis of "
                             f"{model}")
        data = world_size // model
    if data * model != world_size:
        raise ValueError(f"a {data} x {model} mesh over {world_size} ranks: "
                         f"one rank a device, all of them")
    return Mesh(data, model)


def param_shardings(mesh: Mesh, params: dict) -> dict:
    """Each parameter's placement: on the data axis, a whole copy a rank."""
    del mesh
    return {name: REPLICATED for name in params}


def opt_shardings(mesh: Mesh, state: dict) -> dict:
    """Each optimizer state tensor (``{param: {slot: tensor}}``) placed
    with its parameter: replicated."""
    del mesh
    return {name: {slot: REPLICATED for slot in slots}
            for name, slots in state.items()}
