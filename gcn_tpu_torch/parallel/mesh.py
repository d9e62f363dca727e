"""The ranks' layout, its process groups, and where each tensor lives
(counterpart of ``gcn_tpu.parallel.mesh``).

A ``Mesh`` lays the process group's ranks out as ``data`` × ``model``,
one device a rank, the model index fastest.  ``make_groups`` builds the
groups of both axes: for each data index the ``model`` group of its ranks
(they hold the same rows of each batch and, under a graph partition,
share the edge lists, ``parallel.edge_partition``, or the nodes,
``parallel.halo``), and for each model
index the ``data`` group (each of its ranks holds other rows, and the
gradients, the valid-row count and the evaluation are summed or gathered
over it).

Every rank holds a whole copy of every parameter and optimizer state
tensor on both axes (``param_shardings`` / ``opt_shardings`` say
``REPLICATED`` for each).  gcn_tpu places the same values, only sharded
(a vocabulary-sharded word table, hidden-sharded bilinear weights and MLP
outputs along ``model``, ``gcn_tpu/parallel/mesh.py``'s
``param_shardings`` and ``opt_shardings``); those layouts, which need a
model-parallel lookup, column-parallel linears and shard-aware
checkpoints and optimizer state, are ``ROADMAP.md`` §1 item 8c.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch.distributed as dist

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

    def rank(self, data_index: int, model_index: int) -> int:
        return data_index * self.model + model_index


@dataclass(frozen=True)
class MeshGroups:
    """One rank's place on the mesh and its two process groups (None: the
    default group, which is the whole world)."""
    data_index: int
    model_index: int
    data: Any = None    # the ranks of this rank's model index
    model: Any = None   # the ranks of this rank's data index


def make_mesh(world_size: int, data: Optional[int] = None,
              model: int = 1) -> Mesh:
    """A (data × model) layout of ``world_size`` ranks; ``data=None`` (or
    0) puts every rank the model axis leaves on ``data``."""
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


def group_ranks(mesh: Mesh) -> tuple[list, list]:
    """(the ``model`` groups' ranks by data index, the ``data`` groups'
    ranks by model index)."""
    return ([[mesh.rank(i, j) for j in range(mesh.model)]
             for i in range(mesh.data)],
            [[mesh.rank(i, j) for i in range(mesh.data)]
             for j in range(mesh.model)])


def make_groups(mesh: Mesh, rank: int) -> MeshGroups:
    """``rank``'s groups.  With a model axis of 1 the data group is the
    whole world and no group is made; otherwise every rank makes every
    group, in one order (``dist.new_group`` asks all ranks to), the
    ``model`` groups by data index, then the ``data`` groups by model
    index."""
    d, m = mesh.coords(rank)
    if mesh.model == 1:
        return MeshGroups(d, m)
    model_ranks, data_ranks = group_ranks(mesh)
    model_groups = [dist.new_group(r) for r in model_ranks]
    data_groups = [dist.new_group(r) for r in data_ranks]
    return MeshGroups(d, m, data=data_groups[m], model=model_groups[d])


def param_shardings(mesh: Mesh, params: dict) -> dict:
    """Each parameter's placement: a whole copy a rank."""
    del mesh
    return {name: REPLICATED for name in params}


def opt_shardings(mesh: Mesh, state: dict) -> dict:
    """Each optimizer state tensor (``{param: {slot: tensor}}``) placed
    with its parameter: replicated."""
    del mesh
    return {name: {slot: REPLICATED for slot in slots}
            for name, slots in state.items()}
