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

On the ``data`` axis every tensor is replicated.  On the ``model`` axis
``param_shardings`` and ``opt_shardings`` place the parameters and the
optimizer state as gcn_tpu's do: the word table by vocabulary, the
full_deprel weights by output hidden (not under halo), the MLP and
classifier kernels by output, each optimizer slot with its parameter,
everything else whole.  A placement is the sharded dimension, or
``REPLICATED``; a dimension that does not divide the axis stays
replicated.  ``shard`` cuts a whole tensor to a model rank's part and
``unshard`` gathers the parts back; ``parallel.tensor_parallel`` computes
with the parts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
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


def _sharded(shape, dim: int, axis: int):
    """``dim``, or ``REPLICATED`` where that dimension does not divide the
    axis (a 42-class head on a 4-way axis; GSPMD would refuse the uneven
    split)."""
    return dim if shape[dim] % axis == 0 else REPLICATED


def param_shardings(mesh: Mesh, params: dict,
                    replicate_deprel: bool = False) -> dict:
    """Each parameter's placement on the ``model`` axis, by gcn_tpu's
    rules on the port's names: ``word_emb`` [V, D] by vocabulary (dim 0),
    ``gcn_deprel_w*`` [D, T, H] by output hidden (dim 2; replicated with
    ``replicate_deprel``, which the trainer sets under
    ``graph_partition="halo"``), the ``mlp*`` and ``classifier`` kernels
    [in, out] by output (dim 1); every other tensor, and a dimension that
    does not divide the axis, ``REPLICATED``.  ``params`` maps names to
    tensors (or anything with a ``shape``)."""
    axis = mesh.model

    def rule(name: str, shape) -> Any:
        nd = len(shape)
        if "word_emb" in name and nd == 2:
            return _sharded(shape, 0, axis)
        if "gcn_deprel_w" in name and nd == 3:
            return REPLICATED if replicate_deprel else _sharded(shape, 2,
                                                               axis)
        if ("mlp" in name or "classifier" in name) and nd == 2:
            return _sharded(shape, 1, axis)
        return REPLICATED

    return {name: rule(name, tuple(p.shape)) for name, p in params.items()}


def opt_shardings(mesh: Mesh, state: dict, params: dict,
                  replicate_deprel: bool = False) -> dict:
    """Each optimizer state tensor (``{param: {slot: tensor}}``) placed
    with its parameter where its shape is the parameter's, else
    ``REPLICATED`` (gcn_tpu places a slot by its path and shape, so a
    vocabulary-sharded table shards its accumulator too)."""
    place = param_shardings(mesh, params, replicate_deprel)
    return {name: {slot: place[name]
                   if tuple(t.shape) == tuple(params[name].shape)
                   else REPLICATED
                   for slot, t in slots.items()}
            for name, slots in state.items()}


def shard(t: torch.Tensor, dim, size: int, index: int) -> torch.Tensor:
    """Model rank ``index``'s contiguous part of the whole ``t`` along
    ``dim`` (of ``size`` equal parts), a tensor of its own; ``t`` itself
    where ``dim`` is ``REPLICATED``."""
    if dim == REPLICATED:
        return t
    n = t.shape[dim] // size
    return t.narrow(dim, index * n, n).contiguous()


def unshard(t: torch.Tensor, dim, group, size: int) -> torch.Tensor:
    """The whole tensor from every model rank's part ``t`` along ``dim``
    (an all-gather over ``group``, no gradient); ``t`` where ``dim`` is
    ``REPLICATED``."""
    if dim == REPLICATED:
        return t
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)
