"""The graph partition a forward runs under (counterpart of the partition
half of ``gcn_tpu.utils.shard_ctx``).

A ``DistributedTrainer`` whose mesh has a ``model`` axis above 1 runs its
steps and evaluation inside ``graph_partition(mode, mesh, groups)``; the
model reads ``active_partition()`` once a forward and, while one is
active, aggregates its GCN layers over the ``model`` group: through
``parallel.edge_partition`` in mode "edges" (each rank a share of the
edge lists), through ``parallel.halo`` in mode "halo" (each rank a slab
of the nodes, one boundary exchange a layer).  The context lives in a ``contextvars.ContextVar``,
so nested and concurrent uses each see their own.

gcn_tpu's other context, ``local_grouping``, has no counterpart: it moves
the factored full_deprel sort inside ``shard_map`` so that each data
shard groups its own rows, and a torch rank only ever holds its own rows,
so its grouping is shard-local already.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, NamedTuple, Optional

class Partition(NamedTuple):
    mode: str     # "edges" or "halo"
    mesh: Any     # parallel.mesh.Mesh, its model axis above 1
    groups: Any   # parallel.mesh.MeshGroups of this rank


_part_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "gcn_tpu_torch_partition", default=None)


@contextlib.contextmanager
def graph_partition(mode: str, mesh, groups):
    """Partition the GCN layers' aggregation over ``mesh``'s ``model``
    axis (``mode`` "edges": each model rank its contiguous share of the
    edge lists; "halo": each model rank its slab of the nodes).  A no-op
    for "none" (or an empty mode), for no mesh and for a ``model`` axis of
    1, where the dense path is the same math; any other mode raises
    ``ValueError``."""
    if (not mode or mode == "none" or mesh is None
            or mesh.shape["model"] <= 1):
        yield
        return
    if mode not in ("edges", "halo"):
        raise ValueError(f"unknown graph_partition mode: {mode!r}")
    token = _part_ctx.set(Partition(mode, mesh, groups))
    try:
        yield
    finally:
        _part_ctx.reset(token)


def active_partition() -> Optional[Partition]:
    """The active ``Partition``, else None."""
    return _part_ctx.get()
