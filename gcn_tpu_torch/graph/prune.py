"""Path-centric dependency-tree pruning → edge lists (a copy of
``gcn_tpu.graph.prune``: the Python walker, which ``RelationDataset`` runs
under ``GCN_TPU_NATIVE=0``; otherwise it prunes through the port's own C++
builder, ``graph.native``, which this walker is the reference of).

This is the TPU-native replacement for the reference's per-forward Python
``Tree`` construction (reference ``model/gcn.py:102-112`` calling
``model/tree.py:58-204``).  Instead of building O(N²) dense adjacency
matrices on every forward pass, we prune each sentence **once at data-load
time** and emit a compact edge list ``(parent, child, deprel)`` plus node
masks.  Dense banded adjacency is reconstructed on-device from the edge list
with a single scatter (see ``gcn_tpu_torch.ops.adjacency``).

Pruning semantics replicate the reference exactly
(``model/tree.py:81-162``):

1. collect the ancestor chain of every subject and object token,
2. ``cas`` = intersection of all chains (common ancestors),
3. LCA = the unique member of ``cas`` with no child in ``cas``,
4. ``path`` = (subj ∪ obj ancestors) − cas + {LCA},
5. every token's distance = #parent-hops along its ancestor chain to the
   nearest path node (∞ = 10000 if the chain exits through the root),
6. keep tokens with distance ≤ K; tree edges among kept tokens
   (the LCA's parent edge is dropped: reference ``model/tree.py:158``).

The adjacency *value* convention follows ``model/tree.py:184-192``: a
forward edge (parent→child) carries the **child's** deprel id; the reverse
band adds ``DEPREL_FORWARD_BOUND`` (=42); incident nodes get self-loop id 84.
Here we store just ``(parent, child, deprel[child])`` — the bands are implied.

Note: the reference's default ``prune < 0`` (no pruning) branch crashes in
``tree_to_adj`` (nodes lack ``.head``, read at ``model/tree.py:194``).  We
support no-pruning properly: all tokens kept, all tree edges emitted.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

INF_DIST = 10000  # reference model/tree.py:144 (int(1e4))


@dataclass
class PrunedGraph:
    """Edge list + node info for one sentence (host-side, numpy)."""

    edge_parent: np.ndarray  # [E] int32, 0-based token index
    edge_child: np.ndarray   # [E] int32
    edge_deprel: np.ndarray  # [E] int32 — deprel id of the *child* token
    keep: np.ndarray         # [N] bool — token survives pruning
    dist: np.ndarray         # [N] int32 — distance to dependency path
    root: int                # LCA (or sentence root when prune < 0)

    @property
    def num_edges(self) -> int:
        return int(self.edge_parent.shape[0])


def ancestor_chain(head: np.ndarray, i: int) -> list[int]:
    """Token ``i`` plus all its ancestors, in hop order (reference
    ``model/tree.py:87-109`` inner while loops).

    Guards against cyclic head arrays (malformed parses) with a hop limit —
    the reference would spin forever on such input.
    """
    chain = [i]
    h = head[i]
    limit = len(head) + 1
    while h > 0:
        chain.append(h - 1)
        h = head[h - 1]
        if len(chain) > limit:
            raise ValueError(
                f"cyclic head array: no root reachable from token {i}"
            )
    return chain


def prune_graph(
    head: np.ndarray,
    deprel: np.ndarray,
    length: int,
    prune: int,
    subj_pos: np.ndarray,
    obj_pos: np.ndarray,
) -> PrunedGraph:
    """Prune one dependency tree to ≤ ``prune`` hops off the subj–obj path.

    Args:
      head: [>=length] 1-indexed head array, 0 = sentence root.
      deprel: [>=length] deprel ids per token.
      length: true sentence length.
      prune: K (≤ distance kept); negative = keep the whole tree.
      subj_pos / obj_pos: position sequences (0 marks entity tokens).
    """
    head = np.asarray(head[:length], dtype=np.int64)
    deprel = np.asarray(deprel[:length], dtype=np.int64)
    n = int(length)

    if prune < 0:
        keep = np.ones(n, dtype=bool)
        dist = np.full(n, -1, dtype=np.int32)
        roots = np.nonzero(head == 0)[0]
        root = int(roots[-1]) if roots.size else 0
        child = np.nonzero(head > 0)[0]
        parent = head[child] - 1
        return PrunedGraph(
            edge_parent=parent.astype(np.int32),
            edge_child=child.astype(np.int32),
            edge_deprel=deprel[child].astype(np.int32),
            keep=keep,
            dist=dist,
            root=root,
        )

    subj_idx = [i for i in range(n) if subj_pos[i] == 0]
    obj_idx = [i for i in range(n) if obj_pos[i] == 0]

    # Common ancestors: intersect the chains of every entity token
    # (model/tree.py:87-109).  Chains include the token itself, so a subj
    # token that is an ancestor of all others can itself be the LCA.
    cas: set[int] | None = None
    subj_ancestors: set[int] = set()
    for s in subj_idx:
        chain = ancestor_chain(head, s)
        subj_ancestors.update(chain)
        cas = set(chain) if cas is None else cas & set(chain)
    obj_ancestors: set[int] = set()
    for o in obj_idx:
        chain = ancestor_chain(head, o)
        obj_ancestors.update(chain)
        cas = set(chain) if cas is None else cas & set(chain)
    # No entity token, or chains that end at different roots (a forest):
    # no LCA.  gcn_tpu's walker fails there with a TypeError or a
    # StopIteration; this one raises as the native builder's binding does.
    if not cas:
        raise ValueError("malformed dependency tree: the entity tokens "
                         "have no common ancestor")

    # LCA = unique common ancestor with no child inside cas
    # (model/tree.py:111-124).  In a tree, cas is a root→LCA chain, so
    # exactly one member qualifies.
    if len(cas) == 1:
        lca = next(iter(cas))
    else:
        child_count = {k: 0 for k in cas}
        for ca in cas:
            if head[ca] > 0 and head[ca] - 1 in cas:
                child_count[head[ca] - 1] += 1
        lca = next(ca for ca in cas if child_count[ca] == 0)

    path_nodes = (subj_ancestors | obj_ancestors) - cas
    path_nodes.add(lca)

    # Distance to the path along each token's ancestor chain
    # (model/tree.py:129-144).  Walk up until a path node or the root.
    dist = np.full(n, -1, dtype=np.int32)
    for p in path_nodes:
        dist[p] = 0
    for i in range(n):
        if dist[i] >= 0:
            continue
        stack = [i]
        while stack[-1] >= 0 and stack[-1] not in path_nodes:
            stack.append(int(head[stack[-1]]) - 1)
            if len(stack) > n + 1:
                raise ValueError(
                    f"cyclic head array: walk from token {i} never ends"
                )
        if stack[-1] in path_nodes:
            for d, j in enumerate(reversed(stack)):
                dist[j] = d
        else:
            for j in stack:
                if j >= 0 and dist[j] < 0:
                    dist[j] = INF_DIST

    keep = dist <= prune
    # Tree edges among kept nodes, minus the LCA's own parent edge
    # (model/tree.py:158: `if h > 0 and i != highest_node`).
    child = np.nonzero(keep & (head > 0) & (np.arange(n) != lca))[0]
    parent = head[child] - 1
    # Reference asserts the parent of every kept node is kept
    # (model/tree.py:159); it holds by construction of `dist`.
    assert keep[parent].all(), "pruning invariant violated: orphan edge"
    return PrunedGraph(
        edge_parent=parent.astype(np.int32),
        edge_child=child.astype(np.int32),
        edge_deprel=deprel[child].astype(np.int32),
        keep=keep,
        dist=dist,
        root=int(lca),
    )


def graph_to_dense_adj(
    g: PrunedGraph,
    n: int,
    forward_bound: int = 42,
    self_loop_index: int = 84,
) -> np.ndarray:
    """The reference's dense deprel-valued adjacency (``model/tree.py:
    167-204`` with ``directed=False, self_loop=True``) from an edge list,
    [n, n] f32: ``deprel`` at (parent, child), ``deprel + forward_bound``
    at (child, parent), ``self_loop_index`` on the diagonal of every node
    an edge touches (``gcn_tpu.graph.prune.graph_to_dense_adj``)."""
    adj = np.zeros((n, n), dtype=np.float32)
    p, c, d = g.edge_parent, g.edge_child, g.edge_deprel
    adj[p, c] = d
    adj[c, p] = d + forward_bound
    incident = np.unique(np.concatenate([p, c]))
    adj[incident, incident] = self_loop_index
    return adj
