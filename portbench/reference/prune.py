"""Path-centric pruning of a dependency tree, as the C-GCN reference's
``model/tree.py`` prunes it: keep the tokens within ``k`` hops of the
shortest path between the subject and the object, and the tree's edges
among them but the edge above the path's highest node (the LCA)."""

from __future__ import annotations


def _chain(head: list[int], i: int) -> list[int]:
    """Token ``i`` and its ancestors (``head`` 1-indexed, 0 = root)."""
    out = [i]
    while head[out[-1]] > 0:
        out.append(head[out[-1]] - 1)
        if len(out) > len(head) + 1:
            raise ValueError("cyclic head array")
    return out


def prune(head: list[int], subj: list[int], obj: list[int],
          k: int) -> tuple[list[int], list[int]]:
    """(parents, children) of the kept edges, 0-based token indices."""
    n = len(head)
    chains = [_chain(head, i) for i in subj + obj]
    common = set(chains[0]).intersection(*chains[1:])
    if not common:
        raise ValueError("the entity tokens have no common ancestor")
    # the LCA: the common ancestor that no other common ancestor hangs off
    lca = next(a for a in common
               if not any(head[b] - 1 == a for b in common))
    path = set().union(*chains) - common | {lca}
    dist = [None] * n
    for i in range(n):
        hops, j = 0, i
        while j >= 0 and j not in path:
            j, hops = head[j] - 1, hops + 1
        dist[i] = hops if j >= 0 else None
    keep = [d is not None and d <= k for d in dist]
    children = [i for i in range(n)
                if keep[i] and head[i] > 0 and i != lca]
    return [head[c] - 1 for c in children], children
