"""The bf16 SDDMM backward (10b) on the CPU: its exact summing order and the
lists its blocks build.

* ``tests/edge_order.py``'s ``sddmm_backward_exact`` (each message g·x
  rounded to bf16, summed in f32 in each node's edge order from zero, the
  sum rounded once) equals the port's ``sddmm_backward_plain`` in bits on
  every ``EDGE_CASES`` case, and lies within the bf16 gap rule of
  ``tests/test_torch_port_bf16.py`` of gcn_tpu's ``sddmm`` backward (Pallas
  in interpret mode).  The card tests hold the kernel to it in bits.
* ``block_lists`` emulates ``sddmm_bwd_bf16_kernel`` (``csrc/sddmm.cu``) in
  numpy: the launcher's nodes a block, windows and entry capacity; each
  block's counts by warp over runs of 32-edge steps, the scanned starts,
  the offsets by warp, the placement by every warp with
  ``__match_any_sync`` ranks, the passes of at most ``cap`` entries (a
  longer row alone, in parts), the warps' shares of a pass and their walks
  ``kQueue`` entries at a time, the column rounds.  What it gathers for
  each row, in order, equals ``edge_lists_plain``'s list of that node, on
  hypothesis-made edges (duplicates, self edges, ends outside [0, N), all
  slots masked, a star, E ≫ N) at the kernel's constants and at small ones
  that force windows, passes and parts.
* ``zero_runs`` emulates how the kernel's warps cut the empty rows into
  runs for its bulk copies of zeros (a lane's two rows, a warp's 64, no
  run across row r, where dv's rows start): every empty row is zeroed
  once, and no other.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gcn_tpu_torch.ops import sddmm as mod
from tests.edge_order import bf16_bits, bf16_values, sddmm_backward_exact
from tests.test_torch_port_bf16 import gap_check
from tests.test_torch_port_cuda import EDGE_CASES, edge_case
from tests.test_torch_port_cuda import one_torch_thread  # noqa: F401

B, N, E = 3, 10, 10
SOURCE = (Path(mod.__file__).resolve().parent.parent / "csrc"
          / "sddmm.cu").read_text()


def constant(name: str) -> int:
    """A constexpr int of csrc/sddmm.cu: a product of numbers and other
    constants."""
    m = re.search(rf"constexpr int {name} = ([\w *]+);", SOURCE)
    value = 1
    for factor in m.group(1).split("*"):
        factor = factor.strip()
        value *= int(factor) if factor.isdigit() else constant(factor)
    return value


KERNEL = {"warps": constant("kBwdWarps"), "max_rows": constant("kMaxRows"),
          "window": constant("kWindow"), "cap": constant("kMaxEntries"),
          "queue": constant("kQueue"), "wave": constant("kWaveBlocks")}


def bf16_inputs(case, h, seed=0):
    parent, child, mask = edge_case(case, B, N, E)
    rng = np.random.RandomState(len(case) + seed)
    u, v = (bf16_values(bf16_bits(rng.randn(B, N, h).astype(np.float32)))
            for _ in range(2))
    g = rng.randn(B, E).astype(np.float32)
    return (parent, child, mask), g, u, v


@pytest.mark.parametrize("h", [16, 200])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_exact_order_is_the_plain_version_in_bits(case, h):
    edges, g, u, v = bf16_inputs(case, h)
    tu, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (u, v))
    got = mod.sddmm_backward_plain(*(torch.from_numpy(a) for a in edges),
                                   torch.from_numpy(g), tu, tv)
    for a, want in zip(got, sddmm_backward_exact(*edges, g, u, v)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            a.view(torch.int16).numpy().view(np.uint16), want)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_exact_order_matches_jax_by_the_bf16_gap(case):
    """du and dv of the exact order against gcn_tpu's custom VJP in bf16,
    by the gap rule (JAX's f32 and bf16, the port's f32 plain version)."""
    import jax
    import jax.numpy as jnp

    from gcn_tpu.ops.pallas.sddmm import sddmm as jax_sddmm

    edges, g, u, v = bf16_inputs(case, 16, seed=3)
    out = {}
    for name, jdt in (("32", jnp.float32), ("16", jnp.bfloat16)):
        _, vjp = jax.vjp(lambda a, c: jax_sddmm(*edges, a, c),
                         jnp.asarray(u, jdt), jnp.asarray(v, jdt))
        out[name] = list(vjp(jnp.asarray(g)))
    p32 = mod.sddmm_backward_plain(*(torch.from_numpy(a) for a in edges),
                                   torch.from_numpy(g), torch.from_numpy(u),
                                   torch.from_numpy(v))
    p16 = [bf16_values(bits) for bits in sddmm_backward_exact(*edges, g, u,
                                                              v)]
    gap_check(f"sddmm backward exact order ({case})", p16, list(p32),
              out["16"], out["32"])


# ------------------------------------------------- the kernel's lists
def launch(b, n, e, k):
    """The launcher's (nodes a block, window, cap) for constants k."""
    per = k["wave"] // b if b < k["wave"] else 1
    nodes = min(max(-(-n // per), 1), k["max_rows"] // 2)
    window = min(e, k["window"]) if e > 0 else 1
    cap = min(2 * e, k["cap"]) if e > 0 else 1
    return nodes, window, cap


def first_at_least(start, lo, hi, x):
    """The first j in [lo, hi] with start[j] >= x (start[hi] >= x), as the
    kernel's ``find``: 32 probes a round, the step between the first that
    holds and the one before kept."""
    while lo < hi:
        step = (hi - lo + 32) // 32
        probes = [min(hi, lo + step * (lane + 1) - 1) for lane in range(32)]
        f = next(lane for lane in range(32) if start[probes[lane]] >= x)
        lo, hi = lo if f == 0 else probes[f - 1] + 1, probes[f]
    return lo


def block_lists(p, c, n, i0, nodes, window, cap, k, hv):
    """One block of the kernel on one sentence's edges (p, c: -1 where the
    edge does not count): for each column round, {local row: [(edge,
    neighbour), ...] in the order the block adds them}, each row stored
    once; and the rows it stores as zeros."""
    warps, queue = k["warps"], k["queue"]
    e = len(p)
    r = min(nodes, n - i0)
    rows = 2 * r
    keys = (np.asarray(p), np.asarray(c))

    def row_of(lst, idx):
        key = keys[lst][idx]
        inside = (key >= i0) & (key < i0 + r)
        return np.where(inside, lst * r + key - i0, -1)

    def steps_of(length, w):
        steps = -(-length // 32)
        each = -(-steps // warps)
        s0 = min(steps, w * each)
        return s0, min(steps, s0 + each)

    def count(w0, length):
        cnt = np.zeros((warps, rows + 1), np.int64)
        for w in range(warps):
            s0, s1 = steps_of(length, w)
            idx = w0 + np.arange(32 * s0, min(32 * s1, length))
            for lst in (0, 1):
                np.add.at(cnt[w], row_of(lst, idx), 1)  # -1: slot rows
        return cnt[:, :rows]

    windows = range(0, e, window)
    totals = np.zeros(rows, np.int64)
    for w0 in windows:
        totals += count(w0, min(window, e - w0)).sum(0)
    start = np.concatenate([[0], np.cumsum(totals)])
    total = int(start[rows])
    zeros = [j for j in range(rows) if start[j + 1] == start[j]]
    one_pass = total <= cap
    placed, ent, rounds = False, None, []

    def place(t0, t1):
        out = [None] * cap
        cursor = start[:rows].copy()
        for w0 in windows:
            length = min(window, e - w0)
            cnt = count(w0, length)
            offs = cursor + np.concatenate(
                [np.zeros((1, rows), np.int64), np.cumsum(cnt, 0)[:-1]])
            cursor = cursor + cnt.sum(0)
            for w in range(warps):
                s0, s1 = steps_of(length, w)
                for s in range(s0, s1):
                    idx = w0 + 32 * s + np.arange(32)
                    live = idx < w0 + length
                    idx = np.where(live, idx, 0)
                    for lst in (0, 1):
                        step_rows = np.where(live, row_of(lst, idx), -1)
                        for lane in range(32):
                            row = step_rows[lane]
                            if row < 0:
                                continue
                            peers = step_rows == row
                            at = offs[w, row] + int(peers[:lane].sum())
                            if t0 <= at < t1:
                                out[at - t0] = (int(idx[lane]),
                                                int(keys[1 - lst][idx[lane]]),
                                                int(row))
                        for row in set(step_rows.tolist()) - {-1}:
                            offs[w, row] += int((step_rows == row).sum())
        return out

    for _ in range(0, hv, 32):
        got = {}
        state = {"cur": -1, "seq": []}

        def store():
            assert state["cur"] not in got, "a row stored twice"
            got[state["cur"]] = state["seq"]

        def walk(s, s_end, t0):
            for q in range(s, s_end, queue):
                batch = [ent[q + j - t0] for j in range(queue)
                         if q + j < s_end]
                for edge, nbr, row in batch:
                    if row != state["cur"]:
                        if state["cur"] >= 0:
                            store()
                        state["cur"], state["seq"] = row, []
                    state["seq"].append((edge, nbr))

        ra = 0
        while ra < rows and start[ra] < total:
            if start[rows] <= start[ra] + cap:
                rb = rows
            else:
                rb = first_at_least(start, ra, rows,
                                    start[ra] + cap + 1) - 1
            parts = rb == ra
            if parts:
                rb = ra + 1
            for t0 in range(int(start[ra]), int(start[rb]), cap):
                t1 = min(t0 + cap, int(start[rb]))
                if not (one_pass and placed):
                    ent = place(t0, t1)
                    placed = True
                if parts:  # warp 0 carries the row from part to part
                    if t0 == start[ra]:
                        state["cur"] = -1
                    walk(t0, t1, t0)
                    if t1 == start[rb]:
                        store()
                        state["cur"] = -1
                else:
                    span = t1 - t0
                    for w in range(warps):
                        s = start[first_at_least(start, ra, rb,
                                                 t0 + span * w // warps)]
                        s_end = start[first_at_least(
                            start, ra, rb, t0 + span * (w + 1) // warps)]
                        state["cur"] = -1
                        walk(int(s), int(s_end), t0)
                        if state["cur"] >= 0:
                            store()
            ra = rb
        rounds.append(got)
    return rounds, zeros


def assert_kernel_lists(parent, child, mask, n, k, hv=25):
    """Every block's gathered lists equal ``edge_lists_plain``'s."""
    b, e = parent.shape
    nodes, window, cap = launch(b, n, e, k)
    plain = mod.edge_lists_plain(*(torch.from_numpy(a) for a in
                                   (parent, child, mask)), n).numpy()
    ok = ((mask != 0) & (parent >= 0) & (parent < n) & (child >= 0)
          & (child < n))
    for s in range(b):
        p = np.where(ok[s], parent[s], -1)
        c = np.where(ok[s], child[s], -1)
        ents = [plain[s, 2 * (n + 1) + 2 * j * e:
                      2 * (n + 1) + 2 * (j + 1) * e].reshape(e, 2)
                for j in (0, 1)]
        for i0 in range(0, n, nodes):
            r = min(nodes, n - i0)
            rounds, zeros = block_lists(p, c, n, i0, nodes, window, cap, k,
                                        hv)
            assert len(rounds) == -(-hv // 32)
            for got in rounds:
                assert sorted(list(got) + zeros) == list(range(2 * r))
                for row in range(2 * r):
                    lst, node = row // r, i0 + row % r
                    at = plain[s, lst * (n + 1) + node:
                               lst * (n + 1) + node + 2]
                    want = [tuple(x) for x in ents[lst][at[0]:at[1]]]
                    assert got.get(row, []) == want, (s, lst, node)


def forest(rng, b, n):
    parent = np.zeros((b, n), np.int32)
    child = np.zeros((b, n), np.int32)
    mask = np.zeros((b, n), bool)
    for i in range(b):
        length = n if i == 0 else int(rng.randint(n // 2, n + 1))
        order = rng.permutation(length)
        for q in range(1, length):
            parent[i, q - 1] = order[rng.randint(0, q)]
            child[i, q - 1] = order[q]
        mask[i, :length - 1] = True
    return parent, child, mask


# small constants: windows of 40 edges, passes of 24 entries, parts
SMALL_K = {"warps": 3, "max_rows": 12, "window": 40, "cap": 24, "queue": 4,
           "wave": 7}


@pytest.mark.parametrize("k", [KERNEL, SMALL_K], ids=["kernel", "small"])
@pytest.mark.parametrize("case", EDGE_CASES + ["forest_96", "star_80"])
def test_kernel_lists_on_the_cases(case, k):
    if case == "forest_96":  # the main path's N=96 bucket, B=50
        edges, n = forest(np.random.RandomState(0), 50, 96), 96
    elif case == "star_80":  # one list of 80 entries, more than cap
        edges, n = edge_case("random", 2, 30, 80), 30
        edges[0][:], edges[2][:] = 7, True
    else:
        edges, n = edge_case(case, B, N, E), N
    assert_kernel_lists(*edges, n, k)


@st.composite
def edge_sets(draw):
    """[B, E] edges with duplicates, self edges, ends outside [0, N),
    masked sentences and slots, stars, and E up to 12 N."""
    b = draw(st.integers(1, 3))
    n = draw(st.integers(1, 20))
    e = draw(st.integers(0, 12 * n))
    rng = np.random.RandomState(draw(st.integers(0, 2 ** 31 - 1)))
    parent = rng.randint(-1, n + 2, (b, e)).astype(np.int32)
    child = rng.randint(-1, n + 2, (b, e)).astype(np.int32)
    if draw(st.booleans()):  # in range
        parent, child = parent.clip(0, n - 1), child.clip(0, n - 1)
    mask = rng.rand(b, e) < draw(st.sampled_from([0.0, 0.5, 1.0]))
    shape = draw(st.sampled_from(["random", "star", "self", "duplicates"]))
    if shape == "star" and e:
        parent[:] = rng.randint(0, n)
    elif shape == "self":
        child[:] = parent
    elif shape == "duplicates" and e > 1:
        parent[:, e // 2:2 * (e // 2)] = parent[:, :e // 2]
        child[:, e // 2:2 * (e // 2)] = child[:, :e // 2]
    return parent, child, mask, n


@settings(max_examples=60, deadline=None)
@given(edge_sets(), st.sampled_from([
    SMALL_K,
    {**SMALL_K, "warps": 2, "window": 33, "cap": 5, "queue": 1},
    {**SMALL_K, "window": 1, "cap": 1, "max_rows": 2, "wave": 1},
    {**KERNEL, "window": 64, "cap": 64}]),
    st.sampled_from([8, 33, 70]))
def test_kernel_lists_on_hypothesis_edges(edges, k, hv):
    parent, child, mask, n = edges
    assert_kernel_lists(parent, child, mask, n, k, hv)


def spread(x):
    """Bit l of a 32-bit x to bit 2l (``spread`` in csrc/sddmm.cu)."""
    return sum(((x >> bit) & 1) << (2 * bit) for bit in range(32))


def zero_runs(empty, r):
    """The kernel's (first row, rows) bulk copies of zeros for the empty
    rows ``empty`` (bool [2 r]): lane l of warp w holds rows 64 w + 2 l and
    + 1."""
    rows = len(empty)
    runs = []
    for w in range(-(-rows // 64)):
        base = 64 * w
        flag = [base + k < rows and bool(empty[base + k]) for k in range(64)]
        ballots = [sum(1 << lane for lane in range(32) if flag[2 * lane + q])
                   for q in (0, 1)]
        m = spread(ballots[0]) | spread(ballots[1]) << 1
        for k in range(64):
            row = base + k
            if not flag[k] or (k > 0 and row != r and (m >> (k - 1)) & 1):
                continue
            inv = ~(m >> k) & (2 ** 64 - 1)
            ln = (inv & -inv).bit_length() - 1 if inv else -1
            if ln < 0 or ln > 64 - k:
                ln = 64 - k
            if row < r:
                ln = min(ln, r - row)
            runs.append((row, ln))
    return runs


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 256), st.integers(0, 2 ** 31 - 1),
       st.sampled_from([0.0, 0.3, 0.9, 1.0]))
def test_zero_runs_cover_the_empty_rows_once(r, seed, share):
    empty = np.random.RandomState(seed).rand(2 * r) < share
    covered = np.zeros(2 * r, int)
    for row, ln in zero_runs(empty, r):
        assert ln >= 1 and (row >= r or row + ln <= r)  # one list a run
        covered[row:row + ln] += 1
    np.testing.assert_array_equal(covered, empty.astype(int))
