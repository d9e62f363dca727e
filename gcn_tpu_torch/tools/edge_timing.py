#!/usr/bin/env python3
"""The edge-list kernels timed at and past the main path's sizes.

    python3 gcn_tpu_torch/tools/edge_timing.py [--tree DIR] [--cases A,B]

Times kernel 5 (``band_aggregate_forward``), kernel 6 (``pair_aggregate``),
kernel 7 (``gcn_spmm_forward``, W [T, 200]), kernel 8 (``sym_pair``) and
kernel 9 (``sddmm_forward``, u and v [B, N, 200]) over the edges of
``chip_smoke.py``'s kernel rows (``path``: its first synthetic batch,
B=50, N=E=96) and the card tests' large edge cases
(``tests/test_torch_port_cuda.py``): ``long`` (B=2, N=E=300),
``past_48kb`` (B=2, N=E=3000), ``star`` (B=3, N=E=1200, one node the
parent of every edge) and ``forest`` (B=50, N=E=1200, random trees), at
the paths' widths (H=200; T=360 and 200 for kernels 7-8), each kernel in
its f32 and its bf16 instance (``..._bf16``: the same inputs rounded).
The inputs are seeded, each case's by a generator of its own.  Each time
is ``chip_smoke.graph_ms`` of this checkout: 20 calls in one CUDA graph,
replayed, per call; beside each, the SHA-256 of the call's outputs
(``chip_smoke.out_sha256``), so that two checkouts' bits can be told
apart on the same inputs; and ``chip_smoke.py``'s yardsticks of kernels 5
and 8 (``torch.bmm`` of the prebuilt bands, ``library_ms``) by the same
clock.  ``--tree DIR`` times the package of another checkout (a parent
commit unpacked into a gitignored directory, or a variant copy) by the
same clock; ``--cases`` times some of the cases only.  Prints one JSON
line per case and dtype, then the card's name and power limit.
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CASES = {"path": (50, 96), "long": (2, 300), "past_48kb": (2, 3000),
         "star": (3, 1200), "forest": (50, 1200)}
H, TS = 200, (360, 200)


def edges(name, b, n, rng):
    """[b, n] parent, child int32 and mask bool of a case: random edges
    with 70 % of the slots set, all from node 7 (star), or random trees
    with lengths in [n/2, n] (forest)."""
    if name == "forest":
        parent = np.zeros((b, n), np.int32)
        child = np.zeros((b, n), np.int32)
        mask = np.zeros((b, n), bool)
        for i in range(b):
            length = n if i == 0 else int(rng.randint(n // 2, n + 1))
            order = rng.permutation(length)
            for k in range(1, length):
                parent[i, k - 1] = order[rng.randint(0, k)]
                child[i, k - 1] = order[k]
            mask[i, :length - 1] = True
        return parent, child, mask
    parent = rng.randint(0, n, (b, n)).astype(np.int32)
    child = rng.randint(0, n, (b, n)).astype(np.int32)
    mask = rng.rand(b, n) < 0.7
    if name == "star":
        parent[:], mask[:] = 7, True
    return parent, child, mask


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=REPO,
                        help="checkout whose gcn_tpu_torch is timed")
    parser.add_argument("--cases", default=",".join(CASES),
                        help="comma-separated cases to time (all by "
                             "default)")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("edge_timing: no CUDA device is available", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "smoke_clock", os.path.join(REPO, "chip_smoke.py"))
    clock = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(clock)
    sys.path.insert(0, os.path.abspath(args.tree))
    from gcn_tpu_torch.config import cgcn_preset
    from gcn_tpu_torch.data.vocab import Vocab
    from gcn_tpu_torch.ops import band_aggregate as band
    from gcn_tpu_torch.ops import sddmm
    from gcn_tpu_torch.ops.adjacency import build_adjacency
    from gcn_tpu_torch.ops import spmm_fused as spmm

    dev = torch.device("cuda", 0)
    vocab = Vocab.load(os.path.join(REPO, "dataset", "vocab", "vocab.pkl"))
    synth = clock.load_batches(cgcn_preset(), vocab,
                               np.random.RandomState(clock.SEED))[1]
    for index, (name, (b, n)) in enumerate(CASES.items()):
        if name not in args.cases.split(","):
            continue
        rng = np.random.RandomState([clock.SEED, index])  # a case's own
        if name == "path":
            e = clock.edge_lists(torch, synth[0], dev)
        else:
            e = [torch.from_numpy(a).to(dev)
                 for a in edges(name, b, n, rng)]
        x32 = [torch.from_numpy(rng.randn(b, n, w).astype(np.float32))
               .to(dev) for w in (H, H, H) + TS + TS]
        w32 = [torch.from_numpy((rng.randn(t, H) / np.sqrt(t)).astype(
            np.float32)).to(dev) for t in TS]
        for dtype, tag in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
            x = [a.to(dtype) for a in x32]
            calls = {
                "band_aggregate_forward":
                    lambda: band.band_aggregate_forward(*e, *x[:3]),
                "band_aggregate_pair": lambda: band.pair_aggregate(*e, x[0])}
            for i, t in enumerate(TS):
                w = w32[i].to(dtype)
                bias = torch.zeros(H, dtype=dtype, device=dev)
                calls[f"spmm_fused_forward_T{t}"] = (
                    lambda w=w, bias=bias, i=i: spmm.gcn_spmm_forward(
                        *e, x[3 + i], w, bias))
                calls[f"spmm_fused_sym_pair_T{t}"] = (
                    lambda i=i: spmm.sym_pair(*e, x[3 + i], x[5 + i]))
            calls["sddmm_forward"] = lambda: sddmm.sddmm_forward(
                *e, x[0], x[1])
            ms = {k + tag: clock.graph_ms(fn) for k, fn in calls.items()}
            sha = {k + tag: clock.out_sha256(torch, fn())
                   for k, fn in calls.items()}
            # chip_smoke.py's yardsticks for 5 and 8: bmm of the prebuilt
            # bands, timed by the same clock
            adj = build_adjacency(*e, n)
            fr = torch.cat([adj.forward, adj.reverse], dim=2).to(dtype)
            s_band = (adj.combined + torch.eye(n, device=dev)).to(dtype)
            x_fr = torch.cat([x[0], x[1]], dim=1)
            library = {"band_aggregate_forward" + tag: clock.graph_ms(
                lambda: torch.bmm(fr, x_fr))}
            for i, t in enumerate(TS):
                gh = torch.cat([x[3 + i], x[5 + i]], dim=2)
                library[f"spmm_fused_sym_pair_T{t}" + tag] = clock.graph_ms(
                    lambda gh=gh: torch.bmm(s_band, gh))
            del adj, fr, s_band
            print(json.dumps({"case": name, "dtype": str(dtype)[6:],
                              "B": b, "N": n, "E": e[0].shape[1], "H": H,
                              "tree": os.path.abspath(args.tree), "ms": ms,
                              "library_ms": library, "sha256": sha}),
                  flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
