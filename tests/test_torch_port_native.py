"""The port's native graph builder against gcn_tpu's pruning, on the CPU.

* ``prune_graph_batch_native`` (``csrc/graph_builder.cpp``, built here
  with the host compiler) equals ``gcn_tpu.graph.prune.prune_graph`` and
  gcn_tpu's own native builder in bits (edge count, edges, deprels,
  ``keep``, root) on the reference goldens, every sentence of the in-repo
  TACRED and SemEval splits, seed 11's committed split, and random trees
  (lengths 1-120, entity spans at the ends and overlapping, several
  roots), at ``prune_k`` -1, 0, 1 and 2.  A row gcn_tpu's walker cannot
  prune (entities in two trees of a forest) raises ``ValueError`` in both
  of the port's walkers; so do cyclic and rootless rows.
* ``RelationDataset`` with the native builder and under
  ``GCN_TPU_NATIVE=0`` gives every array of every batch in bits, for
  ``Batcher``, ``PackedBatcher``, a batcher with ``halo_devices`` 2 and a
  ``ShardedBatcher``; so does gcn_tpu's ``RelationDataset``.
* The loaded library lies under ``gcn_tpu_torch/_build/`` and records no
  ``-march`` but the compiler's default; a failed build raises and names
  the switch; two processes that build at once both load a whole library.
* ``graph_to_dense_adj`` equals gcn_tpu's.
"""

import glob
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from gcn_tpu import config as jax_config
from gcn_tpu.data.dataset import Batcher as JaxBatcher
from gcn_tpu.data.dataset import PackedBatcher as JaxPacked
from gcn_tpu.data.dataset import RelationDataset as JaxDataset
from gcn_tpu.data.vocab import Vocab as JaxVocab
from gcn_tpu.graph import native as jax_native
from gcn_tpu.graph import prune as jax_prune
from gcn_tpu_torch import config, constants, constants_semeval
from gcn_tpu_torch.data.dataset import (Batcher, PackedBatcher,
                                        RelationDataset, get_positions)
from gcn_tpu_torch.data.sharding import ShardedBatcher
from gcn_tpu_torch.data.vocab import Vocab
from gcn_tpu_torch.graph import native
from gcn_tpu_torch.graph.prune import graph_to_dense_adj, prune_graph
from gcn_tpu_torch.ops import _cuda
from tests.conftest import load_golden
from tests.test_torch_port_model import REPO

PRUNE_KS = [-1, 0, 1, 2]
SEED11 = os.path.join(REPO, ".campaign_r5", "flagship", "seed11", "data")
IN_REPO = sorted(glob.glob(os.path.join(REPO, "dataset", "tacred", "*.json"))
                 + glob.glob(os.path.join(REPO, "dataset", "semeval",
                                          "*.json")))
SPLITS = {"in_repo": IN_REPO,
          "seed11": [os.path.join(SEED11, f"{s}.json")
                     for s in ("train", "dev", "test")]}
# gcn_tpu loads its library once a process and remembers the answer: ask
# now, before any test here sets GCN_TPU_NATIVE=0
JAX_NATIVE = jax_native.native_available()


def rows_of(path: str) -> list[tuple]:
    """(head, deprel, subj_pos, obj_pos) of every sentence of a JSON split,
    as ``RelationDataset._preprocess`` makes them."""
    table = (constants_semeval if "semeval" in path else constants)
    out = []
    with open(path) as f:
        for d in json.load(f):
            n = len(d["token"])
            deprel = np.asarray([table.DEPREL_TO_ID.get(t, constants.UNK_ID)
                                 for t in d["stanford_deprel"]], np.int32)
            out.append((np.asarray(d["stanford_head"], np.int32), deprel,
                        np.asarray(get_positions(d["subj_start"],
                                                 d["subj_end"], n), np.int32),
                        np.asarray(get_positions(d["obj_start"],
                                                 d["obj_end"], n), np.int32)))
    return out


def padded(rows: list[tuple]):
    """The rows as [B, N] arrays (entity positions padded with 10**6, as
    the loaders pad them) and [B] lengths."""
    b, n = len(rows), max(len(r[0]) for r in rows)
    heads = np.zeros((b, n), np.int32)
    deprels = np.zeros((b, n), np.int32)
    subj = np.full((b, n), 10**6, np.int32)
    obj = np.full((b, n), 10**6, np.int32)
    lengths = np.zeros(b, np.int32)
    for i, (h, d, s, o) in enumerate(rows):
        L = len(h)
        heads[i, :L], deprels[i, :L], subj[i, :L], obj[i, :L] = h, d, s, o
        lengths[i] = L
    return heads, deprels, subj, obj, lengths


def assert_rows_equal(out, rows, k, what=""):
    """The batch result ``out`` row by row against gcn_tpu's Python
    walker."""
    ep, ec, ed, em, keep, ne, roots = out
    for i, (h, d, s, o) in enumerate(rows):
        g = jax_prune.prune_graph(h, d, len(h), k, s, o)
        e = int(ne[i])
        msg = f"{what} row {i} k={k}"
        assert e == g.num_edges, msg
        np.testing.assert_array_equal(ep[i, :e], g.edge_parent, msg)
        np.testing.assert_array_equal(ec[i, :e], g.edge_child, msg)
        np.testing.assert_array_equal(ed[i, :e], g.edge_deprel, msg)
        assert em[i, :e].all() and not em[i, e:].any(), msg
        assert not (ep[i, e:].any() or ec[i, e:].any() or ed[i, e:].any())
        np.testing.assert_array_equal(keep[i, :len(h)], g.keep, msg)
        assert not keep[i, len(h):].any(), msg
        assert int(roots[i]) == g.root, msg


def assert_same_as_jax_native(out, batch, k):
    """The port's batch result equals gcn_tpu's native builder's, array by
    array, where gcn_tpu's library loads."""
    if not JAX_NATIVE:
        return
    theirs = jax_native.prune_graph_batch_native(*batch, k)
    for a, b in zip(out, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_matches_gcn_tpu_on_the_reference_goldens():
    z = load_golden("prune_goldens.npz")
    for j in range(int(z["num"])):
        n, k = int(z[f"n_{j}"]), int(z[f"prune_{j}"])
        row = tuple(z[f"{f}_{j}"].astype(np.int32)[:n] for f in
                    ("head", "deprel", "subj_pos", "obj_pos"))
        batch = padded([row])
        out = native.prune_graph_batch_native(*batch, k)
        assert_rows_equal(out, [row], k, f"golden {j}")
        assert_same_as_jax_native(out, batch, k)


@pytest.mark.parametrize("k", PRUNE_KS)
@pytest.mark.parametrize("split", sorted(SPLITS))
def test_matches_gcn_tpu_on_every_sentence(split, k):
    for path in SPLITS[split]:
        rows = rows_of(path)
        batch = padded(rows)
        out = native.prune_graph_batch_native(*batch, k)
        assert_rows_equal(out, rows, k, os.path.basename(path))
        assert_same_as_jax_native(out, batch, k)
        for i, row in enumerate(rows[:50]):  # and the port's own walker
            g = prune_graph(row[0], row[1], len(row[0]), k, row[2], row[3])
            np.testing.assert_array_equal(
                out[0][i, :int(out[5][i])], g.edge_parent)


def random_rows(rng, count: int) -> list[tuple]:
    """Random trees of 1-120 tokens, 40 % of them forests of two or three
    roots; entity spans anywhere, at either end, or overlapping."""
    rows = []
    for i in range(count):
        n = int(rng.randint(1, 121)) if i else 120
        order = rng.permutation(n)
        roots = min(n, 1 if rng.rand() < 0.6 else int(rng.randint(2, 4)))
        head = np.zeros(n, np.int32)
        for j in range(roots, n):  # each token hangs off an earlier one
            head[order[j]] = order[rng.randint(0, j)] + 1
        kind = rng.randint(4)
        if kind == 0:     # at the two ends
            ss, se, os_, oe = 0, int(rng.randint(0, n)), n - 1, n - 1
        elif kind == 1:   # overlapping
            ss = int(rng.randint(0, n))
            se = int(rng.randint(ss, n))
            os_ = int(rng.randint(ss, se + 1))
            oe = int(rng.randint(os_, n))
        else:
            ss, os_ = (int(x) for x in rng.randint(0, n, 2))
            se = min(n - 1, ss + int(rng.randint(0, 3)))
            oe = min(n - 1, os_ + int(rng.randint(0, 3)))
        rows.append((head, rng.randint(1, 42, n).astype(np.int32),
                     np.asarray(get_positions(ss, se, n), np.int32),
                     np.asarray(get_positions(os_, oe, n), np.int32)))
    return rows


@pytest.mark.parametrize("k", PRUNE_KS)
def test_matches_gcn_tpu_on_random_trees(k):
    rows = random_rows(np.random.RandomState(11 + k), 400)
    good, bad = [], []
    for row in rows:
        try:
            jax_prune.prune_graph(row[0], row[1], len(row[0]), k, row[2],
                                  row[3])
            good.append(row)
        except (ValueError, TypeError, StopIteration):
            bad.append(row)
    # the forests give both kinds of row where entities are needed
    assert len(good) > 200 and (k < 0 or len(bad) > 10), (len(good), len(bad))
    assert not bad or k >= 0
    batch = padded(good)
    out = native.prune_graph_batch_native(*batch, k)
    assert_rows_equal(out, good, k, "random")
    assert_same_as_jax_native(out, batch, k)
    for row in bad:  # entities in two trees: no common ancestor
        with pytest.raises(ValueError, match="malformed"):
            native.prune_graph_batch_native(*padded([row]), k)
        with pytest.raises(ValueError, match="malformed"):
            prune_graph(row[0], row[1], len(row[0]), k, row[2], row[3])


@pytest.mark.parametrize("heads,obj", [([2, 1, 0], 2), ([2, 3, 1], 2),
                                       ([0, 1, 4, 3], 1)],
                         ids=["cycle", "rootless", "cycle_off_the_path"])
@pytest.mark.parametrize("k", [0, 1, 2])
def test_cyclic_and_rootless_rows_raise_on_both_walkers(heads, obj, k):
    """The subject is token 0; in the last case only the walk to the path
    meets the cycle."""
    n = len(heads)
    row = (np.asarray(heads, np.int32), np.ones(n, np.int32),
           np.asarray(get_positions(0, 0, n), np.int32),
           np.asarray(get_positions(obj, obj, n), np.int32))
    with pytest.raises(ValueError, match="malformed"):
        native.prune_graph_batch_native(*padded([row]), k)
    with pytest.raises(ValueError):
        prune_graph(row[0], row[1], n, k, row[2], row[3])
    with pytest.raises(ValueError):
        jax_prune.prune_graph(row[0], row[1], n, k, row[2], row[3])


def test_bad_arguments_raise():
    batch = padded(rows_of(IN_REPO[0])[:4])
    heads = batch[0].copy()
    heads[2, 0] = batch[4][2] + 1  # a head past its sentence
    with pytest.raises(ValueError, match="past the sentence"):
        native.prune_graph_batch_native(heads, *batch[1:], 1)
    with pytest.raises(ValueError, match="lengths"):
        native.prune_graph_batch_native(*batch[:4], batch[4][:3], 1)
    with pytest.raises(ValueError, match="invalid arguments"):
        native.prune_graph_batch_native(
            *(np.zeros((0, 0), np.int32),) * 4, np.zeros(0, np.int32), 1)


def _configs(dataset: str):
    vocab = os.path.join(REPO, "dataset", "vocab" if dataset == "tacred"
                         else "vocab_semeval", "vocab.pkl")
    ov = {"model.dataset": dataset,
          "model.num_class": 42 if dataset == "tacred" else 10}
    jcfg, tcfg = jax_config.cgcn_preset(**ov), config.cgcn_preset(**ov)
    jcfg.model.vocab_size = tcfg.model.vocab_size = Vocab.load(vocab).size
    return jcfg, tcfg, vocab


def _batchers(ds, jax: bool):
    """Every batcher of the dataset that reads its graphs: train batches
    (dropout on, seeded), packed rows, halo plans of two slabs and one
    rank's share of each batch."""
    bat, packed = (JaxBatcher, JaxPacked) if jax else (Batcher,
                                                      PackedBatcher)
    out = {"batcher": bat(ds, 8, seed=3),
           "packed": packed(ds, 4, pack_len=64, seed=3)}
    halo = bat(ds, 8, seed=3)
    halo.halo_devices = 2
    out["halo"] = halo
    if not jax:
        out["sharded"] = ShardedBatcher(Batcher(ds, 8, seed=3),
                                        data_index=1, data_size=2)
    return {k: list(v) for k, v in out.items()}


def assert_batches_equal(a: list, b: list, what: str):
    assert len(a) == len(b), what
    for x, y in zip(a, b):
        assert set(x) == set(y), what
        for key in x:
            assert x[key].dtype == y[key].dtype, (what, key)
            np.testing.assert_array_equal(x[key], y[key], err_msg=(what, key))


@pytest.mark.parametrize("path", ["tacred/train.json", "tacred/dev.json",
                                  "semeval/train.json"])
def test_dataset_batches_equal_both_walkers_and_gcn_tpu(path, monkeypatch):
    dataset = path.split("/")[0]
    jcfg, tcfg, vocab = _configs(dataset)
    full = os.path.join(REPO, "dataset", path)
    fast = RelationDataset(full, tcfg, Vocab.load(vocab))
    assert all((ex.graph.dist == -1).all() for ex in fast.examples)
    mine = _batchers(fast, jax=False)
    theirs = _batchers(JaxDataset(full, jcfg, JaxVocab.load(vocab)),
                       jax=True)
    monkeypatch.setenv("GCN_TPU_NATIVE", "0")
    assert not native.native_available()
    slow = RelationDataset(full, tcfg, Vocab.load(vocab))
    assert all((ex.graph.dist >= 0).all() for ex in slow.examples)
    walked = _batchers(slow, jax=False)
    for kind in mine:
        assert mine[kind], kind
        assert_batches_equal(mine[kind], walked[kind], f"{kind} python")
        if kind in theirs:
            assert_batches_equal(mine[kind], theirs[kind], f"{kind} gcn_tpu")
    assert any(k.startswith("hplan_") for k in mine["halo"][0])


def _recorded_march(data: bytes) -> set:
    return set(re.findall(rb"-march=([\w.+-]+)", data))


def _default_march(cxx: str) -> set:
    out = subprocess.run([cxx, "-Q", "--help=target"], capture_output=True,
                         text=True, check=True).stdout
    found = re.findall(r"^\s*-march=\s+(\S+)", out, re.M)
    return {f.encode() for f in found}


def test_library_is_the_ports_own_built_without_march_native():
    lib = native.load_library()
    path = os.path.realpath(lib._name)
    assert os.path.dirname(path) == os.path.realpath(_cuda.BUILD_DIR)
    assert os.path.basename(path).startswith("libgraph_builder-")
    assert "native" + os.sep + "libgraphbuilder" not in path
    assert not any(f.startswith("-march") for f in _cuda.HOST_FLAGS)
    with open(path, "rb") as f:
        record = _recorded_march(f.read())
    # what the compiler records without a -march flag: its default target
    assert record and record == _default_march(native.LIBRARY.cxx), record
    assert lib.graph_builder_abi_version() == native.ABI_VERSION


def test_library_name_carries_the_source_and_flags(tmp_path, monkeypatch):
    (tmp_path / "graph_builder.cpp").write_bytes(
        (_cuda.CSRC / "graph_builder.cpp").read_bytes())
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    before = native.host_library().lib_path()
    monkeypatch.setattr(_cuda, "HOST_FLAGS", _cuda.HOST_FLAGS + ["-g"])
    assert native.host_library().lib_path() != before
    monkeypatch.setattr(_cuda, "HOST_FLAGS", _cuda.HOST_FLAGS[:-1])
    with open(tmp_path / "graph_builder.cpp", "a") as f:
        f.write("// edited\n")
    assert native.host_library().lib_path() != before


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_failed_build_raises_and_names_the_switch(tmp_path, compiler):
    cxx = tmp_path / "bin" / "g++"
    if compiler == "failing":  # a compiler that refuses, with its output
        cxx.parent.mkdir()
        cxx.write_text("#!/bin/sh\necho 'graph_builder.cpp:1: error: "
                       "refused' >&2\nexit 1\n")
        cxx.chmod(0o755)
    build = tmp_path / "build"
    lib = native.host_library(build_dir=build, cxx=str(cxx))
    with pytest.raises(RuntimeError, match="GCN_TPU_NATIVE=0") as err:
        native.open_library(lib)
    if compiler == "failing":
        assert "error: refused" in str(err.value)
    else:
        assert "could not be started" in str(err.value)
    assert not lib.lib_path().exists()
    assert not build.exists() or not list(build.iterdir())


WORKER = """
import sys
import numpy as np
from gcn_tpu_torch.graph import native

native.LIBRARY = native.host_library(build_dir=sys.argv[1])
heads = np.array([[2, 0, 2, 3]], np.int32)
pos = np.array([[0, 1, 2, 3]], np.int32)
out = native.prune_graph_batch_native(
    heads, np.ones_like(heads), pos, pos - 3, np.array([4], np.int32), 1)
print(native.LIBRARY.lib_path(), [a.tolist() for a in out])
"""


def test_two_processes_building_at_once_both_load_a_whole_library(
        tmp_path):
    env = {**os.environ, "PYTHONPATH": REPO}
    env.pop("GCN_TPU_NATIVE", None)
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(tmp_path)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
        outs.append(out)
    assert outs[0] == outs[1]
    assert sorted(os.listdir(tmp_path)) == [
        os.path.basename(outs[0].split()[0])]


def test_graph_to_dense_adj_matches_gcn_tpu():
    rows = rows_of(os.path.join(REPO, "dataset", "tacred", "dev.json"))
    for k in PRUNE_KS:
        for h, d, s, o in rows:
            n = len(h) + 3
            mine = graph_to_dense_adj(prune_graph(h, d, len(h), k, s, o), n)
            theirs = jax_prune.graph_to_dense_adj(
                jax_prune.prune_graph(h, d, len(h), k, s, o), n)
            assert mine.dtype == theirs.dtype
            np.testing.assert_array_equal(mine, theirs)
    empty = jax_prune.PrunedGraph(*(np.zeros(0, np.int32),) * 3,
                                  np.ones(2, bool), np.zeros(2, np.int32), 0)
    np.testing.assert_array_equal(graph_to_dense_adj(empty, 2),
                                  jax_prune.graph_to_dense_adj(empty, 2))
