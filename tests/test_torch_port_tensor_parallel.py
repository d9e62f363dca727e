"""The port's parameter and optimizer layouts on the mesh's ``model`` axis
(``parallel.mesh.param_shardings`` / ``opt_shardings``,
``parallel.tensor_parallel``) on the CPU: gloo worlds of
``tests/tp_worker.py`` laid out as 1 × 2 and 2 × 2 meshes, spawned once
and at the same time, while gcn_tpu runs in this process.

* The placement of every parameter equals gcn_tpu's ``param_shardings``
  spec for the same tree, for every ``adj_type``, ``deprel_shared_w`` and
  ``use_bert_embeddings``, K = 2 and 4 (the 42-class head replicated on
  4), with and without halo's ``replicate_deprel``; each slot of sgd,
  adagrad, adam, adamax and adadelta equals ``opt_shardings``'.
* In ``none``, ``edges`` and ``halo`` against gcn_tpu's model and
  ``DistributedTrainer`` on ``make_mesh(data=2, model=2)`` with its
  placement, dropout off: logits within 1e-4, the gathered gradients
  within 1e-4 of the largest |grad|, 3 steps within 1e-4; and against the
  port's ``Trainer`` within 1e-5.
* A rank holds V/K rows of ``word_emb`` and of its adagrad slot and H/K
  columns of ``gcn_deprel_w0``; every rank's gathered parameters are
  equal in bits.
* Against ``Trainer`` within 1e-5: every dropout, a clip that binds,
  ``topn`` inside rank 1's shard, ``--sparse_emb_grad true`` (also against
  the dense sharded step), a vocabulary of 129 rows (which stays
  replicated), ``conv_l2``, the non-factored transforms, the shared
  deprel weight, adam under halo.
* A 2 × 2 world's checkpoint equals ``Trainer``'s; it loads into a 1 × 2
  world, which writes it back in bits and steps as ``Trainer`` does from
  it.
"""

import contextlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_tpu.config import Config as JaxConfig
from gcn_tpu.models.gcn import GCNClassifier as JaxGCN
from gcn_tpu.parallel import halo as jax_halo
from gcn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gcn_tpu.parallel.mesh import opt_shardings as jax_opt_shardings
from gcn_tpu.parallel.mesh import param_shardings as jax_param_shardings
from gcn_tpu.train.distributed_trainer import (
    DistributedTrainer as JaxDistributedTrainer,
)
from gcn_tpu.train.optim import build_optimizer as jax_build_optimizer
from gcn_tpu.utils.shard_ctx import graph_partition as jax_graph_partition
from gcn_tpu_torch.config import cgcn_preset
from gcn_tpu_torch.convert import params_from_jax, params_to_jax
from gcn_tpu_torch.models.gcn import GCNClassifier, init_params
from gcn_tpu_torch.parallel.distributed import free_port
from gcn_tpu_torch.parallel.mesh import (
    REPLICATED,
    Mesh,
    opt_shardings,
    param_shardings,
    shard,
)
from gcn_tpu_torch.train.checkpoint import load_checkpoint
from gcn_tpu_torch.train.evaluator import batch_to_device
from gcn_tpu_torch.train.optim import build_optimizer, global_norm
from gcn_tpu_torch.train.trainer import Trainer
from tests import dp_worker
from tests import tp_worker as tw
from tests.test_torch_port_cuda import one_torch_thread  # noqa: F401
from tests.test_torch_port_model import REPO
from tests.test_torch_port_parallel import _env

TOL_JAX = 1e-4
TOL = 1e-5
WORLD_TIMEOUT = 420   # seconds a world's ranks may take
SIZES = (2, 4)        # 1 × 2 and 2 × 2
MODEL_VARIANTS = {
    "regular": {"model.adj_type": "regular"},
    "attention": {"model.adj_type": "attention"},
    "diagonal_deprel": {"model.adj_type": "diagonal_deprel"},
    "full_deprel": {},
    "shared_w": {"model.deprel_shared_w": True, "model.rnn_hidden": 8},
    "bert": {"model.use_bert_embeddings": True},
}
OPTIMIZERS = ("sgd", "adagrad", "adam", "adamax", "adadelta")


# ---------------------------------------------------------- the placement
def _jax_dim(sharding):
    """The dim a gcn_tpu ``NamedSharding`` puts on ``model``."""
    dims = [i for i, a in enumerate(sharding.spec) if a == "model"]
    assert len(dims) <= 1
    return dims[0] if dims else REPLICATED


def _jax_mesh(k: int):
    return jax_make_mesh(data=8 // k, model=k)


def _variant_params(name: str) -> dict:
    model = GCNClassifier(tw.tiny_cfg(**MODEL_VARIANTS[name]).model)
    return dict(model.named_parameters())


def _jax_leaves(tree) -> list:
    """(path keys, sharding) of every leaf of a tree of shardings."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: hasattr(s, "spec"))
    return [([str(getattr(p, "key", getattr(p, "name", p))) for p in path],
             sharding) for path, sharding in flat]


@pytest.mark.parametrize("replicate", [False, True])
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("name", sorted(MODEL_VARIANTS))
def test_placement_matches_gcn_tpus_param_shardings(name, k, replicate):
    params = _variant_params(name)
    got = param_shardings(Mesh(1, k), params, replicate_deprel=replicate)
    want = {".".join(keys[1:]): _jax_dim(s) for keys, s in _jax_leaves(
        jax_param_shardings(_jax_mesh(k), params_to_jax(params),
                            replicate_deprel=replicate))}
    assert got == want
    if name != "bert":
        assert got["word_emb"] == 0
    # the 42-class head divides 2, not 4
    assert got["classifier.kernel"] == (1 if k == 2 else REPLICATED)
    assert got["mlp0.kernel"] == 1 and got["classifier.bias"] == REPLICATED
    if name in ("full_deprel", "shared_w"):
        w = "gcn_deprel_w" if name == "shared_w" else "gcn_deprel_w0"
        assert got[w] == (REPLICATED if replicate else 2)


def _jax_slot_dims(tree, names: set) -> dict:
    """``{param: {slot: dim}}`` of gcn_tpu's ``opt_shardings`` tree: a
    leaf under ``<slot>/params/<name path>``; every other leaf must be
    replicated."""
    out: dict = {}
    for keys, sharding in _jax_leaves(tree):
        if "params" not in keys:
            assert _jax_dim(sharding) == REPLICATED, keys
            continue
        at = keys.index("params")
        name = ".".join(keys[at + 1:])
        assert name in names, keys
        out.setdefault(name, {})[keys[at - 1]] = _jax_dim(sharding)
    return out


@pytest.mark.parametrize("replicate", [False, True])
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("optim", OPTIMIZERS)
def test_slot_placement_matches_gcn_tpus_opt_shardings(optim, k, replicate):
    params = _variant_params("full_deprel")
    opt = build_optimizer(optim, 0.1)
    opt.init(params)
    got = opt_shardings(Mesh(1, k), opt.state, params,
                        replicate_deprel=replicate)
    tree = {"params": params_to_jax(params)["params"]}
    jax_tree = jax.tree.map(jnp.asarray, tree)
    want = _jax_slot_dims(jax_opt_shardings(
        _jax_mesh(k), jax_build_optimizer(optim, 0.1).init(jax_tree),
        jax_tree, replicate_deprel=replicate), set(params))
    assert got == {n: want[n] for n in got} and set(want) <= set(got)
    place = param_shardings(Mesh(1, k), params, replicate_deprel=replicate)
    for n, slots in got.items():
        assert all(d == place[n] for d in slots.values()), n


def test_shard_cuts_contiguous_parts_in_rank_order():
    t = torch.arange(24.0).reshape(4, 6)
    assert torch.equal(torch.cat([shard(t, 1, 3, m) for m in range(3)], 1),
                       t)
    assert torch.equal(shard(t, 0, 2, 1), t[2:])
    assert shard(t, REPLICATED, 2, 1) is t


# ------------------------------------------------------------- the worlds
def _inputs():
    """The ``MODES``' configurations, weights and batches (port-made, no
    JAX: both frameworks start from them)."""
    cfg = tw.mode_cfg("none")
    model = GCNClassifier(cfg.model)
    init_params(model, torch.Generator().manual_seed(3))
    return {"cfgs": {m: tw.mode_cfg(m).to_dict() for m in tw.MODES},
            "state": model.state_dict(),
            "batches": [dp_worker.synthetic_batch(cfg, 60 + i, padded=i % 2)
                        for i in range(3)],
            "evals": [dp_worker.synthetic_batch(cfg, 70)]}


def _jax_mode(mode: str, inputs: dict) -> dict:
    """gcn_tpu on a 2 × 2 mesh with its placement: the forward's logits and
    the gradients of Σ logits² on the first batch, and 3
    ``DistributedTrainer`` steps."""
    cfg = JaxConfig.from_dict(inputs["cfgs"][mode])
    mesh = jax_make_mesh(data=2, model=2)
    batches = [jax_halo.attach_halo_plans(b, dp_worker.N, 2)
               if mode == "halo" else b for b in inputs["batches"]]
    params = jax.tree.map(jnp.asarray, params_to_jax(inputs["state"]))
    placed = jax.device_put(params, jax_param_shardings(
        mesh, params, replicate_deprel=mode == "halo"))
    model = JaxGCN(cfg.model)

    def loss(p):
        with (jax_graph_partition(mode, mesh) if mode != "none"
              else contextlib.nullcontext()):
            logits, _ = model.apply(p, batches[0], True)
        return jnp.sum(logits ** 2), logits

    (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        placed)
    jt = JaxDistributedTrainer(cfg, mesh=mesh, rng_seed=0,
                               init_batch=batches[0])
    jt.params = params
    jt._place_state()
    assert _jax_dim(jt.params["params"]["word_emb"].sharding) == 0
    losses = [float(jt.update(b)) for b in batches]
    return {"logits": np.asarray(logits),
            "grads": params_from_jax(jax.device_get(grads)),
            "losses": losses,
            "params": params_from_jax(jax.device_get(jt.params))}


def _spawn(out, args: list, size: int) -> list:
    port = free_port()
    worker = os.path.join(REPO, "tests", "tp_worker.py")
    return [subprocess.Popen([sys.executable, worker, str(out), *args],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, env=_env(r, port, size))
            for r in range(size)]


def _join(procs: list) -> None:
    try:
        for p in procs:
            o, e = p.communicate(timeout=WORLD_TIMEOUT)
            assert p.returncode == 0, (e[-3000:], o[-1000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, {world size: every rank's results}, gcn_tpu's results by
    mode, the 2 × 2 world's directory): the worlds run while gcn_tpu
    does."""
    out = tmp_path_factory.mktemp("tp")
    inputs = _inputs()
    torch.save(inputs, out / "inputs.pt")
    procs = []
    for size in SIZES:
        (out / str(size)).mkdir()
        procs += _spawn(out / str(size), [str(out / "inputs.pt")], size)
    try:
        jax_res = {m: _jax_mode(m, inputs) for m in tw.MODES}
    finally:
        _join(procs)
    worlds = {size: [torch.load(out / str(size) / f"rank{r}.pt",
                                weights_only=False) for r in range(size)]
              for size in SIZES}
    return inputs, worlds, jax_res, out / "4"


@pytest.fixture(scope="module")
def trainer_modes(runs):
    """The port's ``Trainer`` on each mode's inputs."""
    inputs = runs[0]
    out = {}
    for mode in tw.MODES:
        tr = Trainer(tw.mode_cfg(mode), inputs["state"], rng_seed=0,
                     device="cpu")
        out[mode] = dp_worker.run(tr, dp_worker.Batches(inputs["batches"]),
                                  dp_worker.Batches(inputs["evals"]))
    return out


def _params_err(got: dict, want: dict) -> float:
    assert set(got) == set(want)
    return max(float((got[k] - want[k]).abs().max())
               / max(1.0, float(want[k].abs().max())) for k in want)


def _follows(got: dict, want: dict, tol: float) -> None:
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=tol,
                               atol=tol)
    assert _params_err(got["params"], want["params"]) <= tol
    if "preds" in want:
        assert got["preds"] == want["preds"]
        np.testing.assert_allclose(got["probs"], want["probs"], atol=tol)
        assert got["eval_loss"] == pytest.approx(want["eval_loss"], rel=tol)


def _all_results(runs, key):
    return [res[key] for size in SIZES for res in runs[1][size]]


def test_ranks_hold_their_parts(runs):
    """V/K rows of the word table and of its adagrad slot, H/K columns of
    the deprel weights, out/K columns of the MLP and classifier kernels;
    under halo the deprel weights whole."""
    cfg = tw.mode_cfg("none").model
    v, e, h = cfg.vocab_size, cfg.emb_dim, cfg.hidden_dim
    for mode in tw.MODES:
        for got in _all_results(runs, f"mode_{mode}"):
            shapes, slots = got["shapes"], got["slot_shapes"]
            assert shapes["word_emb"] == (v // 2, e)
            assert slots["word_emb"]["accum"] == (v // 2, e)
            w_cols = h if mode == "halo" else h // 2
            assert shapes["gcn_deprel_w0"][2] == w_cols
            assert slots["gcn_deprel_w0"]["accum"][2] == w_cols
            assert shapes["gcn_deprel_b0"] == (cfg.deprel_emb_dim, h)
            assert shapes["mlp0.kernel"] == (3 * h, h // 2)
            assert shapes["classifier.kernel"] == (h, cfg.num_class // 2)
            assert shapes["classifier.bias"] == (cfg.num_class,)


@pytest.mark.parametrize("mode", tw.MODES)
def test_forward_matches_gcn_tpu(mode, runs):
    want = runs[2][mode]["logits"]
    for got in _all_results(runs, f"mode_{mode}"):
        np.testing.assert_allclose(got["logits"].numpy(), want,
                                   atol=TOL_JAX, rtol=0)


@pytest.mark.parametrize("mode", tw.MODES)
def test_gathered_gradients_match_gcn_tpu(mode, runs):
    want = runs[2][mode]["grads"]
    for got in _all_results(runs, f"mode_{mode}"):
        assert set(got["grads"]) == set(want)
        for k, v in want.items():
            scale = max(float(v.abs().max()), 1e-30)
            assert float((got["grads"][k] - v).abs().max()) <= (
                TOL_JAX * scale), (mode, k)


@pytest.mark.parametrize("mode", tw.MODES)
def test_trajectory_matches_gcn_tpus_distributed_trainer(mode, runs):
    want = runs[2][mode]
    for got in _all_results(runs, f"mode_{mode}"):
        _follows(got, {"losses": want["losses"], "params": want["params"]},
                 TOL_JAX)


@pytest.mark.parametrize("mode", tw.MODES)
def test_modes_follow_trainer(mode, runs, trainer_modes):
    for got in _all_results(runs, f"mode_{mode}"):
        _follows(got, trainer_modes[mode], TOL)


@pytest.mark.parametrize("name", sorted(tw.SCENARIOS))
def test_scenarios_follow_trainer(name, runs):
    cfg, batches, evals = tw.scenario(name)
    want = dp_worker.run(Trainer(cfg, rng_seed=0, device="cpu"), batches,
                         evals)
    for got in _all_results(runs, f"traj_{name}"):
        _follows(got, want, TOL)
        assert got["sparse_emb"] == want["sparse_emb"]


def test_every_rank_holds_the_same_parameters(runs):
    for size in SIZES:
        ranks = runs[1][size]
        for key in [f"mode_{m}" for m in tw.MODES] + [
                f"traj_{n}" for n in tw.SCENARIOS]:
            first = ranks[0][key]["params"]
            for res in ranks[1:]:
                for k, v in res[key]["params"].items():
                    assert torch.equal(v, first[k]), (size, key, k)


def test_the_clip_binds(runs):
    """The clip scenario's first gradient norm lies far above its
    ``max_grad_norm``, so the sharded norm sets every update."""
    cfg, batches, _ = tw.scenario("clip")
    tr = Trainer(cfg, rng_seed=0, device="cpu")
    _, grads = tr._grads(batch_to_device(batches.batches[0], tr.device),
                         tr.step_generator(0))
    assert float(global_norm(grads)) > 4 * cfg.train.max_grad_norm
    for got in _all_results(runs, "traj_clip"):
        assert got["placement"]["word_emb"] == 0


def test_topn_inside_rank_1s_shard(runs):
    """``topn`` 100 of 128 rows: rank 1 holds rows 64-127, and rows 100
    and up never move."""
    cfg, _, _ = tw.scenario("topn")
    assert cfg.model.topn == 100
    start = Trainer(cfg, rng_seed=0, device="cpu").model.word_emb.detach()
    for got in _all_results(runs, "traj_topn"):
        emb = got["params"]["word_emb"]
        assert torch.equal(emb[100:], start[100:])
        assert not torch.equal(emb[64:100], start[64:100])


def test_sparse_step_follows_the_dense_sharded_step(runs):
    for size in SIZES:
        for res in runs[1][size]:
            sparse, dense = res["traj_sparse"], res["traj_sparse_dense"]
            assert sparse["sparse_emb"] and not dense["sparse_emb"]
            _follows(sparse, dense, TOL)


def test_a_vocabulary_the_axis_does_not_divide_stays_replicated(runs):
    for got in _all_results(runs, "traj_vocab_129"):
        assert got["placement"]["word_emb"] == REPLICATED
        assert got["shapes"]["word_emb"] == (129, 32)
        assert got["placement"]["gcn_deprel_w0"] == 2


def _tree_equal(a, b, tol=0.0, path=""):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if not isinstance(a, dict):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, path
        if tol == 0.0:
            np.testing.assert_array_equal(a, b, err_msg=path)
        else:
            np.testing.assert_allclose(a, b, atol=tol * max(
                1.0, float(np.abs(b).max(initial=0))), rtol=0, err_msg=path)
        return
    assert set(a) == set(b), path
    for k in a:
        _tree_equal(a[k], b[k], tol, f"{path}/{k}")


@pytest.fixture(scope="module")
def trainer_ckpt(tmp_path_factory):
    """``Trainer``'s checkpoint of the ``CKPT`` scenario after 3 steps."""
    cfg, batches, evals = tw.scenario(tw.CKPT)
    tr = Trainer(cfg, rng_seed=0, device="cpu")
    dp_worker.run(tr, batches, evals)
    out = tmp_path_factory.mktemp("tp_trainer") / "ckpt"
    tr.save(str(out), epoch=1)
    return str(out)


def test_checkpoint_of_a_2x2_world_equals_trainers(runs, trainer_ckpt):
    world = load_checkpoint(str(runs[3] / "ckpt"), True)
    one = load_checkpoint(trainer_ckpt, True)
    _tree_equal(world[0], one[0], TOL)
    _tree_equal(world[1], one[1], TOL)
    assert world[2]["meta"]["global_step"] == one[2]["meta"]["global_step"]


@pytest.fixture(scope="module")
def loaded(runs, tmp_path_factory):
    """A 1 × 2 world that loads the 2 × 2 world's checkpoint."""
    out = tmp_path_factory.mktemp("tp_load")
    _join(_spawn(out, ["--load", str(runs[3] / "ckpt")], 2))
    return out, [torch.load(out / f"rank{r}.pt", weights_only=False)
                 for r in range(2)]


def test_checkpoint_loads_across_meshes_and_back(runs, loaded):
    """The 2 × 2 world's checkpoint into a 1 × 2 world (its parts, the
    whole state gathered back in bits, written back in bits) and into
    ``Trainer``; one step from it in both within 1e-5."""
    out, ranks = loaded
    ckpt = str(runs[3] / "ckpt")
    params, opt_state, blob = load_checkpoint(ckpt, True)
    whole = params_from_jax(params)
    cfg = tw.scenario(tw.CKPT)[0]
    tr = Trainer(cfg, rng_seed=7, device="cpu")
    tr.load(ckpt)
    for res in ranks:
        assert res["shapes"]["word_emb"] == (64, 32)
        assert res["slot_shapes"]["word_emb"]["accum"] == (64, 32)
        assert res["global_step"] == blob["meta"]["global_step"]
        for k, v in whole.items():
            assert torch.equal(res["params"][k], v), k
        for n, st in tr.opt.state.items():
            for s, t in st.items():
                assert torch.equal(res["opt_state"][n][s], t), (n, s)
    _tree_equal(load_checkpoint(str(out / "resaved"), True)[0], params)
    _tree_equal(load_checkpoint(str(out / "resaved"), True)[1], opt_state)
    back = Trainer(cfg, rng_seed=7, device="cpu")
    back.load(str(out / "resaved"))
    for k, v in back.model.state_dict().items():
        assert torch.equal(v, whole[k]), k
    loss = float(tr.update(tw.load_batch()))
    for res in ranks:
        assert res["loss"] == pytest.approx(loss, rel=TOL)
        assert _params_err(res["stepped"], tr.model.state_dict()) <= TOL


def test_the_port_follows_cgcn_presets_placement():
    """At the preset's widths on a 2-way axis (TACRED's GloVe vocabulary
    of 53,954 rows): the table, both deprel weights and every MLP and
    classifier kernel are sharded."""
    cfg = cgcn_preset(**{"model.vocab_size": 53954})
    model = GCNClassifier(cfg.model)
    got = param_shardings(Mesh(1, 2), dict(model.named_parameters()))
    assert {n for n, d in got.items() if d != REPLICATED} == {
        "word_emb", "gcn_deprel_w0", "gcn_deprel_w1", "mlp0.kernel",
        "mlp1.kernel", "classifier.kernel"}
    # 53,954 = 2 · 26,977: a 4-way axis keeps the table replicated
    assert param_shardings(Mesh(1, 4), {"word_emb": model.word_emb})[
        "word_emb"] == REPLICATED
