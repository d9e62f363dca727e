"""The port's checkpoints against gcn_tpu's, on the CPU.

* ``train/flax_msgpack.py`` decodes every committed gcn_tpu checkpoint
  file under ``.campaign_r5/flagship/`` to the arrays ``msgpack`` (through
  flax) gives, and packs them back to the same bytes; it packs what
  ``msgpack.packb`` and ``flax.serialization.to_bytes`` pack, bit for bit.
* ``Optimizer.state_tree`` has optax's tree for each of the six cores (read
  from optax here, key for key, in optax's order); a state carried across
  either way and stepped on the same gradients stays within 1e-6 relative
  of the other package's.
* A gcn_tpu ``Trainer`` loads the port's checkpoint into its templates
  (``flax.serialization.from_bytes``) and the port loads gcn_tpu's: each
  resumes the other's run for each core, and 2 more steps land within
  1e-4 of max(1, max |p|) of the uninterrupted run on the other side
  (dropout off, the same batches; gradients summed in another order).
* ``Trainer.save``/``load`` round-trips the same bits, asynchronously too,
  and a checkpoint taken mid-accumulation counts only the applied steps.
"""

import json
import os
import subprocess
import threading
import time
import types

import jax
import msgpack
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from gcn_tpu.train.optim import build_optimizer as jax_build_optimizer
from gcn_tpu.train.trainer import Trainer as JaxTrainer
from gcn_tpu_torch.convert import params_from_jax, params_to_jax
from gcn_tpu_torch.data.dataset import Batcher, RelationDataset
from gcn_tpu_torch.data.vocab import Vocab
from gcn_tpu_torch.train import checkpoint as ckpt
from gcn_tpu_torch.train import flax_msgpack
from gcn_tpu_torch.train.optim import CORES, build_optimizer
from gcn_tpu_torch.train.trainer import Trainer
from tests.test_torch_port_cuda import one_torch_thread  # noqa: F401
from tests.test_torch_port_model import REPO, VOCAB, _configs
from tests.test_torch_port_train import TRAIN, NO_DROPOUT, _params_close, \
    _train_batchers

COMMITTED = sorted(
    f for f in subprocess.run(
        ["git", "ls-files", ".campaign_r5/flagship"], cwd=REPO,
        capture_output=True, text=True, check=True).stdout.split()
    if f.endswith(".msgpack"))


def _same_tree(got, want, path=""):
    """Equal keys in the same order, dtypes, shapes and values."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}/{k}")
    else:
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


def test_every_committed_checkpoint_file_is_listed():
    assert len(COMMITTED) == 16


@pytest.mark.parametrize("path", COMMITTED)
def test_codec_decodes_committed_gcn_tpu_checkpoints(path):
    with open(os.path.join(REPO, path), "rb") as f:
        data = f.read()
    mine = flax_msgpack.from_bytes(data)
    _same_tree(mine, serialization.msgpack_restore(data))
    assert flax_msgpack.to_bytes(mine) == data


OBJECTS = {
    "ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63,
             -1, -32, -33, -128, -129, -2**15 - 1, -2**31 - 1, -2**63],
    "floats_nil_bool": [1.5, -0.0, 1e300, None, True, False],
    "str": ["a" * 31, "b" * 32, "c" * 300, "d" * 70000, "é"],
    "bin": [b"", b"x" * 300, b"y" * 70000],
    "arrays": [[1] * 15, [2] * 16, list(range(70000))],
    "maps": {"small": {str(i): i for i in range(15)},
             "large": {str(i): [i] for i in range(17)}, "empty": {}},
}


@pytest.mark.parametrize("name", sorted(OBJECTS))
def test_codec_packs_as_msgpack(name):
    obj = OBJECTS[name]
    want = msgpack.packb(obj, use_bin_type=True)
    assert flax_msgpack.packb(obj) == want
    assert flax_msgpack.unpackb(want) == msgpack.unpackb(
        want, raw=False, strict_map_key=False)


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int64",
                                   "uint8", "bool"])
def test_codec_tree_bytes_match_flax(dtype):
    rng = np.random.RandomState(0)
    a = (rng.randn(3, 5) * 50).astype(dtype)
    tree = {"b": {"x": a, "scalar": np.asarray(a.flat[0])},
            "a": np.zeros((0, 4), dtype), "empty": {},
            "wide": np.ones((2, 70000), dtype), "np_scalar": a.flat[1]}
    data = flax_msgpack.to_bytes(tree)
    assert data == serialization.to_bytes(tree)
    back = flax_msgpack.from_bytes(data)
    flax_back = serialization.msgpack_restore(data)
    assert type(back["np_scalar"]) is type(flax_back["np_scalar"])
    assert back["np_scalar"] == flax_back["np_scalar"]
    del back["np_scalar"], flax_back["np_scalar"]
    _same_tree(back, flax_back)


@pytest.mark.parametrize("data", [b"\x81\xa1a", b"\x01\x02", b"\xc1",
                                  b"\xd4\x05\x00"])
def test_codec_refuses_what_it_cannot_read(data):
    """Truncated, trailing bytes, a reserved type byte, an unknown ext."""
    with pytest.raises(ValueError):
        flax_msgpack.unpackb(data)


def _leaves(tree, path=""):
    """(path, numpy leaf) in the tree's own key order; an empty map is a
    leaf of its own."""
    if isinstance(tree, dict):
        if not tree:
            return [(path + "/{}", np.zeros(0))]
        return [leaf for k, v in tree.items()
                for leaf in _leaves(v, f"{path}/{k}")]
    return [(path, np.asarray(tree))]


def _grads(rng, params):
    return {k: (rng.randn(*p.shape) * 3).astype(np.float32)
            for k, p in params.items()}


@pytest.mark.parametrize("name", CORES)
def test_optimizer_state_crosses_both_ways(name):
    """The port's tree is optax's, key for key and dtype for dtype; each
    side resumes the other's state and 3 more steps on the same gradients
    agree within 1e-6 relative."""
    rng = np.random.RandomState(len(name))
    flat = {"word_emb": rng.randn(10, 4), "rnn.w": rng.randn(3, 5),
            "b": rng.randn(7)}
    flat = {k: v.astype(np.float32) for k, v in flat.items()}
    tx = jax_build_optimizer(name, 0.3, max_grad_norm=1.0, topn=6,
                             lr_decay=0.1)
    jparams = params_to_jax({k: torch.from_numpy(v) for k, v in
                             flat.items()})
    state = tx.init(jparams)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in flat.items()}
    opt = build_optimizer(name, 0.3, max_grad_norm=1.0, topn=6, lr_decay=0.1)
    opt.init(tparams)

    def step_both(grads):
        nonlocal state, jparams
        updates, state = tx.update(params_to_jax(
            {k: torch.from_numpy(g) for k, g in grads.items()}), state,
            jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step(tparams, {k: torch.from_numpy(g) for k, g in grads.items()})

    def close(port_opt, port_params, jax_state, jax_params):
        want = _leaves(serialization.to_state_dict(jax_state))
        got = _leaves(port_opt.state_tree())
        assert [p for p, _ in got] == [p for p, _ in want]  # optax's order
        for (path, g), (_, w) in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, path
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7,
                                       err_msg=path)
        for k, v in params_from_jax(jax.device_get(jax_params)).items():
            np.testing.assert_allclose(port_params[k].numpy(), v.numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=k)

    for _ in range(2):
        step_both(_grads(rng, flat))
    close(opt, tparams, state, jparams)
    # optax → port: load gcn_tpu's bytes into a fresh port optimizer
    port = build_optimizer(name, 0.9, max_grad_norm=1.0, topn=6,
                           lr_decay=0.1)
    port.init(tparams)
    port.load_state_tree(flax_msgpack.from_bytes(
        serialization.to_bytes(state)), tparams)
    assert port.count == 2 and port.learning_rate == pytest.approx(0.3)
    # port → optax: flax reads the port's bytes into its template
    jstate = serialization.from_bytes(tx.init(jparams), flax_msgpack.to_bytes(
        opt.state_tree()))
    p2 = {k: v.clone() for k, v in tparams.items()}
    jp2 = jparams
    for _ in range(3):
        grads = _grads(rng, flat)
        port.step(p2, {k: torch.from_numpy(g) for k, g in grads.items()})
        updates, jstate = tx.update(params_to_jax(
            {k: torch.from_numpy(g) for k, g in grads.items()}), jstate,
            jp2)
        jp2 = optax.apply_updates(jp2, updates)
        step_both(grads)
    close(port, p2, state, jparams)
    close(opt, tparams, jstate, jp2)


@pytest.mark.parametrize("name", CORES)
def test_trainers_resume_each_others_checkpoints(name, tmp_path):
    jcfg, tcfg = _configs(**NO_DROPOUT, **{
        "model.rnn_impl": "auto", "model.deprel_factored": "auto",
        "train.effective_batch_size": 8, "train.optim": name})
    jb, tb = _train_batchers(jcfg, tcfg, seed=3, length_buckets=[48])
    pairs = list(zip(jb, tb))[:4]
    jt = JaxTrainer(jcfg)
    init = params_from_jax(jax.device_get(jt.params))
    # gcn_tpu runs 2 steps, saves, runs 2 more; the port resumes its save
    for a, _ in pairs[:2]:
        jt.update(a)
    jt.save(str(tmp_path / "jax"), epoch=1)
    for a, _ in pairs[2:]:
        jt.update(a)
    port = Trainer(tcfg, device="cpu")
    meta = port.load(str(tmp_path / "jax"))
    assert port.global_step == meta["global_step"] == 2
    for _, b in pairs[2:]:
        port.update(b)
    _params_close(port, jt.params)
    # the port runs the same 4 steps from gcn_tpu's start; gcn_tpu resumes
    # the port's save after 2 (flax reads it into its own templates)
    port = Trainer(tcfg, init, device="cpu")
    for _, b in pairs[:2]:
        port.update(b)
    port.save(str(tmp_path / "port"), epoch=1)
    for _, b in pairs[2:]:
        port.update(b)
    jt.load(str(tmp_path / "port"))
    assert jt.global_step == 2
    for a, _ in pairs[2:]:
        jt.update(a)
    _params_close(port, jt.params)


def test_trainer_checkpoint_round_trips(tmp_path, monkeypatch):
    """The same bits back, async or not; meta as gcn_tpu writes it; a save
    with a gradient pending counts only the applied batches; async saves
    back to back land in order, and one wait waits for all of them."""
    _, tcfg = _configs(**{"train.optim": "adam",
                          "train.effective_batch_size": 16,
                          "train.async_save": True})
    batches = list(Batcher(RelationDataset(TRAIN, tcfg, Vocab.load(VOCAB)),
                           8, seed=1))
    tt = Trainer(tcfg, device="cpu")
    for b in batches[:3]:  # update_gap 2: one step applied, one pending
        tt.update(b)
    assert tt.pending_batches == 1
    tt.save(str(tmp_path / "c"), epoch=2, extra_meta={"best_metrics": {}})
    ckpt.wait_for_async_saves()
    blob = json.load(open(tmp_path / "c" / "meta.json"))
    assert blob["meta"] == {"epoch": 2, "global_step": 2,
                            "current_lr": tcfg.train.lr, "best_metrics": {}}
    assert blob["config"] == json.loads(json.dumps(tcfg.to_dict()))
    assert ckpt.load_checkpoint_config(str(tmp_path / "c")) == blob["config"]
    back = Trainer(tcfg, rng_seed=99, device="cpu")
    back.update_lr(0.01)
    back.load(str(tmp_path / "c"))
    tt._accum, tt._accum_count = None, 0  # drop the pending gradient
    for k, v in tt.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[k], v), k
    for k, st in tt.opt.state.items():
        for key, v in st.items():
            assert torch.equal(back.opt.state[k][key], v), (k, key)
    assert (back.opt.count, back.current_lr, back.global_step) == (
        tt.opt.count, tcfg.train.lr, 2)
    # a second save over the first replaces it whole; a stale .tmp goes
    os.makedirs(tmp_path / "c.tmp" / "junk")
    back.save(str(tmp_path / "c"), epoch=3)
    ckpt.wait_for_async_saves()
    assert sorted(os.listdir(tmp_path)) == ["c"]
    assert json.load(open(tmp_path / "c" / "meta.json"))["meta"]["epoch"] == 3
    # three async saves back to back, as the driver saves best_model and
    # then the epoch checkpoint; the first thread is scheduled late, yet
    # one wait waits for all three, and "e" ends as the last save left it
    late = []

    class LateFirst(threading.Thread):
        def run(self):
            if not late:
                late.append(self)
                time.sleep(0.5)
            super().run()

    monkeypatch.setattr(ckpt, "threading",
                        types.SimpleNamespace(Thread=LateFirst))
    for name, epoch in (("d", 4), ("e", 5), ("e", 6)):
        back.save(str(tmp_path / name), epoch=epoch)
    ckpt.wait_for_async_saves()
    assert sorted(os.listdir(tmp_path)) == ["c", "d", "e"]
    for name, epoch in (("d", 4), ("e", 6)):
        assert sorted(os.listdir(tmp_path / name)) == [
            "meta.json", "opt_state.msgpack", "params.msgpack"]
        assert json.load(open(tmp_path / name / "meta.json"))[
            "meta"]["epoch"] == epoch
