"""``compute_dtype="bfloat16"`` in the port against the JAX package's bf16,
on the CPU (the Pallas kernels in interpret mode, as gcn_tpu's tests run
them).

The yardstick is the gap that bf16 itself costs: each case runs both
packages in f32 and in bf16 on the same inputs and parameters.  The port's
bf16 result must lie within twice JAX's own bf16-to-f32 gap of JAX's bf16
result, and the port's bf16-to-f32 gap must be at most twice JAX's.  Both
gaps are printed.  (At these widths JAX's gap on the logits is about 1e-3
of logits near 0.35.)

* per module that holds a kernel: the scan, the grouped matmul, the band
  aggregation and its pair, the fused GCN layer and its sym pair, the
  SDDMM (kernels 9-10) and the deprel bilinear v2 and v1 with its bias
  (kernels 11-12; their plain versions, which the CPU runs), forward and
  gradients;
* the whole forward at ``SMALL`` widths on the dense, fused full_deprel,
  fused regular, diagonal, attention edge and fused non-factored paths
  (and the dense regular, dense attention and non-factored ones), and one
  train step's gradients;
* the bf16 forward runs in bf16: every kernel's plain version receives
  bf16 operands (a port that ignored the dtype would pass the gap tests);
* a bf16 run's checkpoint (f32 parameters, ``compute_dtype`` in its
  config) loads in gcn_tpu's ``load_checkpoint`` and back.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_tpu import config as jax_config
from gcn_tpu.config import Config as JaxConfig
from gcn_tpu.models.gcn import GCNClassifier as JaxGCN
from gcn_tpu.ops.pallas.band_aggregate import \
    fused_band_aggregate as jax_fused_band_aggregate
from gcn_tpu.ops.pallas.band_aggregate import \
    pair_aggregate as jax_pair_aggregate
from gcn_tpu.ops.pallas import deprel_bilinear as jax_bilinear
from gcn_tpu.ops.pallas.sddmm import sddmm as jax_sddmm
from gcn_tpu.ops.pallas.grouped_matmul import grouped_matmul as jax_gmm
from gcn_tpu.ops.pallas.lstm_scan import lstm_scan_stacked
from gcn_tpu.ops.pallas.spmm_fused import _sym_pair
from gcn_tpu.ops.pallas.spmm_fused import \
    fused_gcn_spmm as jax_fused_gcn_spmm
from gcn_tpu.train import checkpoint as jax_ckpt
from gcn_tpu.train.trainer import Trainer as JaxTrainer
from gcn_tpu_torch import config
from gcn_tpu_torch.convert import params_from_jax
from gcn_tpu_torch.data.dataset import Batcher, RelationDataset
from gcn_tpu_torch.data.vocab import Vocab
from gcn_tpu_torch.models.gcn import GCNClassifier
from gcn_tpu_torch.ops import band_aggregate as band_mod
from gcn_tpu_torch.ops import deprel_bilinear as bilinear_mod
from gcn_tpu_torch.ops import grouped_matmul as gmm_mod
from gcn_tpu_torch.ops import lstm_scan as lstm_mod
from gcn_tpu_torch.ops import sddmm as sddmm_mod
from gcn_tpu_torch.ops import spmm_fused as spmm_mod
from gcn_tpu_torch.train.checkpoint import load_checkpoint
from gcn_tpu_torch.train.evaluator import batch_to_device
from gcn_tpu_torch.train.trainer import Trainer
from tests.test_torch_port_cuda import (  # noqa: F401
    edge_case,
    gmm_case,
    lstm_inputs,
    one_torch_thread,
)
from tests.test_torch_port_model import DATA, SMALL, VOCAB

NO_DROPOUT = {"model.input_dropout": 0.0, "model.rnn_dropout": 0.0,
              "model.gcn_dropout": 0.0}
EDGE_CASES_BF16 = ["random", "duplicates", "isolated"]
B, N, E, H = 3, 10, 10, 16


def f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32)) if not isinstance(
        a, torch.Tensor) else a.detach().float().numpy()


def gap_check(what, port16, port32, jax16, jax32):
    """The port's bf16 within twice JAX's bf16-to-f32 gap of JAX's bf16,
    and its own gap at most twice JAX's; each argument one array or a
    list of them (the largest gap and error over the list)."""
    as_list = (lambda x: list(x) if isinstance(x, (list, tuple)) else [x])
    p16, p32, j16, j32 = (list(map(f32, as_list(x)))
                          for x in (port16, port32, jax16, jax32))
    jax_gap = max(float(np.abs(a - b).max()) for a, b in zip(j16, j32))
    port_gap = max(float(np.abs(a - b).max()) for a, b in zip(p16, p32))
    err = max(float(np.abs(a - b).max()) for a, b in zip(p16, j16))
    print(f"{what}: JAX bf16-f32 gap {jax_gap:.3g}, port gap "
          f"{port_gap:.3g}, port bf16 - JAX bf16 {err:.3g}")
    assert jax_gap > 0, what
    assert err <= 2 * jax_gap, (what, err, jax_gap)
    assert port_gap <= 2 * jax_gap, (what, port_gap, jax_gap)


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


# ------------------------------------------------------------ per module
def test_scan_matches_jax_in_bf16():
    xp, lengths, w_hh, _ = lstm_inputs(np.random.RandomState(0))
    out = {}
    for name, jdt, tdt in (("32", jnp.float32, torch.float32),
                           ("16", jnp.bfloat16, torch.bfloat16)):
        out["j" + name] = lstm_scan_stacked(
            jnp.asarray(xp, jdt), jnp.asarray(lengths),
            jnp.asarray(w_hh, jdt), interpret=True)
        h, _ = lstm_mod.lstm_scan_plain(t(xp, tdt), t(lengths), t(w_hh, tdt))
        assert h.dtype == tdt
        out["p" + name] = h
    gap_check("scan forward", out["p16"], out["p32"], out["j16"], out["j32"])


def test_scan_gradients_match_jax_in_bf16():
    rng = np.random.RandomState(1)
    xp, lengths, w_hh, _ = lstm_inputs(rng)
    ct = rng.randn(*xp.shape[:3], w_hh.shape[1]).astype(np.float32)
    out = {}
    for name, jdt, tdt in (("32", jnp.float32, torch.float32),
                           ("16", jnp.bfloat16, torch.bfloat16)):
        _, vjp = jax.vjp(lambda a, b: lstm_scan_stacked(
            a, jnp.asarray(lengths), b, interpret=True),
            jnp.asarray(xp, jdt), jnp.asarray(w_hh, jdt))
        out["j" + name] = vjp(jnp.asarray(ct, jdt))
        x_t, w_t = (t(xp, tdt).requires_grad_(),
                    t(w_hh, tdt).requires_grad_())
        h = lstm_mod.lstm_scan(x_t, t(lengths), w_t, use_kernel=True)
        out["p" + name] = torch.autograd.grad(h, [x_t, w_t], t(ct, tdt))
    gap_check("scan gradients", out["p16"], out["p32"], out["j16"],
              out["j32"])


@pytest.mark.parametrize("case", ["random", "straddle_tile"])
def test_grouped_matmul_matches_jax_in_bf16(case):
    x, s, gs = gmm_case(case)
    g = np.random.RandomState(7).randn(x.shape[0], s.shape[2]).astype(
        np.float32)
    out = {}
    for name, jdt, tdt in (("32", jnp.float32, torch.float32),
                           ("16", jnp.bfloat16, torch.bfloat16)):
        y, vjp = jax.vjp(lambda a, b: jax_gmm(a, b, jnp.asarray(gs),
                                              interpret=True),
                         jnp.asarray(x, jdt), jnp.asarray(s, jdt))
        out["j" + name] = [y, *vjp(jnp.asarray(g, jdt))]
        x_t, s_t = t(x, tdt).requires_grad_(), t(s, tdt).requires_grad_()
        yt = gmm_mod.grouped_matmul_fn(x_t, s_t, t(gs))
        assert yt.dtype == tdt
        out["p" + name] = [yt, *torch.autograd.grad(yt, [x_t, s_t],
                                                    t(g, tdt))]
    gap_check("grouped matmul forward, dx, dS", out["p16"], out["p32"],
              out["j16"], out["j32"])


def band_inputs(case):
    parent, child, mask = edge_case(case, B, N, E)
    rng = np.random.RandomState(len(case))
    xs = [rng.randn(B, N, H).astype(np.float32) for _ in range(3)]
    g = rng.randn(B, N, H).astype(np.float32)
    return (parent, child, mask), xs, g


@pytest.mark.parametrize("case", EDGE_CASES_BF16)
def test_band_aggregate_and_pair_match_jax_in_bf16(case):
    edges, xs, g = band_inputs(case)
    tedges = [torch.from_numpy(a) for a in edges]
    out = {}
    for name, jdt, tdt in (("32", jnp.float32, torch.float32),
                           ("16", jnp.bfloat16, torch.bfloat16)):
        jx = [jnp.asarray(x, jdt) for x in xs]
        y, vjp = jax.vjp(lambda a, b, c: jax_fused_band_aggregate(
            *edges, a, b, c), *jx)
        pair = jax_pair_aggregate(*edges, jx[0], interpret=True)
        out["j" + name] = [y, *vjp(jnp.asarray(g, jdt)), *pair]
        tx = [t(x, tdt).requires_grad_() for x in xs]
        yt = band_mod.fused_band_aggregate(*tedges, *tx)
        grads = torch.autograd.grad(yt, tx, t(g, tdt))
        pt = band_mod.pair_aggregate(*tedges, t(xs[0], tdt))
        assert yt.dtype == pt[0].dtype == grads[0].dtype == tdt
        out["p" + name] = [yt, *grads, *pt]
    gap_check(f"band aggregation, its gradients and pair ({case})",
              out["p16"], out["p32"], out["j16"], out["j32"])


@pytest.mark.parametrize("case", EDGE_CASES_BF16)
def test_fused_gcn_layer_and_sym_pair_match_jax_in_bf16(case):
    edges, _, _ = band_inputs(case)
    tedges = [torch.from_numpy(a) for a in edges]
    rng = np.random.RandomState(len(case) + 1)
    h = rng.randn(B, N, 12).astype(np.float32)
    w = (rng.randn(12, H) / np.sqrt(12)).astype(np.float32)
    b = (rng.randn(H) * 0.1).astype(np.float32)
    x2 = rng.randn(B, N, 7).astype(np.float32)
    g = rng.randn(B, N, H).astype(np.float32)
    out = {}
    for name, jdt, tdt in (("32", jnp.float32, torch.float32),
                           ("16", jnp.bfloat16, torch.bfloat16)):
        jin = [jnp.asarray(a, jdt) for a in (h, w, b)]
        y, vjp = jax.vjp(lambda a, c, d: jax_fused_gcn_spmm(
            *edges, a, c, d), *jin)
        pair = _sym_pair(*edges, jin[0], jnp.asarray(x2, jdt),
                         interpret=True)
        out["j" + name] = [y, *vjp(jnp.asarray(g, jdt)), *pair]
        tin = [t(a, tdt).requires_grad_() for a in (h, w, b)]
        yt = spmm_mod.fused_gcn_spmm(*tedges, *tin)
        grads = torch.autograd.grad(yt, tin, t(g, tdt))
        pt = spmm_mod.sym_pair(*tedges, t(h, tdt), t(x2, tdt))
        assert {yt.dtype, pt[0].dtype, pt[1].dtype,
                *(a.dtype for a in grads)} == {tdt}
        out["p" + name] = [yt, *grads, *pt]
    gap_check(f"fused GCN layer, its gradients and sym pair ({case})",
              out["p16"], out["p32"], out["j16"], out["j32"])


@pytest.mark.parametrize("case", EDGE_CASES_BF16)
def test_sddmm_and_its_gradients_match_jax_in_bf16(case):
    """Kernels 9-10's plain versions against gcn_tpu's ``sddmm`` (Pallas in
    interpret mode): the f32 scores, and du, dv in the operands' dtype
    for an f32 cotangent."""
    edges, xs, _ = band_inputs(case)
    tedges = [torch.from_numpy(a) for a in edges]
    u, v = xs[0] / 4, xs[1] / 4
    g = np.random.RandomState(len(case) + 2).randn(B, E).astype(np.float32)
    out = {}
    for name, jdt, tdt in (("32", jnp.float32, torch.float32),
                           ("16", jnp.bfloat16, torch.bfloat16)):
        s, vjp = jax.vjp(lambda a, c: jax_sddmm(*edges, a, c),
                         jnp.asarray(u, jdt), jnp.asarray(v, jdt))
        out["j" + name] = [s, *vjp(jnp.asarray(g))]
        tu, tv = t(u, tdt).requires_grad_(), t(v, tdt).requires_grad_()
        st = sddmm_mod.sddmm(*tedges, tu, tv)
        grads = torch.autograd.grad(st, [tu, tv], t(g))
        assert st.dtype == torch.float32
        assert grads[0].dtype == grads[1].dtype == tdt
        out["p" + name] = [st, *grads]
    gap_check(f"sddmm scores and du, dv ({case})", out["p16"], out["p32"],
              out["j16"], out["j32"])


BM, BT, BD, BH = 70, 24, 5, 16  # 70 rows: a partial tile of 32 in JAX


@pytest.mark.parametrize("version", ["v2", "v1"])
def test_bilinear_and_its_gradients_match_jax_in_bf16(version):
    """Kernels 11-12's plain versions, with the bias, against gcn_tpu's
    ``deprel_bilinear_v2`` and ``deprel_bilinear`` (Pallas in interpret
    mode): the output in x's dtype and (dx, de, dW).  JAX's v1 rounds its
    bf16 output at every d, the port's once; JAX's backward carries dx in
    bf16 across its d steps, the port's rounds each product once."""
    rng = np.random.RandomState(3)
    x = rng.randn(BM, BT).astype(np.float32)
    e = rng.randn(BM, BD).astype(np.float32)
    w = (rng.randn(BD, BT, BH) / np.sqrt(BT)).astype(np.float32)
    b = (rng.randn(BD, BH) * 0.1).astype(np.float32)
    r = rng.randn(BM, BH).astype(np.float32)
    jax_fn = {"v2": jax_bilinear.deprel_bilinear_v2,
              "v1": jax_bilinear.deprel_bilinear}[version]
    fn = {"v2": bilinear_mod.deprel_bilinear_v2,
          "v1": bilinear_mod.deprel_bilinear}[version]
    out = {}
    for name, jdt, tdt in (("32", jnp.float32, torch.float32),
                           ("16", jnp.bfloat16, torch.bfloat16)):
        jb = jnp.asarray(b, jdt)
        y, vjp = jax.vjp(lambda *a: jax_fn(*a, b=jb, tile_m=32),
                         *(jnp.asarray(a, jdt) for a in (x, e, w)))
        out["j" + name] = [y, *vjp(jnp.asarray(r, jdt))]
        args = [t(a, tdt).requires_grad_() for a in (x, e, w)]
        yt = fn(*args, t(b, tdt))
        grads = torch.autograd.grad(yt, args, t(r, tdt))
        assert {yt.dtype, *(a.dtype for a in grads)} == {tdt}
        out["p" + name] = [yt, *grads]
    gap_check(f"bilinear {version} with bias, dx, de, dW", out["p16"],
              out["p32"], out["j16"], out["j32"])


# ---------------------------------------------------------- whole model
PATHS = {
    "cgcn": ("cgcn_preset", {}),
    "cgcn_fused": ("cgcn_preset", {"model.use_pallas": True}),
    "gcn_fused": ("gcn_preset", {"model.use_pallas": True}),
    "cdiag_fused": ("cgcn_preset", {"model.adj_type": "diagonal_deprel",
                                    "model.use_pallas": True}),
    "gcn": ("gcn_preset", {}),
    "cdiag": ("cgcn_preset", {"model.adj_type": "diagonal_deprel"}),
    "cgcn_attn_dense": ("cgcn_preset", {"model.adj_type": "attention",
                                        "model.attention_impl": "dense"}),
    "cgcn_einsum": ("cgcn_preset", {"model.deprel_factored": False}),
    "cgcn_attn": ("cgcn_preset", {"model.adj_type": "attention",
                                  "model.attention_impl": "edge"}),
    "cgcn_bilinear": ("cgcn_preset", {"model.deprel_factored": False,
                                      "model.use_pallas": True}),
}


def configs(path, dtype, **extra):
    preset, ov = PATHS[path]
    ov = {**SMALL, **ov, **extra, "model.compute_dtype": dtype}
    if ov.get("model.deprel_factored") is False:
        ov["model.deprel_factored"] = False
    jcfg = getattr(jax_config, preset)(**ov)
    tcfg = getattr(config, preset)(**ov)
    jcfg.model.vocab_size = tcfg.model.vocab_size = Vocab.load(VOCAB).size
    return jcfg, tcfg


def batches(jcfg, tcfg, split="test", evaluation=True):
    from gcn_tpu.data.dataset import Batcher as JaxBatcher
    from gcn_tpu.data.dataset import RelationDataset as JaxDataset
    from gcn_tpu.data.vocab import Vocab as JaxVocab

    path = os.path.join(DATA, f"{split}.json")
    jds = JaxDataset(path, jcfg, JaxVocab.load(VOCAB), evaluation=evaluation)
    tds = RelationDataset(path, tcfg, Vocab.load(VOCAB),
                          evaluation=evaluation)
    return (next(iter(JaxBatcher(jds, 8, evaluation=True))),
            next(iter(Batcher(tds, 8, evaluation=True))))


@pytest.mark.parametrize("path", sorted(PATHS))
def test_forward_matches_jax_in_bf16(path):
    out, params = {}, None
    for name, dtype in (("32", "float32"), ("16", "bfloat16")):
        jcfg, tcfg = configs(path, dtype)
        jbatch, tbatch = batches(jcfg, tcfg)
        model = JaxGCN(jcfg.model)
        if params is None:
            params = model.init({"params": jax.random.key(0),
                                 "dropout": jax.random.key(1)}, jbatch, True)
        out["j" + name] = jax.jit(lambda p, b: model.apply(p, b, True))(
            params, jbatch)
        port = GCNClassifier(tcfg.model)
        port.load_state_dict(params_from_jax(jax.device_get(params)))
        with torch.no_grad():
            logits, h_out = port(batch_to_device(tbatch, torch.device("cpu")))
        assert logits.dtype == h_out.dtype == torch.float32
        out["p" + name] = [logits, h_out]
    gap_check(f"{path} logits and h_out", out["p16"], out["p32"],
              list(out["j16"]), list(out["j32"]))


@pytest.mark.parametrize("path", ["cgcn", "cgcn_fused", "gcn_fused",
                                  "cgcn_attn", "cgcn_bilinear"])
def test_train_step_gradients_match_jax_in_bf16(path):
    """jax.value_and_grad of gcn_tpu's Trainer._loss (dropout off) against
    the port's, in f32 and bf16: every parameter's gradient (f32 in both
    dtypes), each over its f32 max |grad|."""
    out = {}
    for name, dtype in (("32", "float32"), ("16", "bfloat16")):
        jcfg, tcfg = configs(path, dtype, **NO_DROPOUT)
        jbatch, tbatch = batches(jcfg, tcfg, "train")
        jt = JaxTrainer(jcfg)
        if name == "32":
            init = jt.params
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jt._loss(p, jbatch, jt._key, 0)))(init)
        grads = params_from_jax(jax.device_get(grads))
        tt = Trainer(tcfg, params_from_jax(jax.device_get(init)),
                     device="cpu")
        tl, tg = tt._grads(batch_to_device(tbatch, tt.device),
                           tt.step_generator(0))
        assert all(g.dtype == torch.float32 for g in tg.values())
        out["j" + name] = (float(loss), grads)
        out["p" + name] = (float(tl), tg)
    names = sorted(out["j32"][1])
    scale = {k: max(float(out["j32"][1][k].abs().max()), 1e-30)
             for k in names}

    def scaled(which):
        return [np.array([out[which][0]])] + [
            out[which][1][k].numpy() / scale[k] for k in names]

    gap_check(f"{path} loss and gradients (each over its max)",
              scaled("p16"), scaled("p32"), scaled("j16"), scaled("j32"))


# ----------------------------------------------------- runs in bf16 only
PLAIN_VERSIONS = [(lstm_mod, "lstm_scan_plain"),
                  (lstm_mod, "lstm_scan_backward_plain"),
                  (gmm_mod, "grouped_matmul_plain"),
                  (gmm_mod, "grouped_matmul_backward_plain"),
                  (band_mod, "band_aggregate_plain"),
                  (band_mod, "pair_aggregate_plain"),
                  (spmm_mod, "gcn_spmm_plain"),
                  (spmm_mod, "sym_pair_plain"),
                  (sddmm_mod, "sddmm_plain"),
                  (sddmm_mod, "sddmm_backward_plain"),
                  (bilinear_mod, "bilinear_v2_plain")]


@pytest.mark.parametrize("path", ["cgcn", "cgcn_fused", "gcn_fused",
                                  "cdiag_fused", "cgcn_attn",
                                  "cgcn_bilinear"])
def test_bf16_step_runs_the_plain_versions_in_bf16(path, monkeypatch):
    """A train step (forward and backward) on the CPU: each kernel's plain
    version receives bf16 operands only (the cotangents of the scan
    backward and of the SDDMM backward excepted: they are f32, as JAX's
    kernels take them)."""
    seen: dict = {}

    def spy(mod, fname):
        real = getattr(mod, fname)

        def wrapper(*args, **kw):
            skip = {"lstm_scan_backward_plain": 1,
                    "sddmm_backward_plain": 4}.get(fname, 0)
            seen.setdefault(fname, set()).update(
                a.dtype for i, a in enumerate(args)
                if i != skip - 1 or not skip
                if isinstance(a, torch.Tensor) and a.is_floating_point())
            return real(*args, **kw)

        monkeypatch.setattr(mod, fname, wrapper)
        if fname.startswith("bilinear_"):  # reached through its table
            monkeypatch.setitem(mod._PLAIN, fname.split("_")[1], wrapper)

    for mod, fname in PLAIN_VERSIONS:
        spy(mod, fname)
    _, tcfg = configs(path, "bfloat16")
    _, tbatch = batches(*configs(path, "bfloat16"), "train")
    Trainer(tcfg, device="cpu").update(tbatch)
    want = {"cgcn": {"lstm_scan_plain", "lstm_scan_backward_plain",
                     "grouped_matmul_plain", "grouped_matmul_backward_plain"},
            "gcn_fused": {"gcn_spmm_plain", "sym_pair_plain"},
            "cdiag_fused": {"lstm_scan_plain", "lstm_scan_backward_plain",
                            "band_aggregate_plain", "pair_aggregate_plain"}}
    want["cgcn_fused"] = want["cgcn"] | {"band_aggregate_plain",
                                         "pair_aggregate_plain"}
    scan = {"lstm_scan_plain", "lstm_scan_backward_plain"}
    want["cgcn_attn"] = scan | {"sddmm_plain", "sddmm_backward_plain"}
    want["cgcn_bilinear"] = scan | {"bilinear_v2_plain",
                                    "band_aggregate_plain",
                                    "pair_aggregate_plain"}
    assert set(seen) == want[path]
    assert all(d == {torch.bfloat16} for d in seen.values()), seen


# ------------------------------------------------- attention_impl auto
def test_bf16_auto_attention_takes_the_edge_kernels_in_bf16(monkeypatch):
    """Every combination builds in bf16, and attention_impl="auto" takes
    the edge backend where the [B, N, N] score buffer passes JAX's budget
    (here a budget of 0): its forward reaches the SDDMM's plain version
    with bf16 operands and gives JAX's bf16 logits within the gap rule's
    bound, measured on the same batch through the explicit edge backend."""
    from gcn_tpu_torch.models import gcn as gcn_mod

    for ov in ({"model.adj_type": "attention"},
               {"model.adj_type": "attention",
                "model.attention_impl": "edge"},
               {"model.deprel_factored": False, "model.use_pallas": True}):
        GCNClassifier(configs("cgcn", "bfloat16", **ov)[1].model)
    jcfg, tcfg = configs("cgcn_attn", "bfloat16")
    _, auto_cfg = configs("cgcn", "bfloat16",
                          **{"model.adj_type": "attention"})
    jbatch, tbatch = batches(jcfg, tcfg)
    jax_model = JaxGCN(jcfg.model)
    params = jax_model.init({"params": jax.random.key(0),
                             "dropout": jax.random.key(1)}, jbatch, True)
    state = params_from_jax(jax.device_get(params))
    edge, auto = GCNClassifier(tcfg.model), GCNClassifier(auto_cfg.model)
    edge.load_state_dict(state)
    auto.load_state_dict(state)
    seen = []
    real = sddmm_mod.sddmm_plain

    def spy(*args):
        seen.append(args[3].dtype)
        return real(*args)

    monkeypatch.setattr(sddmm_mod, "sddmm_plain", spy)
    monkeypatch.setattr(gcn_mod, "ATTN_DENSE_BYTE_BUDGET", 0)
    with torch.no_grad():
        got, _ = auto(batch_to_device(tbatch, torch.device("cpu")))
        want, _ = edge(batch_to_device(tbatch, torch.device("cpu")))
    assert seen and set(seen) == {torch.bfloat16}
    assert torch.equal(got, want)


# ---------------------------------------------------------- checkpoints
def test_bf16_checkpoint_crosses_to_gcn_tpu_and_back(tmp_path):
    """A bf16 run's checkpoint holds f32 parameters and its config's
    compute_dtype: gcn_tpu's load_checkpoint reads it into its trainer's
    templates, gcn_tpu saves it again, and the port reads that back, the
    same bits; the config round-trips between the packages."""
    jcfg, tcfg = configs("cgcn", "bfloat16")
    _, tbatch = batches(jcfg, tcfg, "train")
    port = Trainer(tcfg, device="cpu")
    port.update(tbatch)
    port.save(str(tmp_path / "port"), epoch=1)
    jt = JaxTrainer(jcfg)
    params, _, blob = jax_ckpt.load_checkpoint(str(tmp_path / "port"),
                                               jt.params)
    assert blob["config"]["model"]["compute_dtype"] == "bfloat16"
    assert JaxConfig.from_dict(blob["config"]).model == jcfg.model
    leaves = jax.tree.leaves(params)
    assert leaves and all(a.dtype == np.float32 for a in leaves)
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), params,
                             config=jcfg.to_dict(), meta={"epoch": 1})
    back, _, jblob = load_checkpoint(str(tmp_path / "jax"),
                                     load_opt_state=False)
    assert config.Config.from_dict(jblob["config"]).model == tcfg.model
    got = params_from_jax(back)
    for k, v in port.model.state_dict().items():
        assert torch.equal(got[k], v), k
    with open(tmp_path / "port" / "meta.json") as f:
        assert json.load(f)["config"]["model"]["compute_dtype"] == \
            "bfloat16"
