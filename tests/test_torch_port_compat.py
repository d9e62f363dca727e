"""The port's reference-checkpoint import and export against the JAX
package's (``gcn_tpu.compat``).

On the four goldens ``test_torch_export.py`` uses and on the two committed
reference checkpoints (``.campaign_r5/flagship/seed{11,17}/
reference_full_deprel_models/cmp/best_model.pt``, trained by the original
PyTorch C-GCN), the port's ``torch_state_to_params`` gives JAX's tree
array for array (``np.array_equal``), and its export gives the state back
exactly.  Each checkpoint, carried into the port through
``convert.params_from_jax``, scores its seed's dev split with the port's
``Evaluator`` on the CPU at the dev F1 of its run (0.680328 and 0.664319,
the best dev of its ``logs.txt``: 68.03 and 66.43).
"""

import io
import json
import os

import numpy as np
import pytest
import torch

from gcn_tpu.compat.torch_export import (
    params_to_torch_state as jax_params_to_torch_state,
)
from gcn_tpu.compat.torch_import import (
    torch_state_to_params as jax_torch_state_to_params,
)
from gcn_tpu.config import ModelConfig as JaxModelConfig
from gcn_tpu_torch import config, constants
from gcn_tpu_torch.compat.torch_export import (
    params_to_torch_state,
    state_dict_to_torch_state,
)
from gcn_tpu_torch.compat.torch_import import torch_state_to_params
from gcn_tpu_torch.convert import params_from_jax
from gcn_tpu_torch.data.dataset import Batcher, RelationDataset
from gcn_tpu_torch.data.vocab import Vocab
from gcn_tpu_torch.models.gcn import GCNClassifier
from gcn_tpu_torch.train import scorer
from gcn_tpu_torch.train.evaluator import Evaluator
from tests.conftest import load_golden
from tests.test_model_parity import golden_to_cfg
from tests.test_torch_port_cuda import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, ".campaign_r5", "flagship")
GOLDENS = ["regular_nornn", "regular_rnn", "diagonal_nornn", "full_rnn"]
# each reference run's best dev F1 (its logs.txt: 68.03 and 66.43), as the
# port scores its best_model.pt on the CPU
REFERENCE_DEV_F1 = {11: 0.680328, 17: 0.664319}


def port_model_cfg(jcfg: JaxModelConfig) -> config.ModelConfig:
    """The port's ModelConfig with every field of JAX's."""
    return config.ModelConfig(**{k: getattr(jcfg, k) for k in
                                 config.ModelConfig.__dataclass_fields__})


def assert_trees_equal(got, want, path="params"):
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


def golden_case(case):
    z = load_golden(f"model_{case}.npz")
    jcfg = golden_to_cfg(json.loads(bytes(z["opt"]).decode()))
    state = {k[len("state."):]: v for k, v in z.items()
             if k.startswith("state.")}
    return state, jcfg, port_model_cfg(jcfg)


@pytest.mark.parametrize("case", GOLDENS)
def test_import_and_export_match_jax(case):
    state, jcfg, cfg = golden_case(case)
    params = torch_state_to_params(state, cfg)
    assert_trees_equal(params, jax_torch_state_to_params(state, jcfg))
    back = params_to_torch_state(params, cfg)
    assert set(back) == set(state)
    want = jax_params_to_torch_state(params, jcfg)
    for key in state:
        assert np.array_equal(back[key], state[key]), key
        assert np.array_equal(back[key], want[key]), key


@pytest.mark.parametrize("case", GOLDENS)
def test_state_dict_export_round_trips(case):
    """Reference state → the port's model → reference state, exactly;
    imported tensors load into the port's model under its names."""
    state, _, cfg = golden_case(case)
    model = GCNClassifier(cfg)
    model.load_state_dict(params_from_jax(torch_state_to_params(state, cfg)))
    back = state_dict_to_torch_state(model.state_dict(), cfg)
    assert set(back) == set(state)
    for key in state:
        assert np.array_equal(back[key], state[key]), key
    # tensors in, as torch.load gives them
    tensors = {k: torch.from_numpy(v) for k, v in state.items()}
    assert_trees_equal(torch_state_to_params(tensors, cfg),
                       torch_state_to_params(state, cfg))


def test_refusals_match_jax():
    cases = [
        (dict(adj_type="attention"), {"params": {}}),
        (dict(adj_type="full_deprel", deprel_shared_w=False, rnn=False,
              pos_dim=0, ner_dim=0, use_bert_embeddings=True),
         {"params": {"deprel_emb": np.zeros((85, 4))}}),
    ]
    for fields, params in cases:
        with pytest.raises(ValueError) as want:
            jax_params_to_torch_state(params, JaxModelConfig(**fields))
        with pytest.raises(ValueError) as got:
            params_to_torch_state(params, config.ModelConfig(**fields))
        assert str(got.value) == str(want.value)


def test_per_layer_import_replicates_the_shared_weight():
    state, jcfg, _ = golden_case("full_rnn")
    jcfg.deprel_shared_w = False
    cfg = port_model_cfg(jcfg)
    params = torch_state_to_params(state, cfg)
    assert_trees_equal(params, jax_torch_state_to_params(state, jcfg))
    p = params["params"]
    for l in range(cfg.num_layers):
        assert np.array_equal(p[f"gcn_deprel_w{l}"], p["gcn_deprel_w0"])


def reference_run(seed):
    """(reference state as numpy, the run's config.json, its directory)."""
    run = os.path.join(FLAGSHIP, f"seed{seed}", "reference_full_deprel_models",
                       "cmp")
    ckpt = torch.load(os.path.join(run, "best_model.pt"), weights_only=True)
    with open(os.path.join(run, "config.json")) as f:
        opt = json.load(f)
    return {k: v.numpy() for k, v in ckpt["model"].items()}, opt, run


@pytest.mark.parametrize("seed", sorted(REFERENCE_DEV_F1))
def test_reference_checkpoint_trees_match_jax(seed):
    state, opt, _ = reference_run(seed)
    assert len(state) == 24
    jcfg = golden_to_cfg(opt)
    cfg = port_model_cfg(jcfg)
    params = torch_state_to_params(state, cfg)
    assert_trees_equal(params, jax_torch_state_to_params(state, jcfg))
    back = params_to_torch_state(params, cfg)
    for key in state:
        assert np.array_equal(back[key], state[key]), key


@pytest.mark.parametrize("seed", sorted(REFERENCE_DEV_F1))
def test_reference_checkpoint_scores_its_dev_f1(seed):
    state, opt, run = reference_run(seed)
    cfg = config.Config(model=port_model_cfg(golden_to_cfg(opt)))
    cfg.train.batch_size = 50
    params = torch_state_to_params(state, cfg.model)
    ev = Evaluator(cfg, params_from_jax(params), device="cpu")
    ds = RelationDataset(os.path.join(FLAGSHIP, f"seed{seed}", "data",
                                      "dev.json"), cfg,
                         Vocab.load(os.path.join(run, "vocab.pkl")),
                         evaluation=True)
    batcher = Batcher(ds, 50, evaluation=True)
    preds, _, loss = ev.evaluate(batcher)
    id2label = {v: k for k, v in constants.LABEL_TO_ID.items()}
    f1 = scorer.score(batcher.gold(), [id2label[p] for p in preds],
                      out=io.StringIO())[2]
    assert len(preds) == 1200 and np.isfinite(loss)
    assert round(f1, 6) == REFERENCE_DEV_F1[seed]
