"""The port's entry points against gcn_tpu's, on the CPU.

* The eval CLI reaches the dev F1 of gcn_tpu's committed seed-11 and
  seed-17 checkpoints (``.campaign_r5/flagship/``), 0.612559 and 0.717025,
  on copies of their run directories.
* Warm-started from one checkpoint with dropout off (word dropout on: both
  train batchers draw it from one numpy stream), the port's train CLI and
  gcn_tpu's ``run_training`` write ``logs.txt`` rows within 1e-4 relative
  and the same F1s; the root ``eval.py`` reads the port's run directory
  and scores its best model as the port's eval CLI does.
* A run resumed from a step checkpoint taken mid-accumulation, or from an
  epoch checkpoint, ends with the uninterrupted run's parameters, bit for
  bit, and the same ``logs.txt`` (one torch thread).
* The SemEval CLI selects on train F1 without a dev split;
  ``prepare_vocab`` writes gcn_tpu's files from a GloVe file the test
  writes; the parser has gcn_tpu's flags and defaults; unsupported flags
  raise (``--pack_sentences`` runs: ``test_torch_port_sentence_packing``;
  ``--sparse_emb_grad true`` runs, and with adam raises ``ValueError``),
  the JAX-only ones are stored and named, the dispatch flags act (chunked
  steps, warm-up), and no card without ``--cpu`` raises.
"""

import json
import os
import pickle
import re
import runpy
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from gcn_tpu.train import cli as jax_cli
from gcn_tpu.train.driver import run_training as jax_run_training
from gcn_tpu_torch.scripts import eval as eval_cli
from gcn_tpu_torch.scripts import prepare_vocab, train, train_semeval
from gcn_tpu_torch.train import cli
from gcn_tpu_torch.train import trainer as trainer_mod
from gcn_tpu_torch.train.checkpoint import load_checkpoint
from gcn_tpu_torch.train.driver import load_word_embeddings
from tests.test_torch_port_cuda import one_torch_thread  # noqa: F401
from tests.test_torch_port_model import REPO

FLAGSHIP = os.path.join(REPO, ".campaign_r5", "flagship")
SEED_DEV_F1 = {11: 0.612559, 17: 0.717025}
SMALL = ["--hidden_dim", "16", "--rnn_hidden", "8", "--deprel_emb_dim", "6",
         "--adj_type", "full_deprel", "--batch_size", "8",
         "--effective_batch_size", "8", "--data_dir",
         os.path.join(REPO, "dataset", "tacred"), "--vocab_dir",
         os.path.join(REPO, "dataset", "vocab"), "--log_step", "100"]
NO_DROPOUT = ["--input_dropout", "0", "--gcn_dropout", "0", "--rnn_dropout",
              "0", "--deprel_dropout", "0"]


def logs_rows(run_dir):
    """(epoch rows as float lists, 'new best' lines) of a ``logs.txt``."""
    with open(os.path.join(run_dir, "logs.txt")) as f:
        lines = f.read().strip().splitlines()
    assert lines[0].startswith("# epoch")
    rows = [[float(x) for x in ln.split("\t")] for ln in lines[1:]
            if not ln.startswith("new best")]
    best = [ln for ln in lines if ln.startswith("new best")]
    return rows, best


def copy_run(src, dst):
    """The files eval reads, so that nothing is written into ``src``."""
    os.makedirs(dst)
    for name in ("config.json", "vocab.pkl"):
        shutil.copy(os.path.join(src, name), dst)
    shutil.copytree(os.path.join(src, "best_model"),
                    os.path.join(dst, "best_model"))
    return dst


@pytest.mark.parametrize("seed", sorted(SEED_DEV_F1))
def test_eval_cli_reaches_gcn_tpu_seed_dev_f1(seed, tmp_path):
    src = os.path.join(FLAGSHIP, f"seed{seed}", "gcn_tpu_full_deprel_models",
                       "cmp")
    run = copy_run(src, str(tmp_path / "cmp"))
    out = eval_cli.main([run, "--data_dir",
                         os.path.join(FLAGSHIP, f"seed{seed}", "data"),
                         "--dataset", "dev", "--cpu", "--out",
                         str(tmp_path / "pred.txt")])
    assert round(out["f1"], 6) == SEED_DEV_F1[seed]
    assert out["sentences"] == 1200 and out["batch_size"] == 100
    assert os.path.exists(os.path.join(run, "dev_incorrect_data.json"))
    assert len(open(tmp_path / "pred.txt").read().split()) == 1200


def _init_checkpoint(directory, argv):
    """A checkpoint of the model the train CLI builds for ``argv``."""
    cfg = cli.args_to_config(cli.build_parser("tacred").parse_args(argv))
    from gcn_tpu_torch.data.vocab import Vocab

    vocab = Vocab.load(os.path.join(cfg.data.vocab_dir, "vocab.pkl"))
    cfg.model.vocab_size = vocab.size
    trainer_mod.Trainer(cfg, emb_matrix=load_word_embeddings(cfg, vocab),
                        rng_seed=7, device="cpu").save(directory, epoch=0)


@pytest.fixture(scope="module")
def warm_runs(tmp_path_factory, one_torch_thread):  # noqa: F811
    """The port's and gcn_tpu's 2-epoch runs from one warm start."""
    root = tmp_path_factory.mktemp("warm")
    argv = [*SMALL, *NO_DROPOUT, "--num_epoch", "2", "--seed", "3",
            "--lr", "0.3", "--pooling_l2", "0.003", "--load",
            "--model_file", str(root / "init")]
    _init_checkpoint(str(root / "init"), argv)
    train.main([*argv, "--cpu", "--id", "port",
                "--model_save_dir", str(root)])
    jargs = jax_cli.build_parser("tacred").parse_args(
        [*argv, "--id", "jax", "--model_save_dir", str(root)])
    devices = jax.devices
    try:  # gcn_tpu's single-device trainer, as on a one-chip host
        jax.devices = lambda *a, **k: devices(*a, **k)[:1]
        jax_run_training(jax_cli.args_to_config(jargs),
                         load_from=jargs.model_file)
    finally:
        jax.devices = devices
    return str(root / "port"), str(root / "jax")


def test_train_cli_matches_gcn_tpu_from_a_warm_start(warm_runs):
    port, jax_run = warm_runs
    (prows, pbest), (jrows, jbest) = logs_rows(port), logs_rows(jax_run)
    assert len(prows) == len(jrows) == 2
    for p, j in zip(prows, jrows):
        assert p[0] == j[0] and p[3:] == j[3:]  # epoch, dev F1s
        np.testing.assert_allclose(p[1:3], j[1:3], rtol=1e-4)
    assert pbest == jbest
    for name in ("config.json", "vocab.pkl", "deprel_embs.pkl",
                 "best_model", "checkpoint_epoch_2", "test_confusion_matrix.pkl",
                 "dev_confusion_matrix.pkl", "test_incorrect_data.json",
                 "dev_incorrect_data.json"):
        assert os.path.exists(os.path.join(port, name)), name
    for name in ("test_confusion_matrix.pkl", "dev_confusion_matrix.pkl"):
        with open(os.path.join(port, name), "rb") as f, \
                open(os.path.join(jax_run, name), "rb") as g:
            assert pickle.load(f) == pickle.load(g), name
    with open(os.path.join(port, "deprel_embs.pkl"), "rb") as f:
        assert isinstance(pickle.load(f), np.ndarray)


def test_root_eval_reads_a_port_run(warm_runs, tmp_path, monkeypatch):
    """gcn_tpu's eval.py predicts on the port's best model what the port's
    eval CLI does, and that F1 is the test F1 logs.txt has at the best."""
    port, _ = warm_runs
    run = copy_run(port, str(tmp_path / "run"))
    monkeypatch.setattr(sys, "argv", ["eval.py", run, "--dataset", "test",
                                      "--cpu", "--out",
                                      str(tmp_path / "jax.txt")])
    runpy.run_path(os.path.join(REPO, "eval.py"), run_name="__main__")
    out = eval_cli.main([run, "--dataset", "test", "--cpu", "--out",
                         str(tmp_path / "port.txt")])
    assert open(tmp_path / "jax.txt").read() == open(
        tmp_path / "port.txt").read()
    _, best = logs_rows(port)
    assert float(best[-1].split("\t")[-1]) == round(out["f1"] * 100, 2)


class _Killed(Exception):
    pass


@pytest.mark.parametrize("where", ["mid_epoch_step", "epoch_end"])
def test_resumed_run_is_the_uninterrupted_run(where, tmp_path, monkeypatch):
    """Dropout and word dropout on, update_gap 2: a step checkpoint taken
    with a batch pending (after step 3), or an epoch checkpoint."""
    argv = [*SMALL, "--effective_batch_size", "16", "--save_steps", "3",
            "--cpu", "--model_save_dir", str(tmp_path)]
    train.main([*argv, "--num_epoch", "2", "--id", "whole"])
    if where == "epoch_end":
        train.main([*argv, "--num_epoch", "1", "--id", "split"])
    else:
        update = trainer_mod.Trainer.update

        def killed_at_step_4(self, batch):
            if self.global_step == 4:
                raise _Killed
            return update(self, batch)

        monkeypatch.setattr(trainer_mod.Trainer, "update", killed_at_step_4)
        with pytest.raises(_Killed):
            train.main([*argv, "--num_epoch", "2", "--id", "split"])
        monkeypatch.undo()
        meta = json.load(open(tmp_path / "split" / "checkpoint_step_3" /
                              "meta.json"))["meta"]
        assert (meta["global_step"], meta["step_in_epoch"]) == (2, 2)
    train.main([*argv, "--num_epoch", "2", "--id", "split", "--resume"])
    assert logs_rows(tmp_path / "whole") == logs_rows(tmp_path / "split")
    for name in ("checkpoint_epoch_2", "best_model"):
        want = load_checkpoint(str(tmp_path / "whole" / name))
        got = load_checkpoint(str(tmp_path / "split" / name))
        assert got[2]["meta"] == want[2]["meta"], name
        for a, b in zip(jax.tree.leaves(got[:2]), jax.tree.leaves(want[:2])):
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_semeval_cli_selects_on_train_f1(tmp_path, capsys):
    out = train_semeval.main([
        "--cpu", "--id", "se", "--num_epoch", "1", "--hidden_dim", "16",
        "--rnn_hidden", "8", "--batch_size", "20",
        "--effective_batch_size", "20", "--model_save_dir", str(tmp_path),
        "--data_dir", os.path.join(REPO, "dataset", "semeval"),
        "--vocab_dir", os.path.join(REPO, "dataset", "vocab_semeval")])
    printed = capsys.readouterr().out
    cfg = json.load(open(tmp_path / "se" / "config.json"))
    assert cfg["model"]["dataset"] == "semeval"
    assert cfg["model"]["ner_dim"] == 0 and cfg["model"]["num_class"] == 10
    train_f1 = float(re.search(r"train_f1 = ([\d.]+)", printed).group(1))
    rows, _ = logs_rows(tmp_path / "se")
    assert rows[0][3] == train_f1 and out["best_dev"]["f1"] >= 0
    assert "Evaluating on dev set" not in printed
    assert not os.path.exists(tmp_path / "se" / "dev_confusion_matrix.pkl")
    assert os.path.exists(tmp_path / "se" / "test_confusion_matrix.pkl")


def test_bert_embeddings_file_feeds_the_cli(tmp_path):
    """--use_bert_embeddings with a pickle of {id: [L, 1024]} numpy rows:
    the model takes 1024-wide float words and has no word table."""
    rng = np.random.RandomState(0)
    data = tmp_path / "data"
    data.mkdir()
    rows = {}
    for split in ("train", "dev", "test"):  # ids unique across splits
        recs = json.load(open(os.path.join(REPO, "dataset", "tacred",
                                           f"{split}.json")))
        for d in recs:
            d["id"] = f"{split}-{d['id']}"
            rows[d["id"]] = rng.randn(len(d["token"]), 1024).astype(
                np.float32)
        json.dump(recs, open(data / f"{split}.json", "w"))
    with open(tmp_path / "bert.pkl", "wb") as f:
        pickle.dump(rows, f)
    out = train.main([*SMALL, "--cpu", "--num_epoch", "1", "--id", "bb",
                      "--model_save_dir", str(tmp_path / "runs"),
                      "--data_dir", str(data), "--use_bert_embeddings",
                      "true", "--bert_embeddings_file",
                      str(tmp_path / "bert.pkl")])
    params, _, blob = load_checkpoint(out["run_dir"] + "/best_model")
    assert "word_emb" not in params["params"]
    assert blob["config"]["model"]["emb_dim"] == 1024
    assert params["params"]["rnn"]["l0_fwd_w_ih"].shape[0] == 1024 + 60


def test_prepare_vocab_writes_gcn_tpu_files(tmp_path, monkeypatch):
    data = os.path.join(REPO, "dataset", "tacred")
    words = sorted({t for split in ("train", "dev") for d in json.load(
        open(os.path.join(data, f"{split}.json"))) for t in d["token"]})
    rng = np.random.RandomState(0)
    glove = tmp_path / "glove"
    glove.mkdir()
    with open(glove / "tiny.txt", "w") as f:
        for w in words[::2] + ["absent-word", "two words"]:
            print(w, *np.round(rng.randn(5), 4), file=f)
    args = [data, None, "--glove_dir", str(glove), "--wv_file", "tiny.txt",
            "--wv_dim", "5"]
    outs = {}
    for who in ("port", "jax"):
        args[1] = str(tmp_path / who)
        np.random.seed(0)  # the OOV rows' uniform draws
        if who == "port":
            prepare_vocab.main(args)
        else:
            monkeypatch.setattr(sys, "argv", ["prepare_vocab.py", *args])
            runpy.run_path(os.path.join(REPO, "prepare_vocab.py"),
                           run_name="__main__")
        with open(tmp_path / who / "vocab.pkl", "rb") as f:
            outs[who] = (pickle.load(f),
                         np.load(tmp_path / who / "embedding.npy"))
    assert outs["port"][0] == outs["jax"][0]
    np.testing.assert_array_equal(outs["port"][1], outs["jax"][1])
    assert outs["port"][1].shape == (len(outs["port"][0]), 5)


def test_vocab_helpers_match_gcn_tpu(tmp_path):
    from gcn_tpu.data.vocab import Vocab as JaxVocab
    from gcn_tpu_torch.data.vocab import Vocab

    counts = {"b": 3, "a": 5, "c": 1, "d": 3}
    for threshold in (0, 3):
        mine = Vocab.from_counter(counts, threshold)
        ref = JaxVocab.from_counter(counts, threshold)
        assert mine.id2word == ref.id2word
        assert mine.unmap([3, 2, 1]) == ref.unmap([3, 2, 1])
    mine.save(str(tmp_path / "v" / "vocab.pkl"))
    assert JaxVocab.load(str(tmp_path / "v" / "vocab.pkl")).id2word == \
        mine.id2word


def test_parser_has_gcn_tpu_flags_and_defaults():
    for dataset in ("tacred", "semeval"):
        mine, ref = cli.build_parser(dataset), jax_cli.build_parser(dataset)
        assert {a.dest: (a.option_strings, a.default, a.choices)
                for a in mine._actions} == {
            a.dest: (a.option_strings, a.default, a.choices)
            for a in ref._actions}
        argv = ["--hidden_dim", "7", "--use_pallas", "true",
                "--deprel_factored", "ragged", "--no-rnn", "--cuda"]
        assert cli.args_to_config(mine.parse_args(argv)).to_dict() == \
            jax_cli.args_to_config(ref.parse_args(argv)).to_dict()


@pytest.mark.parametrize("flag", [
    ["--graph_partition", "halo"],
    ["--graph_partition", "halo", "--graph_axis", "2"],
    ["--graph_partition", "halo", "--graph_axis", "2", "--adj_type",
     "attention"],
])
def test_unsupported_flags_raise(flag, tmp_path):
    """No flag of gcn_tpu's is refused: ``--graph_partition halo`` trains.
    One process holds no model axis above 1, so it runs the dense path, as
    gcn_tpu's one-device driver does: its logs equal the unpartitioned
    run's in bits, and its config keeps the flag."""
    assert cli.UNSUPPORTED == {}
    rest = flag[2:]
    runs = {}
    for name, args in (("halo", flag), ("none", rest)):
        out = train.main([*SMALL, "--cpu", "--num_epoch", "1", *args,
                          "--id", name, "--model_save_dir",
                          str(tmp_path)])
        with open(os.path.join(out["run_dir"], "logs.txt")) as f:
            runs[name] = [ln for ln in f.read().splitlines()
                          if not ln.startswith("#")]
        with open(os.path.join(out["run_dir"], "config.json")) as f:
            assert json.load(f)["model"]["graph_partition"] == name
    assert runs["halo"] == runs["none"] and runs["none"]


def test_sparse_emb_grad_true_needs_a_row_local_optimizer(tmp_path):
    """As gcn_tpu's trainer: --sparse_emb_grad true with adam raises."""
    with pytest.raises(ValueError, match="sparse_emb_grad true requires"):
        train.main([*SMALL, "--cpu", "--sparse_emb_grad", "true",
                    "--optim", "adam", "--model_save_dir", str(tmp_path)])


def test_dispatch_only_flags_are_stored_and_named(tmp_path, capsys):
    """Also: --profile_dir writes a trace of step 3, and --test_save_dir /
    --test_confusion_save_file take the artifacts out of the run dir."""
    train.main([*SMALL, "--cpu", "--num_epoch", "1", "--id", "dd",
                "--model_save_dir", str(tmp_path / "runs"),
                "--pack_transfers", "false", "--pack_format", "int32",
                "--steps_per_dispatch", "4", "--warmup_compile", "true",
                "--prng_impl", "rbg", "--debug_nans",
                "--profile_dir", str(tmp_path / "prof"),
                "--test_save_dir", str(tmp_path / "art"),
                "--test_confusion_save_file", str(tmp_path / "cm.pkl")])
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if "not acted on" in ln]
    assert len(line) == 1
    assert cli.DISPATCH_ONLY == ("prng_impl", "compilation_cache_dir",
                                 "debug_nans")
    for flag in cli.DISPATCH_ONLY:
        assert f"--{flag}" in line[0]
    for flag in ("pack_transfers", "pack_format", "steps_per_dispatch",
                 "warmup_compile"):  # these act (test_dispatch_flags_act)
        assert f"--{flag}" not in line[0]
    run = tmp_path / "runs" / "dd"
    t = json.load(open(run / "config.json"))["train"]
    assert (t["pack_transfers"], t["pack_format"], t["steps_per_dispatch"],
            t["warmup_compile"], t["prng_impl"]) == (False, "int32", 4,
                                                     "true", "rbg")
    assert "traceEvents" in json.load(open(tmp_path / "prof" / "trace.json"))
    assert sorted(os.listdir(tmp_path / "art" / "dd")) == [
        "dev_confusion_matrix.pkl", "dev_incorrect_data.json",
        "test_incorrect_data.json"]
    assert os.path.exists(tmp_path / "cm.pkl")
    assert not os.path.exists(run / "test_incorrect_data.json")


def test_dispatch_flags_act(tmp_path, capsys, monkeypatch):
    """--steps_per_dispatch 4 sends the train steps to update_chunk in
    chunks, --warmup_compile true runs Trainer.warmup once before epoch 1
    with every batcher's shapes (and auto does only with chunks),
    --pack_format picks the packed layout, and --pack_transfers false
    turns the chunks off, as in gcn_tpu."""
    calls = {"chunks": [], "warmup": [], "formats": set()}
    update_chunk = trainer_mod.Trainer.update_chunk
    warmup = trainer_mod.Trainer.warmup

    def chunked(self, batches):
        calls["chunks"].append(len(batches))
        calls["formats"].add((self.staging.pack, self.staging.fmt))
        return update_chunk(self, batches)

    def warmed(self, batches, **kw):
        calls["warmup"].append((len(batches), len(kw["eval_batches"])))
        return warmup(self, batches, **kw)

    monkeypatch.setattr(trainer_mod.Trainer, "update_chunk", chunked)
    monkeypatch.setattr(trainer_mod.Trainer, "warmup", warmed)
    base = [*SMALL, "--cpu", "--num_epoch", "1",
            "--model_save_dir", str(tmp_path)]
    train.main([*base, "--id", "a", "--steps_per_dispatch", "4",
                "--warmup_compile", "true", "--pack_format", "int32"])
    assert sum(calls["chunks"]) == 5 and max(calls["chunks"]) > 1
    assert calls["formats"] == {(True, "int32")}
    assert len(calls["warmup"]) == 1 and min(calls["warmup"][0]) > 0
    assert any(ln.startswith("warmup: compiled 0 programs")
               for ln in capsys.readouterr().out.splitlines())
    for i, (kw, chunks, warmups) in enumerate((
            (["--steps_per_dispatch", "4", "--pack_transfers", "false"], 0,
             1),  # auto warms up at 4 either way
            (["--warmup_compile", "false", "--steps_per_dispatch", "2"], 5,
             0),
            ([], 0, 0))):
        calls["chunks"].clear()
        calls["warmup"].clear()
        train.main([*base, "--id", f"b{i}", *kw])
        assert sum(calls["chunks"]) == chunks, kw
        assert len(calls["warmup"]) == warmups, kw


def test_entry_points_raise_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main([*SMALL, "--model_save_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_cli.main([str(tmp_path)])
