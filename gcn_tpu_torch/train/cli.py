"""Argparse → Config mapping with gcn_tpu's flags (counterpart of
``gcn_tpu.train.cli``).

``build_parser`` has every flag of ``gcn_tpu/train/cli.py`` under the same
name and default, so the shipped invocations (``train_gcn.sh``,
``train_cgcn.sh``, ``train_cgcn_semeval.sh``) run against the port's
scripts with the same arguments, and ``args_to_config`` fills the same
``Config``.  Then:

* ``--cpu`` runs on the CPU, the card otherwise (no card raises);
  ``--cuda`` is accepted.
* ``check_supported``: flags that change what is computed and that the
  port lacks raise ``NotImplementedError`` naming their ``ROADMAP.md``
  item (``UNSUPPORTED``), and so does a setting the model refuses
  (``models.gcn.check_supported``), before anything is written.
* ``dispatch_only_line``: flags that only tune JAX itself are stored in
  ``config.json`` and named in one printed line (``DISPATCH_ONLY``).
  ``--pack_transfers``, ``--pack_format``, ``--steps_per_dispatch`` and
  ``--warmup_compile`` act on the card's dispatch (``train.transfer``,
  ``train.dispatch``).
"""

from __future__ import annotations

import argparse

from gcn_tpu_torch.config import Config

# flag → (the value it is unsupported at, as a test of args; the message):
# every flag of gcn_tpu's is ported
UNSUPPORTED: dict = {}
# flags that tune only JAX: its PRNG, its compilation cache, its NaN checks
DISPATCH_ONLY = ("prng_impl", "compilation_cache_dir", "debug_nans")


def _pallas_mode(v: str):
    return "auto" if v.lower() == "auto" else str2bool(v)


def _factored_mode(v: str):
    lv = v.lower()
    if lv in ("auto", "ragged", "pallas"):
        return lv
    return str2bool(v)


def str2bool(v: str) -> bool:
    return str(v).lower() in ("true", "1", "yes")


def build_parser(dataset: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", type=str, default="dataset/tacred")
    p.add_argument("--vocab_dir", type=str, default="dataset/vocab")
    p.add_argument("--model_save_dir", type=str, default="saved_models")
    p.add_argument("--train_file", type=str, default="train.json",
                   help="Training split file name (the reference hard-codes "
                        "train_0.1.json, a 10%% subsample).")
    p.add_argument("--emb_dim", type=int, default=300)
    p.add_argument("--ner_dim", type=int, default=30)
    p.add_argument("--pos_dim", type=int, default=30)
    p.add_argument("--hidden_dim", type=int, default=200)
    p.add_argument("--num_layers", type=int, default=2)
    p.add_argument("--input_dropout", type=float, default=0.5)
    p.add_argument("--gcn_dropout", type=float, default=0.5)
    p.add_argument("--word_dropout", type=float, default=0.04)
    p.add_argument("--topn", type=int, default=int(1e10))
    p.add_argument("--lower", dest="lower", action="store_true")
    p.add_argument("--no-lower", dest="lower", action="store_false")
    p.set_defaults(lower=False)

    p.add_argument("--prune_k", default=1, type=int,
                   help="-1 keeps the whole tree (works here; crashes the "
                        "reference).")
    p.add_argument("--conv_l2", type=float, default=0)
    p.add_argument("--pooling", choices=["max", "avg", "sum"], default="max")
    p.add_argument("--pooling_l2", type=float, default=0)
    p.add_argument("--scorer_negative_label", type=str, default="",
                   help="label excluded from micro-F1 ('' = the dataset's "
                        "own negative). The reference scores SemEval with "
                        "the TACRED scorer's literal 'no_relation', so its "
                        "SemEval F1 counts 'Other' as a positive class; "
                        "pass 'no_relation' to reproduce that metric.")
    p.add_argument("--mlp_layers", type=int, default=2)
    p.add_argument("--no_adj", dest="no_adj", action="store_true")
    p.set_defaults(no_adj=False)

    p.add_argument("--rnn", dest="rnn", action="store_true")
    p.add_argument("--no-rnn", dest="rnn", action="store_false")
    p.set_defaults(rnn=True)
    p.add_argument("--rnn_hidden", type=int, default=200)
    p.add_argument("--rnn_layers", type=int, default=1)
    p.add_argument("--rnn_dropout", type=float, default=0.5)
    p.add_argument("--rnn_unroll", type=int, default=8,
                   help="lax.scan unroll factor in gcn_tpu; stored only")
    p.add_argument("--rnn_impl", type=str, default="auto",
                   choices=["auto", "scan", "pallas"],
                   help="BiLSTM time loop: scan = the plain PyTorch scan, "
                        "auto or pallas = the CUDA scan kernels on the card")

    p.add_argument("--lr", type=float, default=1.0)
    p.add_argument("--lr_decay", type=float, default=0.9)
    p.add_argument("--decay_epoch", type=int, default=5)
    p.add_argument("--optim", default="sgd",
                   choices=["sgd", "adagrad", "adam", "adamax", "adadelta"])
    p.add_argument("--num_epoch", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=50)
    p.add_argument("--effective_batch_size", type=int, default=50)
    p.add_argument("--eval_batch_size", type=int, default=0,
                   help="Eval/dev/test forward batch size (0 = "
                        "batch_size). F1 is batching-invariant; larger "
                        "values cut per-epoch eval dispatches.")
    p.add_argument("--max_grad_norm", type=float, default=5.0)
    p.add_argument("--log_step", type=int, default=20)
    p.add_argument("--log", type=str, default="logs.txt")
    p.add_argument("--save_epoch", type=int, default=100)
    p.add_argument("--keep_latest_checkpoints", type=int, default=1,
                   help="Always retain the newest k epoch checkpoints (elastic recovery).")
    p.add_argument("--save_steps", type=int, default=0,
                   help="Also checkpoint every N optimizer steps (0 = per-epoch only).")
    p.add_argument("--async_save", type=str2bool, default=False,
                   help="Write checkpoints on a background thread.")
    p.add_argument("--id", type=str, default="00")
    p.add_argument("--test_save_dir", type=str, default="",
                   help="Reference-compatible: redirect confusion/"
                        "misclassified artifacts to <test_save_dir>/<id>/ "
                        "(default: the run directory).")
    p.add_argument("--test_confusion_save_file", type=str, default="",
                   help="Reference-compatible: explicit path for the test "
                        "confusion-matrix pickle.")
    p.add_argument("--cuda", action="store_true",
                   help="Accepted for reference-script compatibility "
                        "(the card is the default; --cpu leaves it).")
    p.add_argument("--deprel_attn", action="store_true",
                   help="Accepted for reference-script compatibility "
                        "(dead code there; see --adj_type attention for "
                        "the working edge-attention mode here).")
    p.add_argument("--info", type=str, default="")
    p.add_argument("--seed", type=int, default=1234)

    p.add_argument("--load", dest="load", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="Resume from the newest checkpoint in the run dir.")
    p.set_defaults(load=False)
    p.add_argument("--model_file", type=str,
                   help="Checkpoint directory to warm-start from.")

    p.add_argument("--adj_type", type=str, default="regular")
    p.add_argument("--attention_impl", type=str, default="auto",
                   choices=["auto", "dense", "edge"],
                   help="adj_type=attention backend: dense [B,N,N] masked "
                        "softmax (MXU-native; wins at sentence scale) vs "
                        "edge-list SDDMM path (O(E) memory for giant "
                        "forests); auto picks by padded node count.")
    p.add_argument("--deprel_emb_dim", type=int, default=200)
    p.add_argument("--deprel_dropout", type=float, default=0.5)
    p.add_argument("--deprel_self_loop", type=str2bool, default=True)
    p.add_argument("--deprel_directed", type=str2bool, default=False)
    p.add_argument("--deprel_shared_w", type=str2bool, default=False)
    p.add_argument("--use_bert_embeddings", type=str2bool, default=False)
    p.add_argument("--bert_embeddings_file", type=str, default="")
    p.add_argument("--emb_dropout", type=float, default=0.0)
    p.add_argument("--deprel_alpha", type=float, default=1.0)
    p.add_argument("--edge_keep_prob", type=float, default=1.0)
    p.add_argument("--deprel_keep_prop", type=float, default=1.0)
    p.add_argument("--deprel_max_depth", type=int, default=2)

    # gcn_tpu's own flags beyond the reference's
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="bfloat16: the forward in bf16 (parameters, "
                        "gradients and the loss stay f32); not yet with "
                        "the attention edge backend or the non-factored "
                        "fused full_deprel (raises).")
    p.add_argument("--group_by_length", type=str2bool, default=False,
                   help="Batch same-length-bucket sentences together "
                        "(changes batch composition vs the reference's "
                        "shuffle-then-chunk).")
    p.add_argument("--use_pallas", type=_pallas_mode, default="auto",
                   help="Edge-list aggregation kernels (the CUDA band and "
                        "fused-layer kernels): true | false | auto (= off, "
                        "the dense bands).")
    p.add_argument("--deprel_factored", type=_factored_mode, default="auto",
                   help="Factored full_deprel (per-relation matrices + one "
                        "grouped matmul, same math): true | false | auto "
                        "(= on) | ragged (the plain grouped matmul) | "
                        "pallas (the CUDA grouped-matmul kernels).")
    p.add_argument("--pack_transfers", type=str2bool, default=True,
                   help="One packed host->device buffer a batch, copied "
                        "once from pinned memory (batches of word ids).")
    p.add_argument("--pack_format", choices=["compact", "int32"],
                   default="compact",
                   help="The packed buffer's layout: compact (each field "
                        "at its width; int32 for a batch whose values do "
                        "not fit) or int32.")
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="k same-shape batches a dispatch: one CUDA graph "
                        "of k steps (or k evaluation forwards) on the card.")
    p.add_argument("--warmup_compile", type=str, default="auto",
                   choices=["auto", "true", "false"],
                   help="Capture the run's CUDA graphs before epoch 1 "
                        "(auto = when --steps_per_dispatch > 1).")
    p.add_argument("--sparse_emb_grad", type=str, default="auto",
                   choices=["auto", "true", "false"],
                   help="Row-sparse word-embedding updates (sgd/adagrad, "
                        "word ids, update_gap 1): auto = on from 300k "
                        "vocabulary rows on one process, off under data "
                        "parallelism.")
    p.add_argument("--pack_sentences", type=int, default=0,
                   help="Cross-sentence packing: > 0 packs up to this "
                        "many sentences a row (batch_size counts rows).")
    p.add_argument("--pack_len", type=int, default=0,
                   help="Packed row length in tokens (0 = largest length "
                        "bucket).")
    p.add_argument("--graph_partition", type=str, default="none",
                   choices=["none", "edges", "halo"],
                   help="Graph-parallel aggregation: edges and halo are "
                        "not ported (raise).")
    p.add_argument("--graph_axis", type=int, default=1,
                   help="Mesh `model` axis size for graph partitioning: "
                        "above 1 is not ported (raises).")
    p.add_argument("--prng_impl", type=str, default="auto",
                   choices=["auto", "threefry", "rbg"],
                   help="gcn_tpu: JAX's PRNG backend. Stored only.")
    p.add_argument("--profile_dir", type=str, default="",
                   help="Capture a torch.profiler trace of the third "
                        "training step into this directory.")
    p.add_argument("--compilation_cache_dir", type=str, default="",
                   help="gcn_tpu: XLA's compilation cache. Stored only.")
    p.add_argument("--debug_nans", action="store_true",
                   help="gcn_tpu: jax.debug_nans. Stored only.")
    p.add_argument("--cpu", action="store_true",
                   help="Run on the CPU (the kernels' plain PyTorch "
                        "versions); the card otherwise.")
    p.add_argument("--dataset", type=str, default=dataset,
                   choices=["tacred", "semeval"],
                   help="Dataset flavor (reference train.py:107); the "
                        "TACRED and SemEval entry points set the default.")
    return p


def args_to_config(args: argparse.Namespace) -> Config:
    cfg = Config()
    m, t, d = cfg.model, cfg.train, cfg.data
    m.emb_dim = args.emb_dim
    m.ner_dim = args.ner_dim
    m.pos_dim = args.pos_dim
    m.hidden_dim = args.hidden_dim
    m.num_layers = args.num_layers
    m.input_dropout = args.input_dropout
    m.gcn_dropout = args.gcn_dropout
    m.topn = args.topn
    m.emb_dropout = args.emb_dropout
    m.rnn = args.rnn
    m.rnn_hidden = args.rnn_hidden
    m.rnn_layers = args.rnn_layers
    m.rnn_dropout = args.rnn_dropout
    m.rnn_unroll = args.rnn_unroll
    m.rnn_impl = args.rnn_impl
    m.prune_k = args.prune_k
    m.adj_type = args.adj_type
    m.attention_impl = args.attention_impl
    m.deprel_emb_dim = args.deprel_emb_dim
    m.deprel_dropout = args.deprel_dropout
    m.deprel_self_loop = args.deprel_self_loop
    m.deprel_directed = args.deprel_directed
    m.deprel_shared_w = args.deprel_shared_w
    m.deprel_alpha = args.deprel_alpha
    m.edge_keep_prob = args.edge_keep_prob
    m.deprel_keep_prop = args.deprel_keep_prop
    m.deprel_max_depth = args.deprel_max_depth
    m.no_adj = args.no_adj
    m.pooling = args.pooling
    m.mlp_layers = args.mlp_layers
    m.dataset = args.dataset
    m.use_bert_embeddings = args.use_bert_embeddings
    m.compute_dtype = args.compute_dtype
    m.use_pallas = args.use_pallas
    m.deprel_factored = args.deprel_factored
    m.graph_partition = args.graph_partition
    cfg.mesh.graph_axis = args.graph_axis

    t.prng_impl = args.prng_impl
    t.pack_transfers = args.pack_transfers
    t.pack_format = args.pack_format
    t.steps_per_dispatch = args.steps_per_dispatch
    t.warmup_compile = args.warmup_compile
    t.sparse_emb_grad = args.sparse_emb_grad
    t.lr = args.lr
    t.lr_decay = args.lr_decay
    t.decay_epoch = args.decay_epoch
    t.optim = args.optim
    t.num_epoch = args.num_epoch
    t.batch_size = args.batch_size
    t.effective_batch_size = args.effective_batch_size
    t.eval_batch_size = args.eval_batch_size
    t.max_grad_norm = args.max_grad_norm
    t.log_step = args.log_step
    t.save_epoch = args.save_epoch
    t.keep_latest_checkpoints = args.keep_latest_checkpoints
    t.save_steps = args.save_steps
    t.async_save = args.async_save
    t.seed = args.seed
    t.word_dropout = args.word_dropout
    t.conv_l2 = args.conv_l2
    t.pooling_l2 = args.pooling_l2
    t.lower = args.lower
    t.scorer_negative_label = args.scorer_negative_label

    d.group_by_length = args.group_by_length
    d.pack_sentences = args.pack_sentences
    d.pack_len = args.pack_len
    d.data_dir = args.data_dir
    d.vocab_dir = args.vocab_dir
    d.train_file = args.train_file

    cfg.id = args.id
    cfg.test_save_dir = args.test_save_dir
    cfg.test_confusion_save_file = args.test_confusion_save_file
    cfg.info = args.info
    cfg.model_save_dir = args.model_save_dir
    cfg.log = args.log
    return cfg


def check_supported(args: argparse.Namespace) -> None:
    """Raise ``NotImplementedError`` for a flag the port cannot honour, or
    a combination of flags its model cannot build."""
    from gcn_tpu_torch.models.gcn import check_supported as check_model

    for flag, (unsupported, what) in UNSUPPORTED.items():
        if unsupported(args):
            raise NotImplementedError(
                f"--{flag} {getattr(args, flag)}: {what} is not ported "
                f"to gcn_tpu_torch yet")
    check_model(args_to_config(args).model)


def dispatch_only_line() -> str:
    """The line naming the flags the port stores but does not act on."""
    return ("gcn_tpu_torch: stored in config.json, not acted on (they tune "
            "JAX): "
            + ", ".join(f"--{f}" for f in DISPATCH_ONLY))
