"""Train a GCN/C-GCN relation-extraction model on TACRED.

The port's counterpart of the root ``train.py``, with the same flags
(``gcn_tpu_torch.train.cli``); on the card unless ``--cpu``:

    python -m gcn_tpu_torch.scripts.train --id 00 --seed 0 --prune_k 1 \
        --lr 0.3 --rnn_hidden 200 --num_epoch 100 --pooling max \
        --mlp_layers 2 --pooling_l2 0.003 --word_dropout 0.04 \
        --emb_dropout 0.0 --deprel_emb_dim 50 --adj_type full_deprel \
        --batch_size 50
"""

from __future__ import annotations

import pickle

from gcn_tpu_torch.train.cli import (
    args_to_config,
    build_parser,
    check_supported,
    dispatch_only_line,
)
from gcn_tpu_torch.train.driver import run_training
from gcn_tpu_torch.train.evaluator import resolve_device


def main(argv=None, dataset: str = "tacred", **defaults) -> dict:
    """Parse ``argv`` (``defaults`` override the parser's) and train;
    returns ``run_training``'s result."""
    parser = build_parser(dataset=dataset)
    parser.set_defaults(**defaults)
    args = parser.parse_args(argv)
    check_supported(args)
    device = resolve_device("cpu" if args.cpu else "cuda")
    print(dispatch_only_line())
    cfg = args_to_config(args)

    bert_embeddings = None
    if args.use_bert_embeddings and args.bert_embeddings_file:
        print(f"Loading BERT embeddings from {args.bert_embeddings_file}...")
        with open(args.bert_embeddings_file, "rb") as f:
            bert_embeddings = pickle.load(f)

    load_from = args.model_file if args.load else None
    result = run_training(cfg, bert_embeddings=bert_embeddings,
                          load_from=load_from,
                          profile_dir=args.profile_dir or None,
                          resume=args.resume, device=device)
    print("Final test metrics at best dev:", result["test_at_best_dev"])
    return result


if __name__ == "__main__":
    main()
