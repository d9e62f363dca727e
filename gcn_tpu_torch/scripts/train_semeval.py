"""Train a GCN/C-GCN model on SemEval-2010 Task 8.

The port's counterpart of the root ``train_semeval.py``: no NER features,
the 10-class label set, and the best model chosen on train F1 when there
is no dev split (reference ``train_semeval.py:256-262``):

    python -m gcn_tpu_torch.scripts.train_semeval --id 00 --seed 0 \
        --prune_k 1 --lr 0.3 --rnn_hidden 200 --num_epoch 100 \
        --pooling max --mlp_layers 2 --pooling_l2 0.003 --word_dropout 0. \
        --emb_dropout 0.0
"""

from __future__ import annotations

from gcn_tpu_torch.scripts import train


def main(argv=None) -> dict:
    return train.main(argv, dataset="semeval", data_dir="dataset/semeval",
                      vocab_dir="dataset/vocab_semeval", ner_dim=0)


if __name__ == "__main__":
    main()
