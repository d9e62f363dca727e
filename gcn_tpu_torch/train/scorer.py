"""Official scoring: micro P/R/F1 over string labels, excluding the
negative relation, confusion counts and a scoring CLI (a copy of
``gcn_tpu.train.scorer``).

Same math as the reference's TACRED scorer (``utils/scorer.py:20-96``):
pairs where both gold and prediction are the negative label are ignored;
correct counts require an exact match on a non-negative label.  Works for
SemEval too by passing ``negative_label='Other'``.
"""

from __future__ import annotations

import sys
from collections import Counter
from typing import Sequence

NO_RELATION = "no_relation"


def score(
    key: Sequence[str],
    prediction: Sequence[str],
    verbose: bool = False,
    negative_label: str = NO_RELATION,
    out=sys.stdout,
) -> tuple[float, float, float]:
    """Returns (precision_micro, recall_micro, f1_micro)."""
    assert len(key) == len(prediction), (
        f"gold and prediction must align: {len(key)} vs {len(prediction)}"
    )
    correct_by_relation: Counter = Counter()
    guessed_by_relation: Counter = Counter()
    gold_by_relation: Counter = Counter()

    for gold, guess in zip(key, prediction):
        if gold == negative_label and guess == negative_label:
            continue
        if guess != negative_label:
            guessed_by_relation[guess] += 1
        if gold != negative_label:
            gold_by_relation[gold] += 1
        if (
            gold != negative_label
            and guess != negative_label
            and gold == guess
        ):
            correct_by_relation[guess] += 1

    if verbose:
        print("Per-relation statistics:", file=out)
        relations = sorted(gold_by_relation.keys())
        width = max((len(r) for r in relations), default=0)
        for relation in relations:
            correct = correct_by_relation[relation]
            guessed = guessed_by_relation[relation]
            gold_n = gold_by_relation[relation]
            prec = correct / guessed if guessed > 0 else 1.0
            rec = correct / gold_n if gold_n > 0 else 0.0
            f1 = 2 * prec * rec / (prec + rec) if prec + rec > 0 else 0.0
            print(
                f"{relation:<{width}}  P: {prec:7.2%}  R: {rec:7.2%}"
                f"  F1: {f1:7.2%}  #: {gold_n}",
                file=out,
            )
        print("", file=out)

    n_correct = sum(correct_by_relation.values())
    n_guessed = sum(guessed_by_relation.values())
    n_gold = sum(gold_by_relation.values())
    prec_micro = n_correct / n_guessed if n_guessed > 0 else 1.0
    recall_micro = n_correct / n_gold if n_gold > 0 else 0.0
    f1_micro = (
        2 * prec_micro * recall_micro / (prec_micro + recall_micro)
        if prec_micro + recall_micro > 0
        else 0.0
    )
    print(f"Precision (micro): {prec_micro:.3%}", file=out)
    print(f"   Recall (micro): {recall_micro:.3%}", file=out)
    print(f"       F1 (micro): {f1_micro:.3%}", file=out)
    return prec_micro, recall_micro, f1_micro


def compute_confusion_matrices(ground_truth, predictions) -> dict:
    """Dict-of-dicts confusion counts (reference ``utils/scorer.py:98-106``)."""
    cm: dict = {}
    for gold, pred in zip(ground_truth, predictions):
        cm.setdefault(gold, {}).setdefault(pred, 0)
        cm[gold][pred] += 1
    return cm


def main(argv=None):
    """CLI: score a prediction file against a gold file
    (reference ``utils/scorer.py:108-120``)."""
    import argparse

    p = argparse.ArgumentParser(description="Score predictions vs gold.")
    p.add_argument("gold_file")
    p.add_argument("pred_file")
    p.add_argument("--negative_label", default=NO_RELATION)
    args = p.parse_args(argv)
    with open(args.gold_file) as f:
        key = [line.rstrip("\n") for line in f]
    with open(args.pred_file) as f:
        pred = [line.rstrip("\n") for line in f]
    if len(key) != len(pred):
        print(
            f"Gold and prediction must have same length: {len(key)} vs "
            f"{len(pred)}"
        )
        raise SystemExit(1)
    score(key, pred, verbose=True, negative_label=args.negative_label)


if __name__ == "__main__":
    main()
