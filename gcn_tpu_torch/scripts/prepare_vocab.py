"""Prepare vocabulary and initial word vectors from GloVe.

The port's counterpart of the root ``prepare_vocab.py``, with its
arguments: harvests corpus tokens with entity spans masked out of the
vocabulary, intersects with GloVe, writes reference-compatible
``vocab.pkl`` (pickled list) and ``embedding.npy``.

    python -m gcn_tpu_torch.scripts.prepare_vocab dataset/tacred \
        dataset/vocab --glove_dir dataset/glove
"""

import argparse
import json
import pickle
from collections import Counter

import numpy as np

from gcn_tpu_torch import constants
from gcn_tpu_torch.data import vocab as vocab_mod
from gcn_tpu_torch.train.logger import ensure_dir


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Prepare vocab for relation extraction."
    )
    p.add_argument("data_dir", help="TACRED directory.")
    p.add_argument("vocab_dir", help="Output vocab directory.")
    p.add_argument("--glove_dir", default="dataset/glove")
    p.add_argument("--wv_file", default="glove.840B.300d.txt")
    p.add_argument("--wv_dim", type=int, default=300)
    p.add_argument("--min_freq", type=int, default=0)
    p.add_argument("--lower", action="store_true")
    p.add_argument("--dataset", choices=["tacred", "semeval"],
                   default="tacred",
                   help="semeval: train/test splits only (no dev) and "
                        "entity spans KEPT in the vocabulary — the "
                        "SemEval loader never anonymizes entities "
                        "(reference data/semeval_loader.py:52-55), so "
                        "their tokens need embeddings")
    return p.parse_args(argv)


def load_tokens(filename, mask_entities=True):
    """Corpus tokens, with entity spans removed when ``mask_entities``
    (reference ``prepare_vocab.py:73-85``; TACRED anonymizes entities at
    load time so their surface forms must stay out of the vocab)."""
    with open(filename) as f:
        data = json.load(f)
    tokens = []
    for d in data:
        ts = list(d["token"])
        if mask_entities:
            ss, se = d["subj_start"], d["subj_end"]
            os_, oe = d["obj_start"], d["obj_end"]
            ts[ss : se + 1] = [constants.PAD_TOKEN] * (se - ss + 1)
            ts[os_ : oe + 1] = [constants.PAD_TOKEN] * (oe - os_ + 1)
        tokens += [t for t in ts if t != constants.PAD_TOKEN]
    print(f"{len(tokens)} tokens from {len(data)} examples loaded from "
          f"{filename}.")
    return tokens


def entity_masks():
    """SUBJ-/OBJ- mask tokens (reference ``prepare_vocab.py:106-113``)."""
    subj = list(constants.SUBJ_NER_TO_ID.keys())[2:]
    obj = list(constants.OBJ_NER_TO_ID.keys())[2:]
    return ["SUBJ-" + e for e in subj] + ["OBJ-" + e for e in obj]


def build_vocab(tokens, glove_vocab, min_freq):
    counter = Counter(tokens)
    if min_freq > 0:
        v = sorted(
            (t for t in counter if counter[t] >= min_freq),
            key=counter.get, reverse=True,
        )
    else:
        v = sorted(
            (t for t in counter if t in glove_vocab),
            key=counter.get, reverse=True,
        )
    v = constants.VOCAB_PREFIX + entity_masks() + v
    print(f"vocab built with {len(v)}/{len(counter)} words.")
    return v


def count_oov(tokens, v):
    c = Counter(tokens)
    total = sum(c.values())
    matched = sum(c[t] for t in v)
    return total, total - matched


def main(argv=None):
    args = parse_args(argv)
    ensure_dir(args.vocab_dir)
    wv_file = f"{args.glove_dir}/{args.wv_file}"

    print("loading files...")
    names = (("train", "test") if args.dataset == "semeval"
             else ("train", "dev", "test"))
    splits = {
        name: load_tokens(f"{args.data_dir}/{name}.json",
                          mask_entities=args.dataset == "tacred")
        for name in names
    }
    if args.lower:
        splits = {k: [t.lower() for t in v] for k, v in splits.items()}

    print("loading glove...")
    glove_vocab = vocab_mod.load_glove_vocab(wv_file, args.wv_dim)
    print(f"{len(glove_vocab)} words loaded from glove.")

    print("building vocab...")
    v = build_vocab(splits["train"], glove_vocab, args.min_freq)

    print("calculating oov...")
    for name, toks in splits.items():
        total, oov = count_oov(toks, v)
        print(f"{name} oov: {oov}/{total} ({oov * 100.0 / total:.2f}%)")

    print("building embeddings...")
    embedding = vocab_mod.build_embedding(wv_file, v, args.wv_dim)
    print("embedding size: {} x {}".format(*embedding.shape))

    print("dumping to files...")
    with open(f"{args.vocab_dir}/vocab.pkl", "wb") as f:
        pickle.dump(v, f)
    np.save(f"{args.vocab_dir}/embedding.npy", embedding)
    print("all done.")


if __name__ == "__main__":
    main()
