"""The traffic generator: deterministic per seed, TACRED's schema, the
mixes' lengths and bucket histograms, trees and spans the program and the
reference can prune."""

import json
import os
import random

import numpy as np
import pytest

from portbench import generator

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKETS = (16, 32, 48, 64, 96, 128)


def mix(name):
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return json.load(f)


def test_same_seed_same_records_and_another_seed_other_ones():
    m = mix("tacred.train")
    a = generator.make_records(m, 2**31 + 9, 53954, sentences=300)
    b = generator.make_records(m, 2**31 + 9, 53954, sentences=300)
    c = generator.make_records(m, 2**31 + 10, 53954, sentences=300)
    assert a == b
    assert a != c
    # the seed changes what the sentences say, not their lengths
    assert [len(r["token"]) for r in a] == [len(r["token"]) for r in c]


def test_records_have_tacreds_schema():
    recs = generator.make_records(mix("tacred.train"), 5, 53954,
                                  sentences=200)
    keys = {"id", "relation", "token", "subj_start", "subj_end",
            "obj_start", "obj_end", "subj_type", "obj_type", "stanford_pos",
            "stanford_ner", "stanford_head", "stanford_deprel"}
    vocab = set(generator.vocabulary(53954))
    for r in recs:
        assert set(r) == keys
        n = len(r["token"])
        for k in ("stanford_pos", "stanford_ner", "stanford_head",
                  "stanford_deprel"):
            assert len(r[k]) == n
        assert set(r["token"]) <= vocab
        # one root, and every chain of heads reaches it
        head = r["stanford_head"]
        assert head.count(0) == 1
        for i in range(n):
            j, hops = i, 0
            while head[j] > 0:
                j, hops = head[j] - 1, hops + 1
                assert hops <= n
        s = set(range(r["subj_start"], r["subj_end"] + 1))
        o = set(range(r["obj_start"], r["obj_end"] + 1))
        assert s and o and not s & o and max(s | o) < n


@pytest.mark.parametrize("name,mean,cap", [("tacred.train", 36.4, 128),
                                           ("tacred.eval", 36.4, 128),
                                           ("short.train", None, 32)])
def test_lengths_and_sizes(name, mean, cap):
    m = mix(name)
    lengths = generator.lengths_of(m)
    assert len(lengths) == m["sentences"]
    assert lengths.min() >= 8 and lengths.max() <= cap
    if mean is not None:
        assert abs(lengths.mean() - mean) < 0.5


def histogram(name):
    """Batches by bucket, in the order the program's batcher takes them:
    a training mix shuffled by its ``shuffle_seed``, evaluation in file
    order."""
    m = mix(name)
    lengths = generator.lengths_of(m)
    order = list(range(len(lengths)))
    if m["job"] == "train":
        random.Random(m["shuffle_seed"]).shuffle(order)
    return generator.bucket_histogram(lengths[order], m["batch_size"],
                                      BUCKETS)


def test_bucket_histograms():
    assert histogram("tacred.train") == {64: 26, 96: 952, 128: 385}
    assert histogram("short.train") == {32: 1363}
    assert histogram("tacred.eval") == {64: 15, 96: 300, 128: 138}


@pytest.mark.parametrize("name", ["tacred.train", "short.train"])
def test_checked_steps_cover_every_bucket(name):
    """The first ``CHECKED_STEPS`` batches a training mix's shuffle gives
    hold every length bucket its epoch fills: each graph the window
    replays is held to the reference."""
    from portbench.jobs import CHECKED_STEPS

    m = mix(name)
    lengths = generator.lengths_of(m)
    order = list(range(len(lengths)))
    random.Random(m["shuffle_seed"]).shuffle(order)
    rows = m["batch_size"]
    first = generator.bucket_histogram(
        lengths[order[:CHECKED_STEPS * rows]], rows, BUCKETS)
    assert set(first) == set(histogram(name))
