"""The plain reference against the program on the CPU, at the cells'
widths on a hundred sentences: the cells' whole runs (set-up, window,
check) come out correct, the reference's tables and pruning are the
program's, and the reference imports nothing of the program."""

import ast
import os
import time

import numpy as np
import pytest

from portbench import generator, run
from portbench.reference import prune, tacred_ids

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = ("cgcn.train.tacred", "gcn.train.tacred", "cgcn.eval.tacred")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_cpu(cell):
    result, facts = run.run_cell(cell, 2**31 + 77, 0.2, False,
                                 device="cpu", t0=time.perf_counter(),
                                 sentences=100)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    for name, c in result["checks"].items():
        assert c["value"] < c["limit"] / 10, (name, c)
    assert list(result)[-1] == "checks"


def test_tables_are_the_programs():
    from gcn_tpu_torch import constants

    assert tacred_ids.POS_TO_ID == constants.POS_TO_ID
    assert tacred_ids.NER_TO_ID == constants.NER_TO_ID
    assert tacred_ids.LABEL_TO_ID == constants.LABEL_TO_ID
    for name, i in tacred_ids.DEPREL_TO_ID.items():
        assert constants.DEPREL_TO_ID[name] == i
    assert tacred_ids.SELF_LOOP_INDEX == constants.SELF_LOOP_INDEX
    assert tacred_ids.DEPREL_FORWARD_BOUND == constants.DEPREL_FORWARD_BOUND


@pytest.mark.parametrize("k", [0, 1, 2])
def test_pruning_is_the_programs(k):
    from gcn_tpu_torch.data.dataset import get_positions
    from gcn_tpu_torch.graph.prune import prune_graph

    import json
    with open(os.path.join(HERE, "traffic", "tacred.train.json")) as f:
        mix = json.load(f)
    for r in generator.make_records(mix, 11 + k, 53954, sentences=300):
        n = len(r["token"])
        head = np.asarray(r["stanford_head"])
        sp = np.asarray(get_positions(r["subj_start"], r["subj_end"], n))
        op = np.asarray(get_positions(r["obj_start"], r["obj_end"], n))
        g = prune_graph(head, np.zeros(n, np.int64), n, k, sp, op)
        parents, children = prune.prune(
            list(head), list(range(r["subj_start"], r["subj_end"] + 1)),
            list(range(r["obj_start"], r["obj_end"] + 1)), k)
        assert sorted(zip(parents, children)) == sorted(
            zip(g.edge_parent.tolist(), g.edge_child.tolist()))


def test_reference_imports_nothing_of_the_program():
    folder = os.path.join(HERE, "reference")
    for name in os.listdir(folder):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(folder, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""]
                    if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                top = m.split(".")[0]
                assert top in ("numpy", "torch", "math", "random",
                               "dataclasses", "__future__", "portbench"), (
                    name, m)
                if top == "portbench":
                    assert m.startswith("portbench.reference"), (name, m)
