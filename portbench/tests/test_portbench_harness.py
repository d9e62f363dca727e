"""The harness: ``BENCHMARK.json`` within its format's limits, every
configuration, mix and per-layer metric found by name in a file of its
own (a new file adds an entry and edits none), the import check by whole
top-level names, and ``run.py`` failing rather than falling back where
there is no card."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import harness

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keeps_its_formats_limits():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    pairs = set()
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        reported = [m for m in b["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2
        assert any(w["name"] in m["workloads"] for m in b["per_layer"])
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
    for c in b["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("portbench/")
    assert len(json.dumps(b)) < 64 * 1024


def test_every_entry_is_found_by_name():
    b = bench()
    for w in b["workloads"]:
        cell = harness.find_cell(w["name"])
        assert cell.traffic["job"] in ("train", "eval")
        assert cell.config["preset"] in ("cgcn_preset", "gcn_preset")
        assert cell.traffic["job"] in cell.config["limits"]
    for m in b["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_a_new_file_adds_an_entry_without_editing_any(tmp_path,
                                                      monkeypatch):
    root = tmp_path / "checkout"
    shutil.copytree(PB, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    (root / "portbench" / "traffic" / "tiny.train.json").write_text(
        json.dumps({**json.loads(
            (root / "portbench" / "traffic" / "short.train.json")
            .read_text()), "sentences": 60}))
    (root / "portbench" / "metrics" / "sentences.train.py").write_text(
        "def read(run):\n    return run['window']['sentences']\n")
    b["workloads"].append({"name": "cgcn.train.tiny", "config": "cgcn",
                           "traffic": "tiny.train", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "sentences.train", "unit": "sentences",
                           "better": "higher", "source": "host_clock",
                           "layer": "data", "moves": "train_sentences_per_s",
                           "workloads": ["cgcn.train.tiny"]})
    for m in b["end_to_end"]:
        if "workloads" in m and "cgcn.train.tacred" in m["workloads"]:
            m["workloads"].append("cgcn.train.tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    monkeypatch.setattr(harness, "ROOT", str(root))
    monkeypatch.setattr(harness, "HERE", str(root / "portbench"))
    cell = harness.find_cell("cgcn.train.tiny")
    assert cell.traffic["sentences"] == 60
    assert [m["name"] for m in cell.per_layer] == ["sentences.train"]
    assert harness.reader("sentences.train")(
        {"window": {"sentences": 7}}) == 7


def test_imports_are_compared_by_whole_top_level_names(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "gcn_tpu_torch_lookalike",
                        types.ModuleType("gcn_tpu_torch_lookalike"))
    import gcn_tpu_torch  # noqa: F401

    assert "gcn_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gcn_tpu.sub",
                        types.ModuleType("gcn_tpu.sub"))
    assert "gcn_tpu" in harness.forbidden_modules()


def test_nothing_the_benchmark_runs_imports_jax():
    """No module under portbench/ names jax, jaxlib, flax, gcn_tpu, the
    root bench.py or tools/ as an import; and a CPU process that runs a
    cell and the reference loads none of them."""
    bad = {"jax", "jaxlib", "flax", "gcn_tpu", "bench", "tools"}
    for dirpath, _, files in os.walk(PB):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(dirpath, name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    tops = [a.name.split(".")[0] for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    tops = [(node.module or "").split(".")[0]]
                else:
                    continue
                assert not set(tops) & bad, (name, tops)
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "from portbench import run, harness\n"
            "run.run_cell('cgcn.eval.tacred', 3, 0.1, False, device='cpu',"
            " t0=time.perf_counter(), sentences=60)\n"
            "print(harness.forbidden_modules())\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("where", ["repo", "bare"])
def test_run_fails_without_a_card_or_the_program(where, tmp_path):
    if where == "repo":
        cwd = ROOT
    else:  # only BENCHMARK.json and the benchmark's files
        cwd = tmp_path
        shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), cwd)
        shutil.copytree(PB, cwd / "portbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "cgcn.train.tacred", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "portbench:" in out.stderr
