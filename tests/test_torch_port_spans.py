"""The port's spans and counters, on the CPU.

* ``train.profiling.annotate`` gives one shared no-op context while no
  profiler records, and a named ``record_function`` range while one does;
* the eager ``Evaluator.evaluate`` spans each dispatch and each unpack,
  ``Trainer.update`` each step, and the losses' wait holds their fetch
  alone;
* on the card's dispatch path (replayed eagerly on the CPU) a step's
  ``gcn.train.update`` holds its staging and its replay, an evaluation
  dispatch likewise, and the host's waits are spans of their own;
* ``GraphCache.captures`` counts captures (none after the warm-up), and
  ``ops._cuda.BUILDS`` counts the libraries compiled, not those loaded.
"""

import collections

import pytest
import torch

from gcn_tpu_torch.graph import native
from gcn_tpu_torch.ops import _cuda
from gcn_tpu_torch.train import profiling
from gcn_tpu_torch.train.evaluator import Evaluator
from gcn_tpu_torch.train.profiling import annotate
from gcn_tpu_torch.train.trainer import Trainer
from tests.test_torch_port_dispatch import (  # noqa: F401
    card_path_on_the_cpu,
    same_shape_batches,
)
from tests.test_torch_port_model import _configs


def profiled(body, prefix: str = "gcn."):
    """(the ``gcn.*`` names the profiler saw, in order of their start;
    every host event whose name starts with ``prefix`` as (name, thread,
    start, end)) of ``body()``."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        body()
    events = sorted(prof.events(), key=lambda e: e.time_range.start)
    names = [e.name for e in events if e.name.startswith("gcn.")]
    spans = [(e.name, e.thread, e.time_range.start, e.time_range.end)
             for e in events if e.name.startswith(prefix)]
    return names, spans


def inside(spans, outer: str, inner: str) -> list[int]:
    """For each ``outer`` span, how many ``inner`` spans of its thread lie
    within it."""
    return [sum(1 for n, t, a, b in spans
                if n == inner and t == tid and s <= a and b <= e)
            for name, tid, s, e in spans if name == outer]


def test_annotate_is_one_shared_no_op_without_a_profiler():
    first = annotate("gcn.train.update")
    assert first is annotate("gcn.stage.wait") is profiling._OFF
    with first:
        with annotate("gcn.stage.pack") as inner:
            assert inner is None


def test_annotate_records_a_named_range_under_a_profiler():
    def body():
        with annotate("gcn.outer"):
            with annotate("gcn.outer.wait"):
                torch.ones(4).sum()

    names, spans = profiled(body)
    assert names == ["gcn.outer", "gcn.outer.wait"]
    (o, ot, oa, ob), (w, wt, wa, wb) = spans
    assert wt == ot and oa <= wa <= wb <= ob
    assert inside(spans, "gcn.outer", "gcn.outer.wait") == [1]
    assert annotate("gcn.after") is profiling._OFF


def test_eager_evaluate_and_update_span_each_dispatch():
    _, tcfg = _configs()
    batches = same_shape_batches(tcfg, 3)
    trainer = Trainer(tcfg, device="cpu")
    ev = Evaluator.for_model(tcfg, trainer.model)
    names, spans = profiled(lambda: ev.evaluate(batches))
    counts = collections.Counter(names)
    assert counts == {"gcn.eval.dispatch": 3, "gcn.eval.unpack": 3,
                      "gcn.eval.wait": 1}  # the losses' fetch
    assert collections.Counter(s[0] for s in spans) == counts
    names, spans = profiled(lambda: [trainer.update(b) for b in batches])
    assert names == ["gcn.train.update"] * 3
    assert len(spans) == 3


@pytest.mark.parametrize("offsize", [False, True])
def test_the_losses_wait_holds_their_fetch_alone(offsize):
    """The evaluation's last ``gcn.eval.wait`` holds the fetch of the
    losses' sum, not the reduction that makes it: a wait span times the
    host blocked on the card, not host work.  Batches of another size
    than ``batch_size`` weigh each batch by its valid rows (a dot)."""
    _, tcfg = _configs(**({"train.batch_size": 4} if offsize else {}))
    batches = same_shape_batches(tcfg, 2)
    assert (len(batches[0]["example_mask"]) != tcfg.train.batch_size) \
        == offsize
    ev = Evaluator.for_model(tcfg, Trainer(tcfg, device="cpu").model)
    _, spans = profiled(lambda: ev.evaluate(batches), prefix="")
    reduction = "aten::dot" if offsize else "aten::sum"
    assert any(s[0] == reduction for s in spans)
    assert inside(spans, "gcn.eval.wait", reduction) == [0]
    assert inside(spans, "gcn.eval.wait", "aten::item") == [1]


@pytest.mark.parametrize("fmt", ["compact", "fields"])
def test_card_path_spans_hold_staging_and_replay(card_path_on_the_cpu, fmt):
    """Through the card's dispatch path: one ``gcn.train.update`` a
    dispatch (two single steps, then a chunk of 4 as one replay where the
    batches pack), each holding one ``gcn.stage.pack`` and one
    ``gcn.dispatch.replay``; no capture after the warm-up; an evaluation
    dispatch holds its staging and replay, each dispatch is waited for
    and unpacked once, and the losses' fetch is one more wait."""
    ov = {"train.steps_per_dispatch": 4, "train.effective_batch_size": 8,
          "train.pack_transfers": fmt != "fields"}
    _, tcfg = _configs(**ov)
    batches = same_shape_batches(tcfg, 6)
    trainer = Trainer(tcfg, device="cpu")
    trainer.warmup(batches[:1])
    captured = trainer._graphs.captures
    assert captured == len(trainer.graphs) == (1 if fmt == "fields" else 3)

    def steps():
        trainer.update(batches[0])
        trainer.update(batches[1])
        trainer.update_chunk(batches[2:])

    names, spans = profiled(steps)
    updates = 3 if fmt == "compact" else 6
    assert names.count("gcn.train.update") == updates
    assert inside(spans, "gcn.train.update", "gcn.stage.pack") == \
        [1] * updates
    assert inside(spans, "gcn.train.update", "gcn.dispatch.replay") == \
        [1] * updates
    assert "gcn.dispatch.capture" not in names
    assert trainer._graphs.captures == captured
    ev = trainer._evaluator
    names, spans = profiled(lambda: ev.evaluate(batches))
    dispatches = 2 if fmt == "compact" else 6  # chunks of 4 + 2, or 1s
    counts = collections.Counter(names)
    assert counts["gcn.eval.dispatch"] == counts["gcn.eval.unpack"] == \
        dispatches
    assert counts["gcn.eval.wait"] == dispatches + 1
    assert inside(spans, "gcn.eval.dispatch", "gcn.stage.pack") == \
        inside(spans, "gcn.eval.dispatch", "gcn.dispatch.replay") == \
        [1] * dispatches
    # the warm-up captured the evaluation graphs of the train shapes too
    assert "gcn.dispatch.capture" not in counts
    assert ev._graphs.captures == len(ev.graphs) > 0


def test_builds_count_compiled_libraries_not_loaded_ones(tmp_path):
    lib = native.host_library(build_dir=tmp_path / "build")
    before = dict(_cuda.BUILDS)
    _cuda.build_all([lib])
    assert _cuda.BUILDS["libraries"] == before["libraries"] + 1
    assert _cuda.BUILDS["seconds"] > before["seconds"]
    built = dict(_cuda.BUILDS)
    native.open_library(lib)  # found in the build directory: loaded
    _cuda.build_all([lib])
    assert _cuda.BUILDS == built
