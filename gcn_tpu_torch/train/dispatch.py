"""How a step reaches the card: CUDA graphs captured per batch shape and
dispatch size, replayed from one host call.

The port's counterpart of gcn_tpu's jitted programs (``_fused_step``,
``_chunk_step``, ``_forward_eval``, ``_forward_eval_chunk``, and for
``update_gap > 1`` ``_loss_and_grads`` with ``_accum_add``, and
``_apply_grads``): where JAX compiles a program per shape and a
``lax.scan`` over k steps, the port captures a CUDA graph per (batch
signature, k), k steps unrolled in it, and replays it; an accumulating
micro-batch is a graph per batch signature of its own kind, and the
optimizer step on the sums one graph that takes no batch.

* ``GraphCache`` keeps a consumer's graphs by batch signature and
  dispatch size (``train.transfer.Staging.signature``), prefixed by a
  ``kind`` where one batch shape has graphs of two functions, one memory
  pool for all of them, and moves each dispatch's batches into its
  graph's static inputs before the replay.  Tensors that outlive a
  replay and are not its outputs (a trainer's gradient sums) are
  allocated outside the pool.
* ``capture`` runs the function once eagerly on a side stream (cuBLAS,
  autograd and the allocator set themselves up there), puts back the
  tensors it names as state (parameters, optimizer state), then captures
  it into a graph whose memory comes from ``pool``.  Each step slot of a
  graph draws its dropout from a ``torch.Generator`` registered with the
  graph; ``StepGraph.replay`` reseeds them first, so a replayed step draws
  what a fresh generator of that seed draws in an eager step.  A capture
  that fails raises: nothing falls back to the eager step.
* ``graphs_on`` decides from the device, the model's config and the
  backend of the step's collectives, before any capture: a model whose
  step reads the host (``GCNClassifier.capturable`` false: the plain
  grouped matmul of ``deprel_factored="ragged"``) runs eagerly on the
  card too, and so does a data-parallel step over gloo, whose
  collectives a graph cannot hold (NCCL's it can: they are captured into
  the step's graph).
* Launch counts: the launches made while a graph is captured are added to
  the kernels' counts at each replay (``ops._cuda.count_replay``); those
  of the eager warm-up call are not counted.
* Spans (``train.profiling.annotate``): ``gcn.dispatch.replay`` around
  a replay (reseeding, ``graph.replay()``, the launch counts),
  ``gcn.dispatch.capture`` around a capture; ``GraphCache.captures``
  counts the graphs a cache has captured.
* ``eager_dispatch()`` (the counterpart of ``jax.disable_jit()``) makes
  the card run its steps eagerly, launch by launch, as the CPU always
  does: tests hold graphs against eager steps with it.
* ``allowed_chunk_sizes`` and ``chunk_plan`` bound the set of dispatch
  sizes, as in gcn_tpu: a run of k same-shape batches goes out in pieces
  of ``cap`` and powers of two below it, step order unchanged.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch

from gcn_tpu_torch.ops import _cuda
from gcn_tpu_torch.train.profiling import annotate

_EAGER = [0]  # depth of open eager_dispatch() blocks


@contextlib.contextmanager
def eager_dispatch():
    """Inside the block, the card runs train steps and evaluation
    forwards eagerly instead of replaying graphs."""
    _EAGER[0] += 1
    try:
        yield
    finally:
        _EAGER[0] -= 1


def graphs_on(device: torch.device, model, backend=None) -> bool:
    """Whether ``model``'s steps and forwards on ``device`` go through
    CUDA graphs here: on the card, outside ``eager_dispatch()``, for a
    model a graph can hold, with no collectives (``backend`` None) or
    NCCL's."""
    return (device.type == "cuda" and _EAGER[0] == 0 and model.capturable
            and backend in (None, "nccl"))


def allowed_chunk_sizes(cap: int) -> list[int]:
    """The dispatch sizes the chunked paths may capture: ``cap`` and every
    power of two below it, descending (a bounded set per batch shape)."""
    cap = max(1, int(cap))
    sizes = {cap} | {1 << j for j in range(cap.bit_length())
                     if (1 << j) <= cap}
    return sorted(sizes, reverse=True)


def chunk_plan(k: int, cap: int) -> list[int]:
    """Greedy split of a k-batch run into allowed dispatch sizes (k=7,
    cap=8 → [4, 2, 1]), step order unchanged."""
    plan = []
    for s in allowed_chunk_sizes(cap):
        while k >= s:
            plan.append(s)
            k -= s
    return plan


class StepGraph:
    """A captured graph: its static inputs, its outputs (overwritten by
    every replay), its step slots' generators and the launches it
    makes."""

    def __init__(self, graph, static, outputs, generators, launches):
        self.graph = graph
        self.static = static
        self.outputs = outputs
        self.generators = generators
        self.launches = launches

    def replay(self, seeds: Sequence[int] = ()) -> None:
        """Reseed the step slots' generators with ``seeds`` and replay."""
        if len(seeds) != len(self.generators):
            raise ValueError(f"{len(seeds)} seeds for "
                             f"{len(self.generators)} step slots")
        with annotate("gcn.dispatch.replay"):
            for gen, seed in zip(self.generators, seeds):
                gen.manual_seed(seed)
            self.graph.replay()
            _cuda.count_replay(self.launches)


def capture(fn: Callable, static, device: torch.device, pool,
            slots: int = 0, state: Sequence[torch.Tensor] = ()
            ) -> StepGraph:
    """Capture ``fn(static, generators)`` (which returns its outputs) into
    a graph with ``slots`` step generators, after one eager warm-up call
    on a side stream; the ``state`` tensors are the same after as
    before."""
    generators = [torch.Generator(device=device) for _ in range(slots)]
    saved = [t.detach().clone() for t in state]
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side), _cuda.tally_launches():
        fn(static, generators)  # its launches are not counted
    current.wait_stream(side)
    with torch.no_grad():
        for t, s in zip(state, saved):
            t.copy_(s)
    del saved  # back to the allocator before the capture empties its cache
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device):
        for gen in generators:
            graph.register_generator_state(gen)
    with _cuda.tally_launches() as launches:
        with torch.cuda.graph(graph, pool=pool):
            outputs = fn(static, generators)
    return StepGraph(graph, static, outputs, generators, launches)


class GraphCache:
    """The graphs of one consumer (a trainer's steps, an evaluator's
    forwards) by the signature of the batches they take, in one memory
    pool.  ``staging`` moves the batches to the card; ``captures`` counts
    the graphs captured."""

    def __init__(self, staging, device: torch.device):
        self.staging = staging
        self.device = device
        self.graphs: dict = {}
        self.captures = 0
        self._pool = None

    def get(self, batches: list, fn: Callable, slots: int = 0,
            state: Sequence[torch.Tensor] = (), kind: str | None = None
            ) -> tuple[StepGraph, bool]:
        """(the graph of ``fn`` for ``batches``' signature, ``kind``
        before it where given, whether it was captured now, with
        ``batches`` in its static inputs; no batches: no static
        inputs)."""
        key = self.staging.signature(batches) if batches else ()
        if kind is not None:
            key = (kind, *key)
        graph = self.graphs.get(key)
        if graph is not None:
            return graph, False
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        static = None
        if batches:
            static = self.staging.allocate(batches)
            self.staging.send(batches, static)
        with annotate("gcn.dispatch.capture"):
            graph = capture(fn, static, self.device, self._pool, slots,
                            state)
        self.graphs[key] = graph
        self.captures += 1
        return graph, True

    def replay(self, batches: list, fn: Callable, seeds: Sequence[int] = (),
               state: Sequence[torch.Tensor] = (), kind: str | None = None):
        """Move ``batches`` in and replay their graph (captured first if
        new), its step slots seeded with ``seeds``; the graph's outputs,
        valid until its next replay."""
        graph, loaded = self.get(batches, fn, len(seeds), state, kind)
        if not loaded and batches:
            self.staging.send(batches, graph.static)
        graph.replay(seeds)
        return graph.outputs
