"""How a step reaches the card: CUDA graphs captured per batch shape and
dispatch size, replayed from one host call.

The port's counterpart of gcn_tpu's jitted programs (``_fused_step``,
``_chunk_step``, ``_forward_eval``, ``_forward_eval_chunk``): where JAX
compiles a program per shape and a ``lax.scan`` over k steps, the port
captures a CUDA graph per (batch signature, k), k steps unrolled in it,
and replays it.

* ``GraphCache`` keeps a consumer's graphs by batch signature and
  dispatch size (``train.transfer.Staging.signature``), one memory pool
  for all of them, and moves each dispatch's batches into its graph's
  static inputs before the replay.
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
    pool.  ``staging`` moves the batches to the card."""

    def __init__(self, staging, device: torch.device):
        self.staging = staging
        self.device = device
        self.graphs: dict = {}
        self._pool = None

    def get(self, batches: list, fn: Callable, slots: int = 0,
            state: Sequence[torch.Tensor] = ()) -> tuple[StepGraph, bool]:
        """(the graph of ``fn`` for ``batches``' signature, whether it was
        captured now, with ``batches`` in its static inputs)."""
        key = self.staging.signature(batches)
        graph = self.graphs.get(key)
        if graph is not None:
            return graph, False
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        static = self.staging.allocate(batches)
        self.staging.send(batches, static)
        graph = capture(fn, static, self.device, self._pool, slots, state)
        self.graphs[key] = graph
        return graph, True

    def replay(self, batches: list, fn: Callable, seeds: Sequence[int] = (),
               state: Sequence[torch.Tensor] = ()):
        """Move ``batches`` in and replay their graph (captured first if
        new), its step slots seeded with ``seeds``; the graph's outputs,
        valid until its next replay."""
        graph, loaded = self.get(batches, fn, len(seeds), state)
        if not loaded:
            self.staging.send(batches, graph.static)
        graph.replay(seeds)
        return graph.outputs
