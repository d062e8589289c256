"""Captured CUDA graphs of the render loop's bodies: the port's counterpart
of the JAX package's compiled frame (``runtime/render.py:_render_batch``
and ``_render_wf``, each one ``jax.jit``).

PyTorch launches every element-wise op of the modular bounce from Python:
about a thousand launches per depth level of a BVH frame, and the host,
not the card, sets the frame's pace. A CUDA graph records one body's
launches once and replays them with one call. The integrators hand a body
to a ``GraphCache``:

* the batch engine, on either route: one sample of one batch
  (``integrator/path.py:SampleBody``: K2, K1 per level and K1-final on the
  fused route; the modular bounce with K4 or K6 and K3 on the other),
  replayed once per sample of every batch, for every seed, sample offset,
  shard and checkpoint chunk;
* the lane engines, on either route: a lane frame's loop
  (``integrator/wavefront.py``: ``WavefrontLoop``, ``StickyLoop``,
  ``FusedStickyLoop``), ``ROUNDS_PER_REPLAY`` rounds a replay, each round
  inside an IF node on the device round test's ``more`` and the counter
  wavefront's refill inside a second one on ``refill_pred`` (``guard``):
  the counterpart of the JAX ``lax.while_loop`` and ``lax.cond``. A round
  the test has stopped costs its conditional check; the host reads the
  loop's counters once per replay, one replay late.

A body is a call without arguments over static tensors it owns: the caller
writes the inputs in place (the seed and the sample or work-id offsets
are device scalars, so a new value is not a new capture), calls, and reads
the outputs before the next call overwrites them. The first call of an
entry does the body's work for real on a side stream (the warm-up: the
kernel library is loaded, the stream's tile tickets and the allocator's
blocks exist), then captures it on that stream into a private memory pool
(``capture_error_mode="thread_local"``: shards render from threads). Every
later call replays. The kernel launches counted while capturing are
recorded per entry and added to ``ops/kernels.py:LAUNCHES`` at each replay,
so a graphed frame counts what an eager one does; the launches of a
guarded body are recorded per run of the body and added by its caller
times the runs that its device counters report (``settle``), so a skipped
body counts nothing. A failure to capture or to replay raises; nothing
falls back to eager, and nothing falls back to a host read per round.

The card's PyTorch (2.11) has no binding of IF nodes; ``_if_node`` adds
them through ``csrc/loop.cu`` (``rt_if_begin``, ``rt_if_end``) as PyTorch's
own ``CUDAGraph::begin_capture_to_if_node`` does in later releases. Without
a capture (``eager=True``, ``plain`` and the CPU) a guard reads its
predicate on the host.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

from ..ops import kernels
from .profiling import span

# captures one at a time in a process: torch.cuda.graph empties the
# allocator's cache of every card on entry
_CAPTURE_LOCK = threading.Lock()
# the capture under way in this thread (``capture``): .pools (the allocator
# pool of each depth of IF-node bodies), .depth (IF nodes open)
_CAPTURE = threading.local()
# per device, one stream per depth of IF-node bodies (kernels.new_stream)
_CHILD_STREAMS: dict = {}


def _child_stream(device: torch.device, depth: int):
    """The stream of IF-node bodies at ``depth`` on ``device`` (called under
    ``_CAPTURE_LOCK``)."""
    streams = _CHILD_STREAMS.setdefault(device, [])
    while len(streams) <= depth:
        streams.append(kernels.new_stream(device))
    return streams[depth]


@contextlib.contextmanager
def _if_node(pred: torch.Tensor):
    """Captures the block into the body of an IF node on ``pred`` (a 0-dim
    bool on the device): the node is added to the graph that the current
    stream captures, and the block is captured on a stream of its own into
    the node's body, its allocations routed to a private pool of the
    capture (one per depth: the allocator closes the first routing of a pool
    it finds). The card's PyTorch has no binding of IF nodes;
    ``csrc/loop.cu:rt_if_begin`` takes the steps of PyTorch's own
    ``CUDAGraph::begin_capture_to_if_node``."""
    cap = _CAPTURE
    dev = pred.device
    depth = cap.depth
    while len(cap.pools) <= depth:
        cap.pools.append(torch.cuda.graph_pool_handle())
    pool = cap.pools[depth]
    child = _child_stream(dev, depth)
    kernels.if_begin(torch.cuda.current_stream(dev), pred, child)
    cap.depth += 1
    try:
        with torch.cuda.stream(child):
            torch._C._cuda_beginAllocateCurrentStreamToPool(dev.index, pool)
            try:
                yield
            finally:
                torch._C._cuda_endAllocateToPool(dev.index, pool)
    finally:
        cap.depth -= 1
        kernels.if_end(child)


def guard(pred: torch.Tensor, fn, tag: str, sections: dict) -> None:
    """Runs ``fn`` where ``pred``, a 0-dim bool on the device, is true: under
    a capture as an IF node (``fn`` captured into its body, which a replay
    runs only when it finds ``pred`` true), else after a host read of
    ``pred`` (eager, ``plain`` and the CPU: the counterpart of
    ``jax.disable_jit()``). ``fn``'s kernel launches are recorded into
    ``sections[tag]`` (one run's) and not counted: a body's run is known to
    the device, so the caller adds them times the runs its device counters
    report (``settle``). Nested guards record their own."""
    capturing = pred.device.type == "cuda" and torch.cuda.is_current_stream_capturing()
    if not capturing and not bool(pred):
        return
    with kernels.recording() as rec:
        if capturing:
            with _if_node(pred):
                fn()
        else:
            fn()
    sections[tag] = dict(rec)


def settle(sections: dict, runs: dict) -> None:
    """Adds to ``ops/kernels.py:LAUNCHES`` the launches of each guarded
    body (``sections``, from ``guard``) times its runs."""
    kernels.add_launches({k: n * runs[tag] for tag, launches in sections.items()
                          for k, n in launches.items()})


def capture(body, device: torch.device):
    """Runs ``body`` once for real on a side stream, then captures it there.
    Returns ``(replay, launches, stats)``: the graph's replay (on the
    current stream), the kernel launches of one replay, and ``capture_ms``
    (host ms of the capture and instantiation, warm-up excluded) and
    ``pool_mb`` (the device memory the capture reserved)."""
    with _CAPTURE_LOCK, torch.cuda.device(device):
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)  # the inputs were written on ``cur``
        kernels.prepare_stream(device, side)
        with torch.cuda.stream(side):
            body()
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        _CAPTURE.pools, _CAPTURE.depth = [], 0
        with kernels.recording() as launches, kernels.capture_tickets(side):
            with torch.cuda.graph(graph, pool=torch.cuda.graph_pool_handle(), stream=side,
                                  capture_error_mode="thread_local"):
                body()
        torch.cuda.synchronize(device)
        stats = {"capture_ms": (time.perf_counter() - t0) * 1e3,
                 "pool_mb": (torch.cuda.memory_reserved(device) - reserved) / 2**20}
        cur.wait_stream(side)
    return graph.replay, dict(launches), stats


class Graphed:
    """A body and its graph: calling it does the body's work once, by the
    first call's warm-up or by a replay. The first call is the span
    ``rt.graph.capture``; a replay has none (the trace's
    ``cudaGraphLaunch`` is its record, ``replays`` its count)."""

    def __init__(self, body, device: torch.device, capture_fn=capture):
        self.body, self.device = body, device
        self._capture = capture_fn
        self._replay = None
        self.launches: dict = {}
        self.stats: dict = {}
        self.replays = 0
        self._lock = threading.Lock()

    def __call__(self) -> None:
        with self._lock:
            if self._replay is None:
                with span("rt.graph.capture"):  # the warm-up and the capture
                    self._replay, self.launches, self.stats = self._capture(self.body,
                                                                            self.device)
                return
            self._replay()
            kernels.add_launches(self.launches)
            self.replays += 1


class GraphCache:
    """The captured bodies of one device scene, one per key. The key holds
    what fixes a body's launches and buffers: the engine, the route, the
    lane count, the ``TraceConfig`` and the frame (size and camera; for the
    lane loops also the pixels and samples of a shard or pass and the rounds
    per replay, and the counter wavefront's refill threshold). Values read
    on the device (seed, sample offset, ``samp_base``, ``pix_base``, the
    lanes' work ids) are not in it. ``capture_fn`` replaces ``capture`` (the tests stub it
    on the CPU). A cache serves one thread at a time: ``parallel/shard.py``
    gives each device its own thread and its own scene."""

    def __init__(self, scene, device, capture_fn=capture):
        self.scene, self.device = scene, torch.device(device)
        self._capture = capture_fn
        self.entries: dict = {}

    def get(self, scene, key, make) -> Graphed:
        """The entry of ``key``, made from ``make()`` (a body) on first use."""
        if scene is not self.scene:
            raise ValueError("a graph cache serves the device scene it was made for")
        entry = self.entries.get(key)
        if entry is None:
            entry = self.entries[key] = Graphed(make(), self.device, self._capture)
        return entry

    def stats(self) -> dict:
        """Entries, capture ms and pool MB summed, replays."""
        es = list(self.entries.values())
        return {"entries": len(es),
                "capture_ms": sum(e.stats.get("capture_ms", 0.0) for e in es),
                "pool_mb": sum(e.stats.get("pool_mb", 0.0) for e in es),
                "replays": sum(e.replays for e in es)}
