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
* the lane engines, on either route: the counter wavefront's refill and
  bounce (``integrator/wavefront.py:RefillBody``, ``CoreBody``: K1 in lane
  mode or the XLA core), each replayed when a round runs it, and the
  sticky engine's whole round off the K5 route (``StickyBody``), replayed
  once per round.

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
so a graphed frame counts what an eager one does. A failure to capture or
to replay raises; nothing falls back to eager.

The sticky engine's K5 loop (one launch per round, its counts read one
round late) and ``plain`` renders stay eager, and so does the CPU.
"""

from __future__ import annotations

import threading
import time

import torch

from ..ops import kernels

# captures one at a time in a process: torch.cuda.graph empties the
# allocator's cache of every card on entry
_CAPTURE_LOCK = threading.Lock()


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
        with kernels.recording() as launches:
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
    first call's warm-up or by a replay."""

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
                self._replay, self.launches, self.stats = self._capture(self.body, self.device)
                return
            self._replay()
            kernels.add_launches(self.launches)
            self.replays += 1


class GraphCache:
    """The captured bodies of one device scene, one per key. The key holds
    what fixes a body's launches and buffers: the engine, the route, the
    lane count, the ``TraceConfig`` and the frame (size and camera; for the
    sticky round and the counter refill also the pixels and samples of a
    shard or pass). Values read on the device
    (seed, sample offset, ``samp_base``, ``pix_base``, the lanes' work ids)
    are not in it. ``capture_fn`` replaces ``capture`` (the tests stub it
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
