"""Tracing and profiling helpers (the JAX package's ``runtime/profiling.py``):
``RenderStats``, the record ``Renderer.render_radiance(with_stats=True)``
returns, with the exact path-vertex count the integrators keep, the unit of
the Mrays/s metric; ``device_trace``, a ``torch.profiler`` trace around a
render, written as a Chrome trace; ``span`` and ``count``, the program's own
spans and counters.

A ``span`` brackets one phase of the host's work at a layer boundary
(``rt.frame``, ``rt.batch.prep``, ``rt.loop.wait``, ``rt.setup.bvh``, ...).
While a ``torch.profiler`` records, it is also a record in the trace, on
the clock of the card's records, so a gap in the card's work lies against
the phase the host was in. Always, it adds one to its count and its host
seconds to ``SPANS``, the one table of spans and counters (``count`` adds
to a counter there: ``rt.lane_slots``, ``rt.path_vertices``), which
``span_totals`` reads. With no profiler recording a span costs one check,
two clock reads and a locked update of the table.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time

import torch

# {name: [count, seconds]}: each span's calls and host seconds, each
# counter's sum (seconds 0); shards render from threads, hence the lock
SPANS: dict = {}
_SPANS_LOCK = threading.Lock()
_profiling = torch.autograd._profiler_enabled
# a record without the Python dispatcher's cost
_FAST = torch._C._profiler._RecordFunctionFast


def _add(name: str, n, seconds: float) -> None:
    with _SPANS_LOCK:
        row = SPANS.get(name)
        if row is None:
            SPANS[name] = [n, seconds]
        else:
            row[0] += n
            row[1] += seconds


class span:
    """``with span("rt.frame", frame=i):`` brackets one phase: a record in
    the profiler's trace while one records (``frame`` in its args, where
    the profiler records shapes: the spans of one frame, and of every
    shard of it, share it), and one call and its host seconds added to
    ``SPANS`` always."""

    __slots__ = ("name", "frame", "rec", "t0")

    def __init__(self, name: str, frame=None):
        self.name, self.frame, self.rec = name, frame, None

    def __enter__(self):
        if _profiling():
            self.rec = _FAST(self.name) if self.frame is None else _FAST(
                self.name, [], {"frame": self.frame})
            self.rec.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.rec is not None:
            self.rec.__exit__(*exc)
            self.rec = None
        _add(self.name, 1, dt)
        return False


def count(name: str, n) -> None:
    """Adds ``n`` to the counter ``name`` of ``SPANS``."""
    _add(name, n, 0.0)


def span_totals() -> dict:
    """A copy of ``SPANS``: {name: [count, seconds]}."""
    with _SPANS_LOCK:
        return {k: list(v) for k, v in SPANS.items()}


def reset_spans() -> None:
    with _SPANS_LOCK:
        SPANS.clear()


@dataclasses.dataclass
class RenderStats:
    width: int
    height: int
    samples: int
    ray_depth: int
    wall_seconds: float
    path_vertices: float  # exact count from the instrumented bounce loop
    primary_rays: int

    @property
    def mrays_per_sec(self) -> float:
        return self.path_vertices / self.wall_seconds / 1e6

    @property
    def avg_path_length(self) -> float:
        return self.path_vertices / max(self.primary_rays, 1)

    def __str__(self) -> str:
        return (
            f"{self.width}x{self.height} @ {self.samples} spp depth "
            f"{self.ray_depth}: {self.wall_seconds:.2f}s, "
            f"{self.path_vertices / 1e6:.1f}M path vertices "
            f"({self.mrays_per_sec:.1f} Mrays/s, avg depth "
            f"{self.avg_path_length:.2f})"
        )


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace what runs inside the block with ``torch.profiler`` (the CPU
    ops, and the kernels on the card when one is present) and write it as a
    Chrome trace, ``log_dir/trace.json``, on exit. Usage: ``with
    device_trace('/tmp/trace'): renderer.render_u8()``. Yields the profiler
    (``key_averages()`` sums by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # every kernel of the block ends inside the trace
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
