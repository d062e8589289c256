"""Tracing and profiling helpers (the JAX package's ``runtime/profiling.py``):
``RenderStats``, the record ``Renderer.render_radiance(with_stats=True)``
returns, with the exact path-vertex count the integrators keep, the unit of
the Mrays/s metric; ``device_trace``, a ``torch.profiler`` trace around a
render, written as a Chrome trace; ``wall_timer``."""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch


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


@contextlib.contextmanager
def wall_timer():
    """Yields a callable returning the seconds elapsed since the block began."""
    t0 = time.perf_counter()
    yield lambda: time.perf_counter() - t0
