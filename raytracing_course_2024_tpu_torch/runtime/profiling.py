"""Render statistics (the JAX package's ``runtime/profiling.py``
``RenderStats``): the record ``Renderer.render_radiance(with_stats=True)``
returns, with the exact path-vertex count the integrators keep, the unit
of the Mrays/s metric."""

from __future__ import annotations

import dataclasses


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
