"""Single-device render orchestration.

Two backends, as in the JAX package (``backend=``; by default ``"bvh"``
above ``BVH_THRESHOLD`` finite primitives, else ``"dense"``): the dense
nearest hit, or the host SAH tree of ``ops/bvh.py`` walked by K6
(``ops/traverse.py``). Three engines (``engine=`` or ``RT_ENGINE``; the
default is ``"batch"`` on both backends: on the BVH frame of PERF.md it
takes 0.6 s against the counter wavefront's 1.0 s and the sticky engine's
2.3 s on an H100, where the JAX package picks the wavefront for its TPU):

* ``batch``: pixels are flattened into fixed-size lane batches; each batch
  runs ``integrator.path.render_pixels``. Frames smaller than
  ``batch_size`` give each pixel ``replicas`` lanes that split the spp
  budget (the JAX package's ``_plan``).
* ``wavefront`` / ``sticky``: the lane engines of
  ``integrator/wavefront.py`` on ``min(batch_size, pixels x spp)`` lanes;
  the sticky engine runs one K5 per round when the lanes cover the pixels.

The fused or the modular route is picked as the JAX package picks it
(``integrator.path.mega_gate``, which chooses the device scene the Renderer
builds). Every draw is keyed by (seed, sample, pixel) through the counter
RNG, so the image does not depend on the batch size, the replica count or
the lane count.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from ..integrator.path import TraceConfig, mega_gate, render_pixels
from ..integrator.wavefront import render_wavefront, render_wavefront_sticky
from ..ops.bounce import BounceScene, bounce_scene
from ..ops.bvh import attach_bvh
from ..ops.camera import camera_arrays, pack_camera_row
from ..ops.scene_intersect import modular_scene
from ..ops.tonemap import color_to_u8
from ..scene.build import build_scene_arrays
from ..scene.types import SceneDesc
from .profiling import RenderStats

log = logging.getLogger("rt_torch")

DEFAULT_BATCH = 1_048_576  # lanes per batch (the JAX package's TPU value)
BVH_THRESHOLD = 2048  # finite prims above this need the BVH backend


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "Renderer(device='cuda'): torch.cuda.is_available() is false"
        )
    return dev


class Renderer:
    """Renders frames of one scene on one device.

    ``plain=True`` runs the plain PyTorch versions of the kernels (K1-K6)
    on any device (used to hold the kernels against them on the card); by
    default a CUDA device runs the kernels and the CPU the plain versions.
    ``backend=None`` picks ``"bvh"`` above ``BVH_THRESHOLD`` finite
    primitives and ``"dense"`` below; either may be asked for. ``engine=None``
    reads ``RT_ENGINE`` (``batch``, ``wavefront`` or ``sticky``; unset means
    ``batch``), ``batch_size=None`` means ``DEFAULT_BATCH`` lanes, and
    ``russian_roulette=None`` reads ``RT_RR`` (``"1"`` turns it on), as the
    JAX package's Renderer does. ``desc``, ``statics``, ``arrays`` (numpy;
    in the tree's order, with ``arrays.bvh`` set, on the BVH backend),
    ``backend`` and ``bvh_builder`` (``"native"`` or ``"numpy"``; None on the
    dense backend) describe the scene as built. After a lane-engine frame,
    ``rounds`` holds its round count."""

    def __init__(
        self,
        desc: SceneDesc,
        device="cuda",
        backend: str | None = None,
        batch_size: int | None = None,
        max_tries: int = 4,
        faithful: bool = False,
        engine: str | None = None,
        russian_roulette: bool | None = None,
        plain: bool = False,
    ):
        self.device = _device(device)
        self.desc = desc
        self.settings = desc.settings
        arrays, statics = build_scene_arrays(desc)
        if backend is None:
            backend = "bvh" if statics.num_prims > BVH_THRESHOLD else "dense"
        if backend not in ("dense", "bvh"):
            raise ValueError(f"unknown backend {backend!r}")
        self.bvh_builder = None
        if backend == "bvh":
            arrays, self.bvh_builder = attach_bvh(arrays, statics)
        self.arrays, self.statics, self.backend = arrays, statics, backend
        engine = engine or os.environ.get("RT_ENGINE") or "batch"
        if engine not in ("batch", "wavefront", "sticky"):
            raise ValueError(f"unknown engine {engine!r}")
        self.engine = engine
        self.rounds = 0
        if russian_roulette is None:
            russian_roulette = os.environ.get("RT_RR") == "1"
        self.batch_size = DEFAULT_BATCH if batch_size is None else batch_size
        self.plain = plain
        self.cfg = TraceConfig(
            ray_depth=self.settings.ray_depth,
            bg_color=tuple(float(c) for c in self.settings.bg_color),
            max_tries=max_tries,
            backend=backend,
            faithful=faithful,
            rr=russian_roulette,
        )
        build = bounce_scene if mega_gate(self.cfg, statics) else modular_scene
        self.scene = build(arrays, statics, self.device)
        self.cam = camera_arrays(self.settings.camera)
        self.cam_row = torch.from_numpy(pack_camera_row(self.cam)[0]).to(self.device)
        self.bg = self.cfg.bg_color

    @property
    def fused(self) -> bool:
        """Whether frames take the fused path (the scene's type is the route)."""
        return isinstance(self.scene, BounceScene)

    def _plan(self, total: int, samples: int):
        """Pick (batch, replicas): fill ~batch_size lanes, replicas | samples."""
        b = min(self.batch_size, total)
        replicas = 1
        if total < self.batch_size:
            budget = max(self.batch_size // total, 1)
            for c in range(min(budget, samples), 0, -1):
                if samples % c == 0:
                    replicas = c
                    break
        return b, replicas

    def render_frame_device(self, seed: int = 0, samples: int | None = None,
                            progress: bool = False):
        """Render the frame, leaving radiance on the device.

        Returns (list of per-batch (3, B) channel-major tensors, path
        vertices as a float); the lane engines return one (3, pixels)
        tensor. Reading the count synchronises, so a host clock around this
        call measures the whole render. ``progress`` logs each batch."""
        w, h = self.settings.width, self.settings.height
        samples = samples or self.settings.samples
        total = w * h
        seed32 = (seed * 2654435761) & 0xFFFFFFFF
        if self.engine != "batch":
            render = render_wavefront_sticky if self.engine == "sticky" else render_wavefront
            lanes = min(self.batch_size, total * samples)
            img, verts, self.rounds = render(seed32, 0, 0, self.cam, self.scene, self.cfg,
                                             w, h, total, samples, lanes, plain=self.plain)
            return [img], verts
        b, replicas = self._plan(total, samples)
        spp_r = samples // replicas
        dev = self.device
        outs = []
        nrays = torch.zeros((), dtype=torch.float64, device=dev)
        for i in range(-(-total // b)):
            lin = torch.arange(b, dtype=torch.int64, device=dev)
            idx = torch.clamp(lin + i * b, max=total - 1)
            rep = torch.arange(replicas, dtype=torch.int64, device=dev)
            # lane (replica r, pixel p) renders samples r*spp_r .. r*spp_r+spp_r-1
            wid = (rep[:, None] * (spp_r * total) + idx[None, :]).reshape(-1)
            pix = idx.repeat(replicas)
            px = (pix % w).to(torch.float32)
            py = (pix // w).to(torch.float32)
            out, rays = render_pixels(
                self.scene, seed32, wid.to(torch.int32), px, py, self.cam_row,
                self.cfg, w, h, spp_r, total, plain=self.plain,
            )
            if replicas > 1:
                out = out.reshape(3, replicas, b).mean(dim=1)
            outs.append(out)
            nrays += rays
            if progress:
                log.info("render progress: %d/%d batches", i + 1, -(-total // b))
        return outs, float(nrays)

    def _assemble(self, outs) -> np.ndarray:
        w, h = self.settings.width, self.settings.height
        flat = torch.cat(outs, dim=1)[:, : w * h].cpu().numpy()
        return np.ascontiguousarray(flat.T).reshape(h, w, 3)

    def render_radiance(self, seed: int = 0, samples: int | None = None,
                        progress: bool = False, with_stats: bool = False):
        """Full-frame mean radiance, (H, W, 3) f32 numpy. ``progress`` logs
        each batch; ``with_stats`` also returns a ``RenderStats`` with the
        exact path-vertex count (the JAX package's ``render_radiance``)."""
        samples = samples or self.settings.samples
        t0 = time.perf_counter()
        outs, verts = self.render_frame_device(seed, samples, progress)
        img = self._assemble(outs)
        if not with_stats:
            return img
        s = self.settings
        return img, RenderStats(width=s.width, height=s.height, samples=samples,
                                ray_depth=s.ray_depth, wall_seconds=time.perf_counter() - t0,
                                path_vertices=verts, primary_rays=s.width * s.height * samples)

    def render_u8(self, seed: int = 0, samples: int | None = None) -> np.ndarray:
        """Tonemapped (H, W, 3) u8 frame; the tonemap runs on the device."""
        outs, _ = self.render_frame_device(seed, samples)
        return self._assemble([color_to_u8(o) for o in outs])


def render_scene(desc: SceneDesc, seed: int = 0, device="cuda",
                 **kw) -> np.ndarray:
    """One-shot render (reference ``render_scene``, src/rendering.rs:21)."""
    r = Renderer(desc, device=device, **kw)
    t0 = time.perf_counter()
    img = r.render_u8(seed)
    dt = time.perf_counter() - t0
    s = desc.settings
    log.info(
        "rendered %dx%d @ %d spp depth %d in %.2fs (%.1f Mprimary-rays/s), backend=%s%s "
        "engine=%s%s",
        s.width, s.height, s.samples, s.ray_depth, dt,
        s.width * s.height * s.samples / dt / 1e6, r.backend,
        "" if r.bvh_builder is None else f" bvh_builder={r.bvh_builder}", r.engine,
        "" if r.engine == "batch" else f" rounds={r.rounds}",
    )
    return img
