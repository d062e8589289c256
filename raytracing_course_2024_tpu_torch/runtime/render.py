"""Render orchestration: one device (``Renderer``) or a mesh of devices
(``ShardedRenderer``).

Two backends, as in the JAX package (``backend=``; by default ``"bvh"``
above ``BVH_THRESHOLD`` finite primitives, else ``"dense"``): the dense
nearest hit, or the host SAH tree of ``ops/bvh.py`` walked by K6
(``ops/traverse.py``). Three engines (``engine=`` or ``RT_ENGINE``; by
default the counter wavefront on the BVH backend and the batch engine on
the dense one, as the JAX package's ``Renderer`` picks them. The card
agrees: the 81,920-triangle BVH frame of PERF.md at 1280x720 x 16 spp,
graphed on an NVIDIA H100 80GB HBM3 at a 700 W power limit, took 17.2-17.3
ms on the counter wavefront, 26.5-27.1 ms on the batch engine and
26.7-28.2 ms on the sticky engine. The lane count stays
``integrator/path.py:DEFAULT_BATCH`` on every engine):

* ``batch``: pixels are flattened into fixed-size lane batches; each batch
  runs ``integrator.path.render_pixels`` (``render_batches``). Frames
  smaller than ``batch_size`` give each pixel ``replicas`` lanes that split
  the spp budget (the JAX package's ``_plan``).
* ``wavefront`` / ``sticky``: the lane engines of
  ``integrator/wavefront.py`` on ``min(batch_size, pixels x spp)`` lanes;
  the sticky engine runs one K5 per round when the lanes cover the pixels.

The fused or the modular route follows from the scene and the integrator's
settings alone (``integrator.path.mega_gate``: the dense backend, no
roulette, no faithful acceptance, a scene inside the fused gate), decided
once, when the renderer is made: it chooses the device scene the renderer
builds. Every draw is keyed by (seed, sample, pixel) through the counter
RNG, so the image does not depend on the batch size, the replica count, the
lane count or the mesh.

On a card, the batch engine's samples and the lane engines' rounds replay
captured CUDA graphs on either route (``runtime/graphs.py``), one cache
per device scene, the counterpart of the JAX package's ``jax.jit`` of a
frame: a lane frame replays graphs of several rounds, each guarded on the
card by the round test N5, so its loop reads the host about once per
``integrator/wavefront.py:ROUNDS_PER_REPLAY`` rounds, and its rounds and
path vertices come from its device counters. ``eager=True`` runs them op
by op, as ``jax.disable_jit()`` does; ``plain`` and the CPU run eagerly.

``render_scene`` shards over every card (``parallel/shard.py``) when it is
asked for ``"cuda"`` and more than one card is present, and over every
process of a process group of more than one (``init_distributed``), as the
JAX package shards over every device of every host.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from ..integrator.path import (DEFAULT_BATCH, TraceConfig, mega_gate, plan_batches,
                               render_batches)
from ..integrator.wavefront import render_wavefront, render_wavefront_sticky
from ..ops.bounce import bounce_scene
from ..ops.bvh import attach_bvh
from ..ops.camera import camera_arrays, pack_camera_row
from ..ops.scene_intersect import modular_scene
from ..ops.tonemap import color_to_u8
from ..parallel.shard import (local_cards, make_mesh, make_multihost_mesh, process_count,
                              process_layout, render_frame_sharded)
from ..scene.build import build_scene_arrays
from ..scene.types import SceneDesc
from .graphs import GraphCache
from .profiling import RenderStats, count, span

log = logging.getLogger("rt_torch")

BVH_THRESHOLD = 2048  # finite prims above this need the BVH backend


def graph_cache(scene, device: torch.device, eager: bool):
    """The graph cache of a device scene: None on the CPU or when ``eager``."""
    return None if eager or device.type != "cuda" else GraphCache(scene, device)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "Renderer(device='cuda'): torch.cuda.is_available() is false"
        )
    return dev


class _RendererBase:
    """What both renderers share. Before a device is touched: the host
    arrays (with the BVH attached on the BVH backend), the backend, the
    engine, the integrator's ``cfg``, the camera and the route
    (``mega_gate``: ``fused``); ``_device_scene`` builds that route's scene
    on one device (spans ``rt.setup.scene``, ``rt.setup.bvh``,
    ``rt.setup.device``; above 32 lights ``rt.setup.lights``, the lights'
    own tree, inside ``rt.setup.device``). After a frame
    (``render_frame_device``, which each renderer defines, as the span
    ``rt.frame`` with ``frames``, the frames rendered before it, in its
    args): the host image and its statistics."""

    def __init__(self, desc: SceneDesc, backend, max_tries, faithful, engine,
                 russian_roulette):
        self.desc = desc
        self.settings = desc.settings
        self.frames = 0
        with span("rt.setup.scene"):
            arrays, statics = build_scene_arrays(desc)
        if backend is None:
            backend = "bvh" if statics.num_prims > BVH_THRESHOLD else "dense"
        if backend not in ("dense", "bvh"):
            raise ValueError(f"unknown backend {backend!r}")
        self.bvh_builder = None
        if backend == "bvh":
            with span("rt.setup.bvh"):
                arrays, self.bvh_builder = attach_bvh(arrays, statics)
        self.arrays, self.statics, self.backend = arrays, statics, backend
        engine = engine or os.environ.get("RT_ENGINE")
        if engine is None:
            engine = "wavefront" if backend == "bvh" else "batch"
        if engine not in ("batch", "wavefront", "sticky"):
            raise ValueError(f"unknown engine {engine!r}")
        self.engine = engine
        if russian_roulette is None:
            russian_roulette = os.environ.get("RT_RR") == "1"
        self.cfg = TraceConfig(
            ray_depth=self.settings.ray_depth,
            bg_color=tuple(float(c) for c in self.settings.bg_color),
            max_tries=max_tries,
            backend=backend,
            faithful=faithful,
            rr=russian_roulette,
        )
        self.cam = camera_arrays(self.settings.camera)
        self._build = bounce_scene if mega_gate(self.cfg, self.statics) else modular_scene

    @property
    def fused(self) -> bool:
        """Whether frames take the fused path (``mega_gate``, read once)."""
        return self._build is bounce_scene

    def _device_scene(self, device: torch.device):
        with span("rt.setup.device"):
            return self._build(self.arrays, self.statics, device)

    def _frame_span(self) -> span:
        """The span ``rt.frame`` of the next frame, numbered from 0."""
        self.frames += 1
        return span("rt.frame", self.frames - 1)

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


class Renderer(_RendererBase):
    """Renders frames of one scene on one device.

    ``plain=True`` runs the plain PyTorch versions of the kernels (K1-K6)
    on any device (used to hold the kernels against them on the card); by
    default a CUDA device runs the kernels and the CPU the plain versions.
    ``backend=None`` picks ``"bvh"`` above ``BVH_THRESHOLD`` finite
    primitives and ``"dense"`` below; either may be asked for. ``engine=None``
    reads ``RT_ENGINE`` (``batch``, ``wavefront`` or ``sticky``; unset means
    ``wavefront`` on the BVH backend and ``batch`` on the dense one),
    ``batch_size=None`` means ``DEFAULT_BATCH`` lanes, and
    ``russian_roulette=None`` reads ``RT_RR`` (``"1"`` turns it on), as the
    JAX package's Renderer does. ``desc``, ``statics``, ``arrays`` (numpy;
    in the tree's order, with ``arrays.bvh`` set, on the BVH backend),
    ``backend`` and ``bvh_builder`` (``"native"`` or ``"numpy"``; None on the
    dense backend) describe the scene as built. After a lane-engine frame,
    ``rounds`` holds its round count. On a card the batch engine's samples
    and the lane engines' rounds replay CUDA graphs captured on first use,
    on the fused and the modular route (``graphs``, a
    ``runtime/graphs.py:GraphCache``; the lane loops in guarded rounds, the
    sticky engine's K5 loop too); ``eager=True`` (or ``plain=True``)
    launches every op from Python."""

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
        eager: bool = False,
    ):
        self.device = _device(device)
        super().__init__(desc, backend, max_tries, faithful, engine, russian_roulette)
        self.rounds = 0
        self.batch_size = DEFAULT_BATCH if batch_size is None else batch_size
        self.plain = plain
        self.scene = self._device_scene(self.device)
        self.graphs = graph_cache(self.scene, self.device, eager or plain)
        self.cam_row = torch.from_numpy(pack_camera_row(self.cam)[0]).to(self.device)
        self.bg = self.cfg.bg_color

    def _plan(self, total: int, samples: int):
        """(batch, replicas) of a frame of ``total`` pixels (``plan_batches``)."""
        return plan_batches(self.batch_size, total, samples)

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
        with self._frame_span():
            if self.engine != "batch":
                render = render_wavefront_sticky if self.engine == "sticky" else render_wavefront
                lanes = min(self.batch_size, total * samples)
                img, verts, self.rounds = render(seed32, 0, 0, self.cam, self.scene, self.cfg,
                                                 w, h, total, samples, lanes, plain=self.plain,
                                                 graphs=self.graphs)
                outs = [img]
            else:
                outs, verts = render_batches(self.scene, seed32, self.cam_row, self.cfg, w, h,
                                             samples, self.batch_size, plain=self.plain,
                                             progress=progress, graphs=self.graphs)
                with span("rt.frame.sync"):  # the batch engine's wait for the frame
                    verts = float(verts)
            count("rt.path_vertices", verts)
        return outs, verts


def render_scene(desc: SceneDesc, seed: int = 0, device="cuda", **kw) -> np.ndarray:
    """One-shot render (reference ``render_scene``, src/rendering.rs:21).

    Asked for ``"cuda"`` with more than one card present, the frame renders
    over a (tile x spp) mesh of every card (``ShardedRenderer``); a named
    device (``"cuda:1"``, ``"cpu"``) gets the single-device ``Renderer``.
    In a process group of more than one process, the frame renders over a
    mesh of every process's cards (``"cuda"``) or of its ``device``, and
    every process returns it."""
    if process_count() > 1:
        return _render_scene_sharded(desc, seed, device=device, **kw)
    if str(device) == "cuda" and torch.cuda.device_count() > 1:
        return _render_scene_sharded(desc, seed, **kw)
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


class ShardedRenderer(_RendererBase):
    """Renders frames of one scene over a (tile, spp) mesh of devices
    (``parallel/shard.py``): rows over ``tile``, samples over ``spp``.

    ``mesh=None`` puts 2 cards on the spp axis when the card count and the
    samples are even, the rest on ``tile`` (the JAX package's default); in a
    process group of more than one process, the cards are every process's
    (``default_mesh``).
    ``backend``, ``max_tries`` and ``engine`` mean what they mean in
    ``Renderer``, and so does ``RT_RR``; each shard runs ``DEFAULT_BATCH``
    lanes at most. The device scene is built once per distinct device.
    Duck-typed into ``runtime.checkpoint.render_with_checkpoints``
    (``.settings``, ``.engine``, ``.backend``, ``.arrays``,
    ``render_radiance(seed, samples)``): a long frame checkpoints and
    resumes bit for bit on any mesh. ``render_radiance`` (``with_stats``
    too) and ``render_u8`` are ``Renderer``'s; after a frame, ``rounds``
    holds each shard's round count, ``[tile][spp]`` (0 on the batch
    engine). Each card's scene has its graph cache (``graphs``), as a
    ``Renderer``'s, unless ``eager``."""

    def __init__(self, desc: SceneDesc, mesh=None, backend: str | None = None,
                 max_tries: int = 4, engine: str | None = None, eager: bool = False):
        if mesh is None:
            mesh = default_mesh(desc.settings.samples)
        for dev in mesh.distinct():
            _device(dev)
        self.mesh = mesh
        super().__init__(desc, backend, max_tries, False, engine, None)
        self.scenes = {dev: self._device_scene(dev) for dev in mesh.distinct()}
        self.graphs = {dev: graph_cache(scn, dev, eager) for dev, scn in self.scenes.items()}
        self.rounds = []

    def render_frame_device(self, seed: int = 0, samples: int | None = None,
                            progress: bool = False):
        """Render the frame over the mesh, leaving radiance on the mesh's
        first device: ([(3, H*W) channel-major radiance], path vertices), as
        ``Renderer.render_frame_device`` returns it (``progress`` is not
        used: each shard renders in one pass)."""
        s = self.settings
        with self._frame_span() as frame:
            img, verts, self.rounds = render_frame_sharded(
                seed, self.scenes, self.cfg, self.cam, s.width, s.height,
                samples or s.samples, self.mesh, engine=self.engine, graphs=self.graphs,
                frame=frame.frame)
        return [img.reshape(3, -1)], verts


def default_mesh(samples: int, devices=None):
    """The JAX package's factoring of every card (or of ``devices``): 2 on
    the spp axis when each process's count and ``samples`` are even, the
    rest on ``tile``. In a process group of more than one process the cards
    are every process's (``process_layout``: by default each process's
    ``local_cards``), laid out by ``make_multihost_mesh``."""
    if process_count() > 1:
        layout = process_layout(local_cards() if devices is None else devices)
        n_spp = 2 if samples % 2 == 0 and all(len(d) % 2 == 0 for d in layout) else 1
        return make_multihost_mesh(sum(map(len, layout)) // n_spp, n_spp, layout=layout)
    ndev = torch.cuda.device_count() if devices is None else len(devices)
    n_spp = 2 if ndev % 2 == 0 and samples % 2 == 0 else 1
    return make_mesh(ndev // n_spp, n_spp, devices)


def _render_scene_sharded(desc: SceneDesc, seed: int = 0, batch_size: int | None = None,
                          device="cuda", **kw) -> np.ndarray:
    """One-shot render over every card, or over every process's ``device``
    in a process group (``ShardedRenderer``). ``batch_size`` is
    single-device only and is refused, so that a caller's intent is never
    dropped."""
    if batch_size is not None:
        raise ValueError("batch_size is single-device only; the sharded renderer runs "
                         "DEFAULT_BATCH lanes per shard")
    if str(device) != "cuda":
        kw["mesh"] = default_mesh(desc.settings.samples, [device])
    r = ShardedRenderer(desc, **kw)
    s = desc.settings
    t0 = time.perf_counter()
    img = r.render_u8(seed)
    log.info("sharded render (%s): %dx%d @ %d spp in %.2fs, backend=%s engine=%s",
             r.mesh.shape, s.width, s.height, s.samples, time.perf_counter() - t0,
             r.backend, r.engine)
    return img
