"""The system under test, driven through its public entry points: the scene
loaders and types, ``runtime.render.Renderer`` (``ShardedRenderer`` on more
than one card), ``render_frame_device``, and the counters the program keeps
(its graph caches' ``stats()``, the lane engines' ``HOST_READS`` and
``rounds``, ``ops.kernels.LAUNCHES``). Nothing else of the benchmark
imports the program."""

from __future__ import annotations

import numpy as np

from .scenes import SceneSpec

def scene_desc(spec: SceneSpec, samples: int):
    """The program's ``SceneDesc``: a scene file through its own loader, else
    the spec's rows as its primitive descriptions."""
    from raytracing_course_2024_tpu_torch.scene import (CameraDesc, PrimitiveDesc,
                                                        RenderSettings, SceneDesc, load_scene)
    if spec.file is not None:
        return load_scene(spec.file, spec.width, spec.height, samples)
    p, q = spec.prims, spec.planes

    def rows(cols: dict, n: int, kind: str):
        for i in range(n):
            kw = {k: (v[i] if v.ndim > 1 else float(v[i])) for k, v in cols.items()
                  if k not in ("kind", "mkind", "normal")}
            kw["mkind"] = int(cols["mkind"][i])
            if kind == "prim":
                kw["ptype"] = int(cols["kind"][i])
            else:
                kw.update(ptype=-1, p0=cols["normal"][i])
            yield PrimitiveDesc(**kw)

    cam = spec.camera
    camera = CameraDesc(position=np.asarray(cam["position"]), right=np.asarray(cam["right"]),
                        up=np.asarray(cam["up"]), forward=np.asarray(cam["forward"]),
                        fov_x=float(cam["fov_x"]), fov_y=float(cam["fov_y"]))
    settings = RenderSettings(width=spec.width, height=spec.height, samples=samples,
                              ray_depth=spec.ray_depth, bg_color=tuple(spec.bg), camera=camera)
    return SceneDesc(settings=settings, primitives=list(rows(p, spec.num_prims, "prim")),
                     planes=list(rows(q, len(q["mkind"]), "plane")))


class System:
    """One renderer of the cell's scene on ``chips`` cards."""

    def __init__(self, spec: SceneSpec, samples: int, chips: int, backend: str,
                 max_tries: int, russian_roulette: bool, device: str = "cuda"):
        from raytracing_course_2024_tpu_torch.runtime import render

        if device == "cuda":
            # build or load the kernel library here, on one thread: the
            # sharded renderer's shard threads would each start the build
            from raytracing_course_2024_tpu_torch.ops import kernels
            kernels.library()
        desc = scene_desc(spec, samples)
        self.samples = samples
        if chips > 1:
            if russian_roulette:
                raise ValueError("the sharded renderer takes roulette from RT_RR only")
            mesh = None if device == "cuda" else render.default_mesh(samples, [device] * chips)
            self.r = render.ShardedRenderer(desc, mesh=mesh, backend=backend,
                                            max_tries=max_tries)
        else:
            self.r = render.Renderer(desc, device=device, backend=backend, max_tries=max_tries,
                                     russian_roulette=russian_roulette)
        self.sharded = chips > 1

    @property
    def engine(self) -> str:
        return self.r.engine

    def frame(self, seed: int):
        """Renders one frame; returns ((3, pixels) radiance on the device,
        path vertices). Reading the count synchronises."""
        import torch
        outs, verts = self.r.render_frame_device(seed=seed, samples=self.samples)
        return (outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)), float(verts)

    def counters(self) -> dict:
        """The program's own counters, as they stand."""
        from raytracing_course_2024_tpu_torch.integrator import wavefront
        from raytracing_course_2024_tpu_torch.ops import kernels

        caches = list(self.r.graphs.values()) if self.sharded else [self.r.graphs]
        stats = [c.stats() for c in caches if c is not None]
        rounds = self.r.rounds
        if self.sharded:
            rounds = sum(sum(row) for row in rounds)
        return {"graph_entries": sum(s["entries"] for s in stats),
                "graph_capture_ms": sum(s["capture_ms"] for s in stats),
                "graph_pool_mb": sum(s["pool_mb"] for s in stats),
                "graph_replays": sum(s["replays"] for s in stats),
                "host_reads": wavefront.HOST_READS[0],
                "rounds": rounds,
                "launches": sum(kernels.LAUNCHES.values())}
