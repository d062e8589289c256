"""Scene set-up: host seconds of the program's set-up spans
(``runtime/profiling.py:span_totals``): ``rt.setup.scene`` (the scene
arrays), ``rt.setup.bvh`` (the host SAH build and reorder, BVH backend) and
``rt.setup.device`` (the device scene's tables). The profiler starts after
set-up, so these come from the program's table, imported here, inside
``read``. The note adds ``rt.setup.library`` (nvcc or the cached load) and
``rt.graph.capture``; what of ``setup_s`` no span covers (imports, the CUDA
context, the benchmark's own scene generation, the warm-up frames' work) is
``setup_s`` less their sum. None on a program without the table."""

UNIT = "s"
LAYER = "Scene set-up (scene/build.py, ops/bvh.py, device tables)"
PARTS = ("rt.setup.scene", "rt.setup.bvh", "rt.setup.device")


def read(ctx):
    try:
        from raytracing_course_2024_tpu_torch.runtime.profiling import span_totals
    except ImportError:
        return None
    t = span_totals()
    seconds = {n: t[n][1] for n in PARTS + ("rt.setup.library", "rt.graph.capture") if n in t}
    if not any(n in seconds for n in PARTS):
        return None
    ctx.note(f"scene_setup_s: host seconds by set-up span {seconds}; the spans cover "
             f"{sum(seconds.values())} s of setup_s")
    return sum(seconds.get(n, 0.0) for n in PARTS)
