"""Scene set-up of the lights' own tree: host seconds of the program's
``rt.setup.lights`` span (``runtime/profiling.py:span_totals``), the host SAH
build over the lights and its 4-wide nodes, which a scene of more than 32
lights runs inside ``rt.setup.device`` (so ``scene_setup_s`` holds it too).
The profiler starts after set-up, so this comes from the program's table,
imported here, inside ``read``. None on a program without the table or the
span."""

UNIT = "s"
LAYER = "Scene set-up (scene/build.py, ops/bvh.py, device tables)"


def read(ctx):
    try:
        from raytracing_course_2024_tpu_torch.runtime.profiling import span_totals
    except ImportError:
        return None
    row = span_totals().get("rt.setup.lights")
    if row is None:
        return None
    n, seconds = row
    parent = span_totals().get("rt.setup.device", [0, 0.0])[1]
    ctx.note(f"light_setup_s: {n} light tree builds, {seconds} s, inside rt.setup.device's "
             f"{parent} s")
    return seconds
