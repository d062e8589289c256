"""Engines: path vertices over the lane slots the launches covered, in
percent, from the program's table of spans and counters
(``runtime/profiling.py:span_totals``: ``rt.path_vertices`` and
``rt.lane_slots``, lanes x levels x samples on the batch engine, lanes x
rounds on the lane engines) over the whole run. Every frame of a cell has
one shape, so the warm-up's frames do not move the ratio. The program is
imported here, inside ``read``: the table is the program's, not the
trace's. None on a program without the table."""

UNIT = "%"
LAYER = "Engines (integrator/path.py, integrator/wavefront.py)"


def read(ctx):
    try:
        from raytracing_course_2024_tpu_torch.runtime.profiling import span_totals
    except ImportError:
        return None
    t = span_totals()
    slots = t.get("rt.lane_slots", [0])[0]
    verts = t.get("rt.path_vertices", [0])[0]
    if not slots:
        return None
    ctx.note(f"lane_occupancy_pct: {verts:.0f} path vertices over {slots:.0f} lane slots "
             f"in {t.get('rt.frame', [0])[0]} frames")
    return 100.0 * verts / slots
