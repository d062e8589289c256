"""CUDA graphs: host seconds of the program's ``rt.graph.capture`` spans
(``runtime/profiling.py:span_totals``): each graph entry's first call, its
warm-up run and its capture, all in set-up on a sound run (the warm-up's
first frame captures the cell's graphs; ``graph_captures`` reads 0). The
profiler starts after set-up, so this comes from the program's table,
imported here, inside ``read``. None on a program without the table."""

UNIT = "s"
LAYER = "CUDA graphs (runtime/graphs.py)"


def read(ctx):
    try:
        from raytracing_course_2024_tpu_torch.runtime.profiling import span_totals
    except ImportError:
        return None
    n, seconds = span_totals().get("rt.graph.capture", [0, 0.0])
    ctx.note(f"graph_setup_s: {n} captures, {seconds} s, of which "
             f"{ctx.delta('graph_entries')} inside the window")
    return seconds
