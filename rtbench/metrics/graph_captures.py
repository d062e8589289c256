"""CUDA graphs: entries added to the program's graph caches (every card's)
across the window (a traced run's window is its traced frames). Each is a
capture inside the window, which stalls a frame; the warm-up captures the
cell's graphs, so a sound run reads 0."""

UNIT = "count"
LAYER = "CUDA graphs (runtime/graphs.py)"


def read(ctx):
    return ctx.delta("graph_entries")
