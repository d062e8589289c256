"""Renderer, host side: the device's idle ms a traced frame while the host
was at the frame boundary: in ``rt.frame.sync`` (the batch engine's wait
for the frame), in ``rt.frame``'s own time, or in no program span (between
frames, in the benchmark's loop). Each idle instant is put down to the
innermost program span open on the host then (``rtbench/spans.py``); with
``engine_idle_ms`` it makes up the window's idle time. None on a program
without spans."""

from rtbench.spans import part_ms

UNIT = "ms"
LAYER = "Renderer, host side (runtime/render.py)"


def read(ctx):
    return part_ms(ctx, False, "boundary_idle_ms")
