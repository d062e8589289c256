"""Engines: the device's idle ms a traced frame while the host was inside
an engine span (``rt.batch.*``: a batch's set-up and fold; ``rt.loop.*``:
a lane loop's reset, host reads and finish; ``rt.graph.*``: a capture).
Each idle instant is put down to the innermost program span open on the
host then (``rtbench/spans.py``); with ``boundary_idle_ms`` it makes up the
window's idle time. None on a program without spans."""

from rtbench.spans import part_ms

UNIT = "ms"
LAYER = "Engines (integrator/path.py, integrator/wavefront.py)"


def read(ctx):
    return part_ms(ctx, True, "engine_idle_ms")
