"""Lane engines: host waits on the loops' device counters
(``integrator/wavefront.py:HOST_READS``) added across the traced window,
per traced frame."""

UNIT = "reads"
LAYER = "Lane engines (integrator/wavefront.py)"


def read(ctx):
    return ctx.delta("host_reads") / ctx.frames if ctx.frames else None
