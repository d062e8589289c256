"""Renderer, host side: the mean over the traced frames of each frame's
wall ms (its span) less the ms in which some device ran inside it: the
host's time per frame that the card did not hide."""

import numpy as np

UNIT = "ms"
LAYER = "Renderer, host side (runtime/render.py)"


def read(ctx):
    busy = ctx.trace.frame_busy_s()
    if not busy:
        return None
    return float(np.mean([(e - s) * 1e-3 - b * 1e3 for (s, e), b in zip(ctx.trace.frames, busy)]))
