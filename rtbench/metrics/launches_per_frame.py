"""Batch engine and kernel wrappers: every kernel the devices ran in the
traced window (hand-written and ATen alike, graph nodes included, from the
trace) per traced frame; the program's own count of its hand-written
kernels (``ops/kernels.py:LAUNCHES``) is printed beside it."""

UNIT = "launches"
LAYER = "Batch engine and kernel wrappers (integrator/path.py, ops/)"


def read(ctx):
    if not ctx.frames:
        return None
    ctx.note(f"launches_per_frame: hand-written launches counted by the program "
             f"{ctx.delta('launches') / ctx.frames} per frame")
    return len(ctx.trace.kernels()) / ctx.frames
