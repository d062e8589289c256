"""Device: the share of the traced window in which a card ran nothing (no
kernel, copy or fill), from the trace; on several cards the highest share,
since the straggler sets the frame (a card with no
interval in the trace reads 100)."""

UNIT = "%"
LAYER = "Device"


def read(ctx):
    busy = ctx.trace.busy_by_device()
    win = ctx.trace.window_s
    if not busy or win <= 0:
        return None
    shares = [100.0 * (1.0 - busy.get(d, 0.0) / win) for d in range(max(ctx.cell.chips, len(busy)))]
    return max(shares)
