"""A stage's share of its roofline: the least time the card could take for
the stage's work, the larger of its bytes over the published memory
bandwidth and its float32 operations over the published float32 peak
(``peaks.json``), over the stage's kernels' device seconds in the trace.
Each input byte is counted read once and each output written once; the
counts are lower bounds, so a share can only read low, never above 100 %
through the count."""

from __future__ import annotations


def share(ctx, stage: str, names, nbytes: float, ops: float):
    """Percent of the roofline for ``stage``, or None where the card has no
    published peaks or the trace has none of the stage's kernels."""
    dev_s = ctx.trace.device_s_by_name(names)
    pk = ctx.peaks
    if pk is None or dev_s <= 0:
        return None
    t_bytes, t_ops = nbytes / pk["hbm_bytes_per_s"], ops / pk["fp32_flops"]
    least = max(t_bytes, t_ops)
    ctx.note(f"{stage}_roofline: {nbytes:.6g} B / {pk['hbm_bytes_per_s']:.4g} B/s = "
             f"{t_bytes * 1e3:.6g} ms, {ops:.6g} fp32 ops / {pk['fp32_flops']:.4g} FLOP/s = "
             f"{t_ops * 1e3:.6g} ms: bound by {'bytes' if t_bytes >= t_ops else 'operations'}; "
             f"device {dev_s * 1e3:.6g} ms over {ctx.frames} frames of kernels {list(names)}; "
             f"peaks of {ctx.kind} at a {pk['power_w']} W limit (the card's: {ctx.power})")
    return 100.0 * least / dev_s
