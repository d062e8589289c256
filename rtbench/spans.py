"""The program's own spans in the traced window: the device's idle time put
down, instant by instant, to the innermost program span (a host record
named ``rt.*``, ``runtime/profiling.py:span`` in the program) open at that
instant, for ``metrics/boundary_idle_ms.py`` and
``metrics/engine_idle_ms.py``.

Idle is the window's time in which no device ran anything (as
``Trace.idle_gaps`` has it). Unlike ``Trace.idle_gaps``, which names a
whole gap by the host record open at its start, a gap here is split where
the host enters or leaves a span. Time in no program span is ``none``. The
engine spans (``ENGINE``) make up the engines' part; every other label, the
frame's own time, its sync, ``none``, is the frame boundary's: the two parts
sum to the window's idle time.
"""

from __future__ import annotations

from .trace import _union

PREFIX = "rt."
FRAME = "rt.frame"
ENGINE = ("rt.batch.", "rt.loop.", "rt.graph.")
OUTSIDE = "none"


def idle_gaps(trace) -> list:
    """The window's intervals (microseconds) in which no device was busy."""
    a, b = trace.window
    gaps, t = [], a
    for s, e in _union([[s, e] for _, s, e, _, _ in trace.device]):
        if e <= a or s >= b:
            continue
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < b:
        gaps.append((t, b))
    return gaps


def segments(spans: list) -> list:
    """``[(start, end, label)]`` over the spans' extent: between two of the
    spans' boundaries the innermost span open (the latest to start; of two
    that start together, the first to end), or ``OUTSIDE``."""
    spans = sorted((s, e, n) for n, s, e in spans if e > s)
    times = sorted({t for s, e, _ in spans for t in (s, e)})
    out, open_, nxt = [], [], 0
    for t0, t1 in zip(times, times[1:]):
        while nxt < len(spans) and spans[nxt][0] <= t0:
            open_.append(spans[nxt])
            nxt += 1
        open_ = [sp for sp in open_ if sp[1] > t0]
        label = max(open_, key=lambda sp: (sp[0], -sp[1]))[2] if open_ else OUTSIDE
        out.append((t0, t1, label))
    return out


def idle_by_span(trace) -> dict | None:
    """Idle seconds of the window by the innermost program span open on the
    host; None where the trace holds no ``rt.frame`` span (a program without
    spans)."""
    spans = [(n, s, e) for n, s, e in trace.host if n.startswith(PREFIX)]
    if not any(n == FRAME for n, _, _ in spans):
        return None
    segs = segments(spans)
    out: dict = {}
    j = 0
    for g0, g1 in idle_gaps(trace):
        t = g0
        while j < len(segs) and segs[j][1] <= t:
            j += 1
        k = j
        while t < g1:
            if k < len(segs) and segs[k][0] <= t:
                end, label = min(g1, segs[k][1]), segs[k][2]
                k += 1
            else:  # before the next span's segment, or after the last
                end = min(g1, segs[k][0]) if k < len(segs) else g1
                label = OUTSIDE
            if end > t:
                out[label] = out.get(label, 0.0) + (end - t) * 1e-6
            t = end
    return out


def part_ms(ctx, engine: bool, metric: str):
    """The engines' (``engine``) or the frame boundary's idle ms a traced
    frame, with a note of its split by span name; None without spans."""
    split = idle_by_span(ctx.trace)
    if split is None or not ctx.frames:
        return None
    mine = {n: v * 1e3 / ctx.frames for n, v in split.items()
            if n.startswith(ENGINE) == engine}
    ctx.note(f"{metric}: device idle ms a frame by the host's innermost program span "
             f"{dict(sorted(mine.items(), key=lambda x: -x[1]))}")
    return sum(mine.values())
