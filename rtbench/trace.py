"""The traced window: ``torch.profiler`` (CPU and CUDA activities) over a
run of frames, each frame inside a ``record_function`` span, exported as a
Chrome trace and read back into intervals.

``Trace`` holds, on the profiler's clock in microseconds, the frames'
spans, every device interval (kernels, copies, fills) with its name and
device, and the host's spans (operators, runtime calls, annotations), and
derives what every per-layer reader needs: the union of device busy time
by device, each frame's busy time, device time by kernel name, and the idle
gaps labelled by what the host was doing.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

FRAME_SPAN = "rtbench.frame"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SCAN = 4096  # host spans looked back through for the one open at a gap


def profiler():
    """A profiler of CPU and CUDA activity (``start()``, ``stop()``), which
    ``Trace.from_profiler`` reads."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def frame_span():
    from torch.profiler import record_function
    return record_function(FRAME_SPAN)


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces' anonymity,
    template and argument lists: ``void (anonymous namespace)::k<1>(float*)``
    -> ``k``."""
    n = name.replace("(anonymous namespace)::", "").strip()
    if n.startswith("void "):
        n = n[5:]
    return n.split("(")[0].split("<")[0].strip() or name.strip()


def _union(iv: list) -> list:
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(merged: list, s: float, e: float) -> float:
    return sum(max(0.0, min(e, b) - max(s, a)) for a, b in merged if b > s and a < e)


class Trace:
    def __init__(self, events: list):
        self.frames = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                             if e.get("name") == FRAME_SPAN and e.get("cat") == "user_annotation")
        self.device = [(e["name"], e["ts"], e["ts"] + e["dur"], int(e.get("args", {}).get(
            "device", 0)), e["cat"]) for e in events if e.get("cat") in DEVICE_CATS
            and e.get("ph") == "X"]
        self.host = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "cuda_runtime",
                                                               "cuda_driver", "user_annotation")]

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
        finally:
            os.remove(path)
        return cls(doc["traceEvents"] if isinstance(doc, dict) else doc)

    @property
    def window(self) -> tuple:
        return self.frames[0][0], self.frames[-1][1]

    @property
    def window_s(self) -> float:
        a, b = self.window
        return (b - a) * 1e-6

    def in_window(self) -> list:
        a, b = self.window
        return [d for d in self.device if d[2] > a and d[1] < b]

    def devices(self) -> list:
        return sorted({d[3] for d in self.device})

    def busy_by_device(self) -> dict:
        """Seconds of each device's union of intervals inside the window."""
        a, b = self.window
        out = {}
        for dev in self.devices():
            merged = _union([[s, e] for _, s, e, d, _ in self.device if d == dev])
            out[dev] = _overlap(merged, a, b) * 1e-6
        return out

    def frame_busy_s(self) -> list:
        """Per frame, the seconds in which some device ran inside its span."""
        merged = _union([[s, e] for _, s, e, _, _ in self.device])
        return [_overlap(merged, s, e) * 1e-6 for s, e in self.frames]

    def kernels(self) -> list:
        return [d for d in self.in_window() if d[4] == "kernel"]

    def device_s_by_name(self, names) -> float:
        """Device seconds of the window's kernels whose name holds one of ``names``."""
        return sum(e - s for n, s, e, _, c in self.kernels() if any(k in n for k in names)) * 1e-6

    def top_ops(self, k: int = 10) -> list:
        tot = {}
        for n, s, e, _, _ in self.in_window():
            short = short_name(n)
            tot[short] = tot.get(short, 0.0) + (e - s) * 1e-6
        return sorted(([n, v] for n, v in tot.items()), key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        """Idle seconds of the window (no device busy), summed by the
        innermost host span open at each gap's start ("none": no span)."""
        a, b = self.window
        merged = _union([[s, e] for _, s, e, _, _ in self.device])
        gaps, t = [], a
        for s, e in merged:
            if e <= a or s >= b:
                continue
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < b:
            gaps.append((t, b))
        host = sorted((hs, he, n) for n, hs, he in self.host)
        starts = [h[0] for h in host]
        tot = {}
        for gs, ge in gaps:
            label = "none"
            j = bisect.bisect_right(starts, gs) - 1
            for hs, he, n in reversed(host[max(0, j - SCAN):j + 1]):
                if he > gs:  # the latest-starting span still open: the innermost
                    label = n
                    break
            tot[label] = tot.get(label, 0.0) + (ge - gs) * 1e-6
        return sorted(([n, v] for n, v in tot.items()), key=lambda x: -x[1])[:k]
