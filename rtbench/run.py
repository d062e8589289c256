"""Runs one cell of ``BENCHMARK.json`` once and prints one JSON line.

    python3 -m rtbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up: the cell's scene from its configuration, one ``Renderer`` (a
``ShardedRenderer`` over every card on a cell of more than one chip), and
``warmup_frames`` frames of the cell's own shape, the first of which
captures the frame's CUDA graphs. The window: frames rendered back to back
by one client, each ``render_frame_device(seed=<run seed, frame index>)``
timed on the host clock from its call to its return, which reads the
path-vertex count and so waits for the card. End to end: ``mrays_per_s``
(all path vertices of the window over its wall seconds), ``frame_ms_p95``
(of every frame of the window) and ``setup_s`` (process start to the
window). With ``--trace 1`` the window is ``trace_frames`` frames under the
profiler instead, and the line carries the per-layer metrics, read by
``metrics/<name>.py``. After the window the program is freed and the plain
reference judges a sample of its frames (``check.py``).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "raytracing_course_2024_tpu")


def frame_seed(seed: int, i: int) -> int:
    """The seed of frame ``i`` of a run (negative: the warm-up's frames)."""
    return int(seed) * 65537 + i + 16


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


class Window:
    """What the window measured: each frame's ms and path vertices, the
    frames the reservoir kept, the program's counters at the window's ends;
    on a traced window the profiler and each frame's rounds."""

    def __init__(self):
        self.ms, self.verts, self.kept = [], [], {}
        self.wall = 0.0
        self.prof = None
        self.counters0 = self.counters1 = None
        self.rounds: list = []


def run_window(system, seed: int, seconds: float, trace_frames: int, reservoir,
               pixels) -> Window:
    """Frames back to back for ``seconds``, or, with ``trace_frames``, that
    many frames under the profiler."""
    import torch

    from . import trace

    w = Window()
    w.counters0 = system.counters()
    if trace_frames:
        w.prof = trace.profiler()
        w.prof.start()
    start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        if trace_frames:
            with trace.frame_span():
                img, verts = system.frame(frame_seed(seed, i))
            w.rounds.append(system.r.rounds)
        else:
            img, verts = system.frame(frame_seed(seed, i))
        t1 = time.perf_counter()
        w.ms.append((t1 - t0) * 1e3)
        w.verts.append(verts)
        slot = reservoir.slot(i)
        if slot is not None:
            w.kept[slot] = (i, verts, img[:, pixels])
        i += 1
        if (i >= trace_frames) if trace_frames else (t1 - start >= seconds):
            break
    if trace_frames:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        w.prof.stop()
    w.counters1 = system.counters()
    w.wall = t1 - start
    return w


def main(argv=None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import check, registry, scenes
    from .reference import tracer
    from .reference.rng import frame_seed32

    cell = registry.Cell(args.workload)
    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            print("rtbench: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"rtbench: {cell.name} needs {cell.chips} cards, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2
    from .program import System

    tr, cfg, st = cell.traffic, cell.config, cell.settings
    spec = scenes.build(cfg["scene"], cell.config_dir, tr["width"], tr["height"])
    n_pix = spec.width * spec.height
    pixels_np = check.judged_pixels(args.seed, n_pix, st["check"]["pixels"])
    system = System(spec, tr["spp"], cell.chips, cfg["backend"], cfg["max_tries"],
                    tr["russian_roulette"], device=device)
    for k in range(st["warmup_frames"]):
        system.frame(frame_seed(args.seed, -1 - k))
    home = torch.device(device) if device != "cuda" else torch.device("cuda", 0)
    pixels = torch.from_numpy(pixels_np).to(home)
    if device == "cuda":
        torch.cuda.synchronize()
        for d in range(cell.chips):
            torch.cuda.reset_peak_memory_stats(d)
    setup_s = time.perf_counter() - T0

    reservoir = check.Reservoir(st["check"]["frames"], args.seed)
    trace_frames = st["trace_frames"] if args.trace else 0
    w = run_window(system, args.seed, args.seconds, trace_frames, reservoir, pixels)

    if device == "cuda":
        kind = torch.cuda.get_device_name(0)
        peak = max(torch.cuda.max_memory_allocated(d) for d in range(cell.chips))
    else:
        kind, peak = "cpu", 0
    engine = system.engine
    kept = [(i, v, rad.float().cpu()) for i, v, rad in (w.kept[k] for k in sorted(w.kept))]
    del system
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # the reference, on the same pixels of the same frames
    ref_scene = tracer.Scene(spec, home, tree=cfg["backend"] == "bvh")
    lane = engine != "batch"
    ref = [tracer.render_pixels(ref_scene, frame_seed32(frame_seed(args.seed, i)), pixels,
                                tr["spp"], lane, cfg["max_tries"], tr["russian_roulette"])
           for i, _, _ in kept]
    numbers = check.compare([(rad, v) for _, v, rad in kept],
                            [(r.cpu(), rv.sum().cpu()) for r, rv in ref], n_pix, len(pixels_np))
    limits = st["check"]["limits"]
    correct = check.verdict(numbers, limits)
    failed = sum(1 for v in w.verts if not (np.isfinite(v) and v > 0))

    card = card_line()
    print(f"rtbench: card {card}; cell {cell.name}; engine {engine}; frames {len(w.ms)}"
          f" in {w.wall:.3f} s; path vertices {sum(w.verts):.0f}; memory_peak_bytes {peak};"
          f" judged frames {[i for i, _, _ in kept]}", file=sys.stderr)
    print(f"rtbench: counters at the window's start {json.dumps(w.counters0)}, at its end "
          f"{json.dumps(w.counters1)}", file=sys.stderr)
    result = {"correct": bool(correct and failed == 0), "attempted": len(w.ms), "failed": failed}
    device_rec = {"platform": "gpu" if device == "cuda" else device, "kind": kind,
                  "count": cell.chips, "memory_peak_bytes": int(peak)}
    if args.trace:
        from . import trace as trace_mod
        tr_ = trace_mod.Trace.from_profiler(w.prof)
        ctx = Context(cell, spec, tr_, w, ref_scene, kind, card, engine,
                      frame_seed32(frame_seed(args.seed, kept[0][0])), pixels)
        metrics = {}
        for m in cell.per_layer:
            val = registry.reader(m["name"]).read(ctx)
            if val is not None:
                metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
        busy = tr_.busy_by_device()
        device_rec.update(busy_s=sum(busy.values()) / cell.chips,
                          window_s=tr_.window_s)
        result["breakdown"] = {"device_ops": tr_.top_ops(), "idle_gaps": tr_.idle_gaps()}
        for line in ctx.notes:
            print(f"rtbench: {line}", file=sys.stderr)
        print(f"rtbench: traced {len(tr_.frames)} frames, busy by device {busy}",
              file=sys.stderr)
    else:
        ms = np.asarray(w.ms)
        metrics = {"mrays_per_s": {"value": sum(w.verts) / w.wall / 1e6, "unit": "Mrays/s"},
                   "frame_ms_p95": {"value": float(np.percentile(ms, 95)), "unit": "ms"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        print(f"rtbench: frame ms median {float(np.median(ms))} p95 {float(np.percentile(ms, 95))}"
              f" max {float(ms.max())}", file=sys.stderr)
    result.update(metrics=metrics, device=device_rec, check=check.lines(numbers, limits))
    bad = forbidden_modules()
    if bad:
        print(f"rtbench: JAX or the JAX package is loaded: {bad}", file=sys.stderr)
        return 3
    for k, v in result["check"].items():
        print(f"rtbench: check {k} = {v['value']} (limit {v['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


class Context:
    """What a per-layer reader may read: the traced window's ``trace``, its
    frames and path vertices, the program's counters at its ends and each
    frame's rounds, the cell, the reference scene (the walk models' tree),
    the judged pixels, the card's peaks."""

    def __init__(self, cell, spec, trace, w: Window, ref_scene, kind: str, power: str,
                 engine: str, seed32: int, pixels):
        from . import registry
        self.cell, self.spec, self.trace, self.engine = cell, spec, trace, engine
        self.frames = len(w.rounds)
        self.verts = sum(w.verts)
        self.counters0, self.counters1, self.rounds = w.counters0, w.counters1, w.rounds
        self.ref_scene, self.seed32, self.pixels = ref_scene, seed32, pixels
        self.kind, self.power = kind, power
        self.peaks = registry.peaks(kind)
        self.notes: list = []

    def note(self, line: str) -> None:
        """A line for standard error, beside the metrics (how a number was
        reckoned)."""
        self.notes.append(line)

    def delta(self, name: str) -> float:
        return self.counters1[name] - self.counters0[name]


if __name__ == "__main__":
    sys.exit(main())
