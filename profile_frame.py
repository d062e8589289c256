"""Where the device time of one Cornell or BVH frame goes, on one CUDA card.

    python3 profile_frame.py                    # batch engine, fused path (K2, K1, K1-final)
    python3 profile_frame.py --rr               # batch engine, modular path (K4, K3)
    python3 profile_frame.py --engine sticky    # one K5 per round
    python3 profile_frame.py --engine wavefront # K1 in lane mode + refills
    python3 profile_frame.py --bvh --engine E   # the BVH scene on engine E (K6)
    python3 profile_frame.py --bvh --eager      # graphed and eager frames in turns
    python3 profile_frame.py --bvh --engine E --stages [--root TREE]
                                                # a lane round's device ms by stage

Renders scenes/cornell_box.gltf (with ``--bvh``: chip_smoke.py's
81,920-triangle BVH scene) at 1280x720 x 16 spp through the port's
Renderer: one warm-up frame (it captures the CUDA graphs of every engine,
on both routes), then one frame under torch.profiler
(``chip_smoke.profiled_frame``). ``--eager`` profiles the same renderer with
``eager=True`` too, in turns: eager, graphed, graphed, eager. Prints the
card's name and power limit, each profiled frame's mode, wall ms, the
summed device ms and its share of the wall time (the device's busy share),
the waits on the card of the same frame rendered again unprofiled
(``chip_smoke.host_reads``: on a lane engine, graphed, about one read per
``ROUNDS_PER_REPLAY`` rounds), the lane engines' rounds, then device ms and
launch counts per kernel name, largest first. The profiler itself slows the
host, so the busy share of an unprofiled frame is higher.

``--stages`` (a lane engine) splits the device time of one eager frame's
rounds by stage (``stage_split``): the refill (``RefillBody.__call__``) or
the sticky restart (``StickyBody.restart``), the bounce core and inside it
the kernels (the nearest hit, N1a, N1b, K1, and K3 where the core takes
it), so the sampler as the core's rest (on an older tree's fused route
the park too), the round test (N5, on this tree with the round's tail:
the depth step, and the cap and park after K1) and the bookkeeping as the
rounds' rest. Each round body runs back to back behind a held stream and is timed
by CUDA event pairs, so its host cost is not in the numbers; the sticky K5
loop has no such bodies. ``--root TREE`` loads the package from
another tree (a parent unpacked with ``git archive``), so that one script
splits both.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys

import torch

import chip_smoke as CS

ROOT = os.path.dirname(os.path.abspath(__file__))

HOLD_MS = 60.0  # the stream held before each round body: longer than the host's enqueue


class StageTimer:
    """CUDA event pairs around the stages of the lane rounds, summed by
    stage. Before each round body (``CoreBody``, ``RefillBody`` and
    ``StickyBody`` calls) a spin kernel holds the stream
    (``chip_smoke.hold_stream``), so the host enqueues the whole body before
    the card starts it and the card then runs it back to back: each pair
    spans device time only, not the host's way to the launches."""

    def __init__(self):
        self.pairs: dict = {}

    def wrap(self, fn, name: str, hold: bool = False):
        def call(*a, **kw):
            if hold:
                CS.hold_stream(HOLD_MS)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            self.pairs.setdefault(name, []).append((start, end))
            return out
        return call

    def ms(self) -> dict:
        torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in v) for k, v in self.pairs.items()}


@contextlib.contextmanager
def stage_timer():
    """While active, the lane rounds' stages are timed (``StageTimer``):
    ``body`` (each round body), ``refill`` (``RefillBody.__call__``, N2a on
    a card since it has one), ``restart`` (``StickyBody.restart``), ``core``
    (the bounce, made while active), ``kernel`` (each kernel wrapper the
    core calls: the nearest hit, N1a, N1b, K3 and K1) and ``test`` (the
    round's tail and test, N5, a body of its own)."""
    from raytracing_course_2024_tpu_torch.integrator import path as P
    from raytracing_course_2024_tpu_torch.integrator import wavefront as W
    from raytracing_course_2024_tpu_torch.ops import bounce as B

    timer = StageTimer()
    saved = []

    def patch(obj, attr, wrapped):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, wrapped)

    for cls in (W.CoreBody, W.StickyBody):
        patch(cls, "__call__", timer.wrap(cls.__call__, "body", hold=True))
    refill = W.RefillBody.__call__
    patch(W.RefillBody, "__call__", timer.wrap(timer.wrap(refill, "refill"), "body", hold=True))
    patch(W.StickyBody, "restart", timer.wrap(W.StickyBody.restart, "restart"))
    for name in ("WavefrontLoop", "StickyLoop"):  # the round test, N5 (trees with the device loop)
        cls = getattr(W, name, None)
        if cls is not None:
            patch(cls, "test", timer.wrap(timer.wrap(cls.test, "test"), "body", hold=True))
    make = W._make_bounce_core

    def make_timed(*a, **kw):
        core, fused = make(*a, **kw)
        return timer.wrap(core, "core"), fused

    patch(W, "_make_bounce_core", make_timed)
    for mod, name in ((W, "nearest_table"), (W, "shade"), (W, "finish"),
                      (P, "sample_mixture_kernel"), (B, "bounce")):
        patch(mod, name, timer.wrap(getattr(mod, name), "kernel"))
    try:
        yield timer
    finally:
        for obj, attr, fn in reversed(saved):
            setattr(obj, attr, fn)


def stage_split(desc, engine: str, seed: int = 1) -> dict:
    """Device ms of one eager frame of ``engine`` by stage of its rounds
    (``stage_timer``): ``rounds_ms`` (every round body), ``refill_or_restart``,
    ``kernels``, ``sampler`` (the core less its kernels), ``round_test`` and
    ``bookkeeping`` (the bodies less all of those)."""
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer

    r = Renderer(desc, device="cuda", engine=engine, eager=True)
    r.render_frame_device(seed=0)  # warm-up: kernel build, allocator
    with stage_timer() as timer:
        r = Renderer(desc, device="cuda", engine=engine, eager=True)
        r.render_frame_device(seed=seed)
        ms = timer.ms()
    refill = ms.get("refill", 0.0) + ms.get("restart", 0.0)
    core, kern, test = ms.get("core", 0.0), ms.get("kernel", 0.0), ms.get("test", 0.0)
    return {"rounds_ms": ms["body"], "refill_or_restart": refill, "kernels": kern,
            "sampler": core - kern, "round_test": test,
            "bookkeeping": ms["body"] - core - refill - test, "rounds": r.rounds}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rr", action="store_true", help="Russian roulette: the modular path")
    ap.add_argument("--engine", choices=("batch", "sticky", "wavefront"), default="batch")
    ap.add_argument("--bvh", action="store_true", help="the 81,920-triangle BVH scene")
    ap.add_argument("--eager", action="store_true",
                    help="also profile eager=True frames, in turns with the graphed ones")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--stages", action="store_true",
                    help="a lane engine's eager frame split by the stage of its round")
    ap.add_argument("--root", default=ROOT, help="tree that holds the package to profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_frame: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer
    from raytracing_course_2024_tpu_torch.scene import load_scene

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0])
    if args.bvh:
        desc = CS.bvh_desc(1280, 720, 16)
    else:
        desc = load_scene(os.path.join(ROOT, "scenes", "cornell_box.gltf"), 1280, 720, 16)
    if args.stages:
        split = stage_split(desc, args.engine)
        print(f"stages root={args.root} engine={args.engine} rounds={split.pop('rounds')} "
              + " ".join(f"{k}={v:.3f}" for k, v in split.items()))
        return 0
    kw = dict(device="cuda", russian_roulette=args.rr, engine=args.engine)
    rs = {"graphed": Renderer(desc, **kw)}
    if args.eager:
        rs["eager"] = Renderer(desc, eager=True, **kw)
    for r in rs.values():
        r.render_frame_device(seed=0)  # warm-up: kernel build, allocator, graph capture
    order = ("eager", "graphed", "graphed", "eager") if args.eager else ("graphed",)
    for seed, mode in enumerate(order, start=1):
        r = rs[mode]
        p = CS.profiled_frame(r, seed)
        torch.cuda.synchronize()
        with CS.host_reads() as waits:  # the same frame again, unprofiled
            r.render_frame_device(seed=seed)
        rounds = "" if r.engine == "batch" else f" rounds={r.rounds}"
        print(f"mode={mode} backend={r.backend} engine={r.engine} "
              f"path={'fused' if r.fused else 'modular'} graphed={r.graphs is not None} "
              f"wall_ms={p['wall_ms']:.3f} device_ms={p['device_ms']:.3f} "
              f"busy_share={p['busy_share']:.3f} host_reads={waits[0]} "
              f"launches={p['launches']} path_vertices={int(p['path_vertices'])}{rounds}")
        for ms, n, key in p["rows"][: args.top]:
            print(f"  {ms:10.3f} ms {n:6d} x  {key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
