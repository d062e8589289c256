"""Where the device time of one Cornell or BVH frame goes, on one CUDA card.

    python3 profile_frame.py                    # batch engine, fused path (K2, K1, K1-final)
    python3 profile_frame.py --rr               # batch engine, modular path (K4, K3)
    python3 profile_frame.py --engine sticky    # one K5 per round
    python3 profile_frame.py --engine wavefront # K1 in lane mode + refills
    python3 profile_frame.py --bvh --engine E   # the BVH scene on engine E (K6)
    python3 profile_frame.py --bvh --eager      # graphed and eager frames in turns

Renders scenes/cornell_box.gltf (with ``--bvh``: chip_smoke.py's
81,920-triangle BVH scene) at 1280x720 x 16 spp through the port's
Renderer: one warm-up frame (it captures the CUDA graphs of every engine
but the sticky K5 loop, on both routes), then one frame
under torch.profiler (``chip_smoke.profiled_frame``). ``--eager`` profiles
the same renderer with ``eager=True`` too, in turns: eager, graphed,
graphed, eager. Prints the card's name and power limit, each profiled
frame's mode, wall ms, the summed device ms and its share of the wall time
(the device's busy share), the lane engines' rounds, then device ms and
launch counts per kernel name, largest first. The profiler itself slows the
host, so the busy share of an unprofiled frame is higher.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

import chip_smoke as CS

ROOT = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rr", action="store_true", help="Russian roulette: the modular path")
    ap.add_argument("--engine", choices=("batch", "sticky", "wavefront"), default="batch")
    ap.add_argument("--bvh", action="store_true", help="the 81,920-triangle BVH scene")
    ap.add_argument("--eager", action="store_true",
                    help="also profile eager=True frames, in turns with the graphed ones")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_frame: no CUDA device", file=sys.stderr)
        return 1
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer
    from raytracing_course_2024_tpu_torch.scene import load_scene

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0])
    if args.bvh:
        desc = CS.bvh_desc(1280, 720, 16)
    else:
        desc = load_scene(os.path.join(ROOT, "scenes", "cornell_box.gltf"), 1280, 720, 16)
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
        rounds = "" if r.engine == "batch" else f" rounds={r.rounds}"
        print(f"mode={mode} backend={r.backend} engine={r.engine} "
              f"path={'fused' if r.fused else 'modular'} graphed={r.graphs is not None} "
              f"wall_ms={p['wall_ms']:.3f} device_ms={p['device_ms']:.3f} "
              f"busy_share={p['busy_share']:.3f} launches={p['launches']} "
              f"path_vertices={int(p['path_vertices'])}{rounds}")
        for ms, n, key in p["rows"][: args.top]:
            print(f"  {ms:10.3f} ms {n:6d} x  {key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
