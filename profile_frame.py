"""Where the device time of one Cornell or BVH frame goes, on one CUDA card.

    python3 profile_frame.py                    # batch engine, fused path (K2, K1, K1-final)
    python3 profile_frame.py --rr               # batch engine, modular path (K4, K3)
    python3 profile_frame.py --engine sticky    # one K5 per round
    python3 profile_frame.py --engine wavefront # K1 in lane mode + refills
    python3 profile_frame.py --bvh --engine E   # the BVH scene on engine E (K6)

Renders scenes/cornell_box.gltf (with ``--bvh``: chip_smoke.py's
81,920-triangle BVH scene) at 1280x720 x 16 spp through the port's
Renderer: one warm-up frame, then one frame under torch.profiler. Prints
the card's name and power limit, the profiled frame's wall ms, the summed
device ms and its share of the wall time (the device's busy share), the
lane engines' rounds, then device ms and launch counts per kernel name,
largest first. The profiler itself slows the host, so the busy share of an
unprofiled frame is higher.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rr", action="store_true", help="Russian roulette: the modular path")
    ap.add_argument("--engine", choices=("batch", "sticky", "wavefront"), default="batch")
    ap.add_argument("--bvh", action="store_true", help="the 81,920-triangle BVH scene")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_frame: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from raytracing_course_2024_tpu_torch.runtime.render import Renderer
    from raytracing_course_2024_tpu_torch.scene import load_scene

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0])
    if args.bvh:
        from chip_smoke import bvh_desc

        desc = bvh_desc(1280, 720, 16)
    else:
        desc = load_scene(os.path.join(ROOT, "scenes", "cornell_box.gltf"), 1280, 720, 16)
    r = Renderer(desc, device="cuda", russian_roulette=args.rr, engine=args.engine)
    r.render_frame_device(seed=0)  # warm-up: kernel build, allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, verts = r.render_frame_device(seed=1)
        wall = (time.perf_counter() - t0) * 1e3
    rows = []  # device-side events only: kernels, memsets, copies
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    busy = sum(ms for ms, _, _ in rows)
    rounds = "" if r.engine == "batch" else f" rounds={r.rounds}"
    print(f"backend={r.backend} engine={r.engine} path={'fused' if r.fused else 'modular'} "
          f"wall_ms={wall:.3f} "
          f"device_ms={busy:.3f} busy_share={busy / wall:.3f} "
          f"launches={sum(n for _, n, _ in rows)} path_vertices={int(verts)}{rounds}")
    for ms, n, key in rows[: args.top]:
        print(f"  {ms:10.3f} ms {n:6d} x  {key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
