"""GPU smoke test of the PyTorch/CUDA port (raytracing_course_2024_tpu_torch).

    python3 chip_smoke.py            # one CUDA card

Phases (each prints one line; any failure raises and exits non-zero):

1. device   -- a CUDA card is required; prints ``nvidia-smi`` name and
               power limit;
2. build    -- builds the kernels of csrc/ with nvcc (sm_90a) and prints the
               build time and the ptxas register / spill lines;
3. kernels  -- every kernel against its plain PyTorch version on the card,
               same counter draws, 262,144 lanes, on the inline MIXED text
               scene and the in-repo Cornell glTF: K2, then 3 x K1, then K1
               final_only, each fed the plain version's previous state;
4. main     -- the port's CLI renders scenes/cornell_box.gltf at 1280x720,
               16 spp; launch counters must match the path exactly;
5. render   -- a 320x180 x 16 spp frame through the kernels against the same
               frame through the plain versions;
6. timing   -- kernel against plain once more at the main path's shapes
               (921,600 lanes); median of 3 frames (kernels and plain), ms
               per launch of each kernel from CUDA events, path vertices,
               Mrays/s, peak memory.

The last two lines are the per-kernel JSON record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# kernels vs plain: per launch, on >= 99.9 % of lanes (far hits 1e5 units
# away and grazing accept or Fresnel decisions may differ on a few lanes)
ATOL = RTOL = 1e-4
LANE_FRAC = 0.999
# whole frames, kernels vs plain, linear radiance
PIX_ATOL = 1e-3
PIX_FRAC = 0.99

MIXED_SCENE = """
DIMENSIONS 32 24
RAY_DEPTH 4
SAMPLES 4
BG_COLOR 0.1 0.15 0.2
CAMERA_POSITION 0 0 9
CAMERA_RIGHT 1 0 0
CAMERA_UP 0 1 0
CAMERA_FORWARD 0 0 -1
CAMERA_FOV_X 1.2

NEW_PRIMITIVE
PLANE 0 1 0
POSITION 0 -3 0
COLOR 0.7 0.7 0.7

NEW_PRIMITIVE
PLANE 1 0 0
POSITION -4 0 0
ROTATION 0 0 0.1305262 0.9914449
COLOR 0.8 0.3 0.3

NEW_PRIMITIVE
BOX 1 1.5 1
POSITION -1.5 -1.5 0
ROTATION 0 0.3826834 0 0.9238795
COLOR 0.3 0.8 0.3
METALLIC

NEW_PRIMITIVE
ELLIPSOID 1.2 0.8 1.2
POSITION 1.8 -1.8 1
COLOR 0.9 0.9 0.9
DIELECTRIC
IOR 1.5

NEW_PRIMITIVE
BOX 1.2 0.1 1.2
POSITION 0 2.8 0
EMISSION 4 4 4

NEW_PRIMITIVE
TRIANGLE -3 -2 2  -1 -2 3  -2 0 2.5
COLOR 0.4 0.4 0.9
"""

ROOT = os.path.dirname(os.path.abspath(__file__))
CORNELL = os.path.join(ROOT, "scenes", "cornell_box.gltf")
TPU_SRC = "raytracing_course_2024_tpu/ops/pallas_bounce.py"
KERNELS = {  # name -> replaced TPU kernel (file:line of the kernel body)
    "primary": f"{TPU_SRC}:515",
    "bounce": f"{TPU_SRC}:421",
    "final": f"{TPU_SRC}:421",
}
SOURCE = "raytracing_course_2024_tpu_torch/csrc/bounce.cu"


def say(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn`` (same inputs each call): one warm-up,
    then ``reps`` calls back to back between two CUDA events."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_states(kern: torch.Tensor, plain: torch.Tensor, what: str) -> dict:
    """Kernel vs plain (13, B) states: alive masks, and each of the 12 float
    rows on lanes where both are alive; radiance also on every lane."""
    ak, ap = kern[12] > 0.5, plain[12] > 0.5
    alive_agree = (ak == ap).float().mean().item()
    both = ak & ap
    worst, worst_frac, max_err = 0.0, 1.0, 0.0
    for r in range(12):
        rows = (kern[r], plain[r]) if r >= 9 else (kern[r][both], plain[r][both])
        if rows[0].numel() == 0:
            continue
        err = (rows[0] - rows[1]).abs()
        ok = err <= ATOL + RTOL * rows[1].abs()
        frac = ok.float().mean().item()
        worst_frac = min(worst_frac, frac)
        max_err = max(max_err, err.max().item())
        worst = max(worst, err.quantile(0.999).item() if err.numel() < 2**24 else 0.0)
    finite = bool(torch.isfinite(kern[6:12]).all().item())
    res = dict(alive_agree=round(alive_agree, 6), row_agree_min=round(worst_frac, 6),
               max_abs_err=max_err, p999_abs_err=worst, finite=finite,
               alive_frac=round(ap.float().mean().item(), 4))
    say("kernels", case=what, **res)
    if not (alive_agree >= LANE_FRAC and worst_frac >= LANE_FRAC and finite):
        raise SystemExit(f"kernel/plain mismatch in {what}: {res}")
    return res


def phase_kernels(dev) -> None:
    from raytracing_course_2024_tpu_torch.ops import bounce as B
    from raytracing_course_2024_tpu_torch.ops.camera import camera_arrays, pack_camera_row
    from raytracing_course_2024_tpu_torch.scene import (
        build_scene_arrays, load_scene, parse_text_scene)

    w = h = 512  # 262,144 lanes
    for name in ("mixed", "cornell"):
        desc = (parse_text_scene(MIXED_SCENE) if name == "mixed"
                else load_scene(CORNELL, w, h, 1))
        arrays, statics = build_scene_arrays(desc)
        scene = B.bounce_scene(arrays, statics, dev)
        cam = torch.from_numpy(pack_camera_row(camera_arrays(desc.settings.camera))[0]).to(dev)
        bg = tuple(desc.settings.bg_color)
        idx = torch.arange(w * h, device=dev, dtype=torch.int32)
        px, py = (idx % w).float(), (idx // w).float()
        seed = 20240917
        st_k = B.primary_bounce(scene, cam, px, py, idx, 0, seed, bg, 4, w, h)
        st_p = B.primary_plain(scene, cam, px, py, idx, 0, seed, bg, 4, w, h)
        torch.cuda.synchronize()
        compare_states(st_k, st_p, f"{name}:primary")
        for i in range(1, 4):
            k = B.bounce(scene, st_p.clone(), idx, 0, seed, i, bg, 4)
            nxt = B.bounce_plain(scene, st_p, idx, 0, seed, i, bg, 4)
            torch.cuda.synchronize()
            compare_states(k, nxt, f"{name}:bounce{i}")
            st_p = nxt
        k = B.bounce(scene, st_p.clone(), idx, 0, seed, 4, bg, 4, final_only=True)
        p = B.bounce_plain(scene, st_p, idx, 0, seed, 4, bg, 4, final_only=True)
        torch.cuda.synchronize()
        compare_states(k, p, f"{name}:final")


def phase_main(dev, tmp: str) -> None:
    from raytracing_course_2024_tpu_torch.ops import bounce as B
    from raytracing_course_2024_tpu_torch.runtime import cli
    from raytracing_course_2024_tpu_torch.runtime.image_io import read_png, read_ppm

    w, h, spp, depth = 1280, 720, 16, 6  # glTF ray_depth is 6
    ppm, png = os.path.join(tmp, "cornell.ppm"), os.path.join(tmp, "cornell")
    B.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main([CORNELL, str(w), str(h), str(spp), ppm, png])
    secs = time.perf_counter() - t0
    counts = dict(B.LAUNCHES)
    if rc != 0:
        raise SystemExit(f"CLI returned {rc}")
    batches = 1  # 921,600 lanes fit one batch (DEFAULT_BATCH)
    want = {"primary": spp * batches, "bounce": spp * (depth - 2) * batches,
            "final": spp * batches}
    if counts != want:
        raise SystemExit(f"launch counters {counts} != expected {want}")
    img = read_ppm(ppm)
    if img.shape != (h, w, 3) or img.std() == 0:
        raise SystemExit(f"bad image: shape {img.shape}, std {img.std()}")
    if not np.array_equal(img, read_png(png + ".png")):
        raise SystemExit("PPM and PNG disagree")
    say("main", scene="cornell_box.gltf", size=f"{w}x{h}", spp=spp, seconds=round(secs, 3),
        launches=json.dumps(counts).replace(" ", ""), mean_u8=round(float(img.mean()), 3))
    return counts


def phase_render(dev) -> None:
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer
    from raytracing_course_2024_tpu_torch.scene import load_scene

    desc = load_scene(CORNELL, 320, 180, 16)
    a = Renderer(desc, device=dev).render_radiance(seed=3)
    b = Renderer(desc, device=dev, plain=True).render_radiance(seed=3)
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        raise SystemExit("non-finite radiance")
    agree = float((np.abs(a - b) <= PIX_ATOL).all(axis=-1).mean())
    say("render", size="320x180", spp=16, pixel_agree=round(agree, 6),
        max_abs_err=float(np.abs(a - b).max()), mean=round(float(a.mean()), 5))
    if agree < PIX_FRAC:
        raise SystemExit(f"kernel and plain renders agree on {agree:.4f} < {PIX_FRAC}")


def phase_timing(dev, gpu: str, counts: dict) -> list:
    from raytracing_course_2024_tpu_torch.ops import bounce as B
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer
    from raytracing_course_2024_tpu_torch.scene import load_scene

    w, h, spp = 1280, 720, 16
    desc = load_scene(CORNELL, w, h, spp)
    frame = {}
    for plain in (False, True):
        r = Renderer(desc, device=dev, plain=plain)
        r.render_frame_device(seed=0)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        times, verts = [], 0.0
        for rep in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, verts = r.render_frame_device(seed=rep + 1)
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        frame[plain] = ms
        say("timing", path="plain" if plain else "kernels", ms_per_frame=round(ms, 3),
            path_vertices=int(verts), mrays_per_s=round(verts / ms / 1e3, 3),
            peak_mem_mb=round(torch.cuda.max_memory_allocated() / 2**20, 1), gpu=f'"{gpu}"')

    # the main path's shapes: one 921,600-lane batch of the Cornell frame
    r = Renderer(desc, device=dev)
    scene, cam, bg = r.scene, r.cam_row, r.bg
    n = w * h
    idx = torch.arange(n, device=dev, dtype=torch.int32)
    px, py = (idx % w).float(), (idx // w).float()
    # kernel vs plain at the main path's shapes, from the same inputs
    st0 = B.primary_bounce(scene, cam, px, py, idx, 0, 1, bg, 4, w, h)
    p0 = B.primary_plain(scene, cam, px, py, idx, 0, 1, bg, 4, w, h)
    k1 = B.bounce(scene, p0.clone(), idx, 0, 1, 1, bg, 4)
    p1 = B.bounce_plain(scene, p0, idx, 0, 1, 1, bg, 4)
    kf = B.bounce(scene, p1.clone(), idx, 0, 1, 5, bg, 4, final_only=True)
    pf = B.bounce_plain(scene, p1, idx, 0, 1, 5, bg, 4, final_only=True)
    torch.cuda.synchronize()
    errs = {k: compare_states(a, b, f"cornell-{w}x{h}:{k}") for k, a, b in
            (("primary", st0, p0), ("bounce", k1, p1), ("final", kf, pf))}
    # each kernel reads st0 (or the pixels) and writes a separate buffer, so
    # every launch does the same work
    buf = torch.empty_like(st0)
    launch_ms = {
        "primary": cuda_ms(lambda: B.primary_bounce(
            scene, cam, px, py, idx, 0, 1, bg, 4, w, h, out=buf), 20),
        "bounce": cuda_ms(lambda: B.bounce(
            scene, st0, idx, 0, 1, 1, bg, 4, out=buf), 20),
        "final": cuda_ms(lambda: B.bounce(
            scene, st0, idx, 0, 1, 1, bg, 4, final_only=True, out=buf), 20),
    }
    plain_ms = {
        "primary": cuda_ms(lambda: B.primary_plain(
            scene, cam, px, py, idx, 0, 1, bg, 4, w, h), 2),
        "bounce": cuda_ms(lambda: B.bounce_plain(scene, st0, idx, 0, 1, 1, bg, 4), 2),
        "final": cuda_ms(lambda: B.bounce_plain(
            scene, st0, idx, 0, 1, 1, bg, 4, final_only=True), 2),
    }
    alive = (st0[12] > 0.5).float().mean().item()
    for k in KERNELS:
        say("timing", kernel=k, lanes=n, alive_in=round(alive, 4) if k != "primary" else 1.0,
            ms=round(launch_ms[k], 4), plain_ms=round(plain_ms[k], 3), gpu=f'"{gpu}"')
    tol = f"atol=rtol={ATOL} on >= {LANE_FRAC:.1%} of lanes"
    return [
        {"name": k, "route": "cuda", "source": SOURCE, "replaces": KERNELS[k],
         "launches": counts[k], "max_abs_err": errs[k]["max_abs_err"],
         "lanes_agree": errs[k]["row_agree_min"], "tolerance": tol,
         "ms": launch_ms[k], "plain_ms": plain_ms[k], "lanes": n,
         "frame_ms": frame[False], "plain_frame_ms": frame[True]}
        for k in KERNELS
    ]


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    print(gpu, flush=True)
    say("device", name=f'"{torch.cuda.get_device_name(0)}"', count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build (the package is imported only now: a lone chip_smoke.py fails here)
    from raytracing_course_2024_tpu_torch.ops import kernels

    kernels.library()
    info = kernels.BUILD_INFO
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if re.search(r"registers|spill|Compiling entry", ln)]
    say("build", seconds=round(info["seconds"], 2), lib=os.path.basename(info["path"]))
    for ln in ptxas:
        print(f"[build] {ln}", flush=True)

    phase_kernels(dev)
    with tempfile.TemporaryDirectory() as tmp:
        counts = phase_main(dev, tmp)
    phase_render(dev)
    record = phase_timing(dev, gpu, counts)
    print(json.dumps({"kernels": record}), flush=True)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
    if leaked:
        raise SystemExit(f"the port imported {leaked}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
