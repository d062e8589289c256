"""Two trees, or one tree twice, timed by ``chip_smoke.py``'s own harness on
one CUDA card.

    python3 kernel_times.py --label change
    python3 kernel_times.py --root _scratch_tree/parent --label parent

Loads ``raytracing_course_2024_tpu_torch`` from ``--root`` (default: the
directory of this script; for the default timings a tree whose camera stage
has its plain version ``ops/camera.py:camera_state_plain``; ``--camera-stage``,
``--modular-frames``, ``--lane-frames`` and ``--bvh-turns`` take older trees
too), builds its kernels, and
calls the functions of the ``chip_smoke.py`` beside this script on scenes/cornell_box.gltf at
1280x720 x 16 spp (one 921,600-lane batch): ``launch_times`` (ms per launch
of every kernel, K1, K1-final and K5 in place and into a separate buffer;
K5 on the sticky frame's state after 10 rounds; K4 and K3 on the camera and
the bounce-1 state, an event pair per launch while the stream is held, K4
with and without the live mask where the tree has one; K1 and K2 given the
seed and the work-id offset as the graphed routes hand them over, a device
pair, or ints on a tree whose kernels take them by value:
``chip_smoke.route_pair``), ``modular_levels``
(K4 and K3 level by level on the states of one sample of the modular path),
K1 level by level on the states of one sample (``cuda_ms``,
``cuda_ms_in_place``), ``persistent_rounds`` (K5 round by round over a
sticky frame) and ``frame_times`` (median host ms of ``--frames`` frames of
the batch engine's fused and modular paths and of the sticky and wavefront
engines, with their path-vertex totals; ``--frames 0`` leaves the frames and
the round-by-round pass out). ``--bvh-turns N`` times only the
81,920-triangle BVH frame of ``chip_smoke.bvh_desc`` on the three engines
and on the tree's default engine (as the CLI renders it), one frame per
engine in turn, N times, then one frame each whose waits on the card are
counted (``bvh_engine_turns``).
``--bvh-kernel`` times only K6, per launch, on the 921,600 camera and
bounce-1 rays of that BVH frame with their live masks (``bvh_state``,
``bvh_launch_times`` without the walk models), and prints the launch
geometry (K6's stack, shared bytes, resident blocks).
``--modular-frames`` profiles only the four frames whose bounce is the
modular one (the BVH frame on the three engines, the Cornell frame with
roulette), graphed, and the two batch ones also eagerly, ``--frames``
profiled frames each after a warm-up
(``chip_smoke.profiled_frame``: wall and device ms, busy share, launches,
the image's digest, N1a's, N1b's and N4's device ms and launches summed over
the frame, and those of the rows that name no hand-written kernel: the ATen
ops), then
the sum of the bounds of the N1a and N1b launches of the frame of seed 1
(``chip_smoke.n1_frame_bounds``, on its eager twin): the launch-weighted
share is that sum over seed 1's frame-summed ms.
``--lane-frames`` times only the five lane frames (the BVH frame on the
counter wavefront and the sticky engine, the Cornell frame on the counter
wavefront's fused route, on the sticky engine's fused route below one
lane per pixel, 262,144 lanes, and on its K5 route), graphed, ``--frames``
seeds each after a warm-up: an unprofiled frame's host ms, the waits on
the card of a frame (``host_reads``), and a profiled frame's device ms,
busy share, launches and device ms and launches of each hand-written
kernel by name; the idle share of the unprofiled frame, rounds, path
vertices and the image's digest; the BVH frames also print the ATen ops
one round dispatches beside its kernels (``tree_round_ops``), on older
trees too. ``--sweep-rounds 4,8,16`` times only those five frames at each count of
rounds per replay of the lane loops, in turns (``sweep_rounds``).
``--lane-kernels``
holds and times only N2a, N2b and K3 in lane mode on the BVH lane engines'
states (``chip_smoke.phase_kernels_round``; a tree without them has
nothing to time).
``--lane-kernel-parts`` times only variants of N2a and N2b, each built from
the tree's ``csrc/refill.cu`` with a few lines replaced (``LANE_PARTS``),
on the BVH lane engines' round-10 states and N2b also on its 262,144-lane
state (``lane_kernel_parts``): the
kernels as built, then parts dropped or redesign items switched, in turns
(the variants forward, backward, forward, backward, then each one's
median); a variant whose lines the tree does not hold is named and left
out.
``--loop-kernel`` times only N5: the test alone per launch on 1,048,576
and 262,144 lanes in both lane modes (``chip_smoke.loop_times``), then the
end of the fused lane rounds on the Cornell counter wavefront's and
262,144-lane sticky frame's round-10 states (``chip_smoke.tail_times``):
the ATen steps and the test the round ran before N5 took its tail over,
and N5's fused tail where the tree has it, with whether K1 wrote the rays
of the lanes dead on entry through unchanged. ``--loop-kernel-parts``
times variants of N5 (``LOOP_PARTS``: ``csrc/loop.cu`` with lines
replaced) on the same cases, in turns.
``--camera-stage`` times only the modular route's camera stage on the
Cornell frame's 921,600 lanes (``camera_stage``): the ATen ops of the route
before N4, and N4 where the tree has it.
``--shade-kernels`` times only N1a and N1b, per launch in place, on the
BVH frame's 921,600-lane camera, bounce-1 and bounce-3 states
(``chip_smoke.n1_states``, ``shade_times``) with their bounds.
``--sector-writes`` times only the store pattern N1a and N1b are built
around (``sector_writes``): 13 float rows of 921,600 lanes written on a
random share of the lanes, each lane alone (32-byte sectors written in
part) against every lane of an 8-lane group that holds one (sectors
written whole: zeros from the others, or their own values read back
first), the L2 cache flushed before each launch.
``--cornell-engines wavefront,...`` times only the Cornell frames of those
engines (``frame_times``: median host ms of ``--frames`` frames, path
vertices, rounds and the frame's peak device memory). ``--eager`` adds to
every frame timing the same renderer with ``eager=True`` (no CUDA graphs),
the two taken in turns in one process (``frames_in_turns``); frames are
graphed by default. Prints the card's
name, power limit and clocks, the ptxas lines of the kernels and one line
per number. Two runs
are comparable only on one card, one right after the other: run parent,
change, change, parent.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

import torch

import chip_smoke as CS  # this tree's harness, whichever tree is timed


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=CS.ROOT, help="tree that holds the package to time")
    ap.add_argument("--label", default="change")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--modular-only", action="store_true",
                    help="K4 and K3 only: both states and level by level")
    ap.add_argument("--bvh-turns", type=int, default=0,
                    help="only the 81,920-triangle BVH frame on the three engines, "
                         "one frame each in turn, this many times")
    ap.add_argument("--bvh-kernel", action="store_true",
                    help="only K6 per launch on the BVH frame's camera and bounce-1 rays")
    ap.add_argument("--cornell-engines", default="",
                    help="only the Cornell frames of these engines (comma-separated "
                         "batch, sticky, wavefront), --frames frames each")
    ap.add_argument("--eager", action="store_true",
                    help="time each frame also with eager=True, in turns with the graphed one")
    ap.add_argument("--modular-frames", action="store_true",
                    help="only the four frames of the modular bounce (BVH batch, Cornell "
                         "modular with roulette, BVH wavefront, BVH sticky), graphed, --frames "
                         "profiled frames each")
    ap.add_argument("--sector-writes", action="store_true",
                    help="only masked row writes against whole-sector ones, 921,600 lanes")
    ap.add_argument("--lane-frames", action="store_true",
                    help="only the five lane frames, graphed, --frames seeds each")
    ap.add_argument("--sweep-rounds", default="",
                    help="only the five lane frames at each of these rounds per replay "
                         "(e.g. 4,8,16), in turns, --frames frames each")
    ap.add_argument("--lane-kernels", action="store_true",
                    help="only N2a, N2b and K3 in lane mode on the BVH lane engines' states")
    ap.add_argument("--lane-kernel-parts", action="store_true",
                    help="only variants of N2a and N2b (parts dropped, items switched) on "
                         "the BVH lane engines' round-10 states")
    ap.add_argument("--loop-kernel", action="store_true",
                    help="only N5: the test alone on 1,048,576 and 262,144 lanes, and the end "
                         "of the fused lane rounds on the Cornell frames' round-10 states")
    ap.add_argument("--loop-kernel-parts", action="store_true",
                    help="only variants of N5 (design items switched) on the states of "
                         "--loop-kernel")
    ap.add_argument("--shade-kernels", action="store_true",
                    help="only N1a and N1b per launch on the BVH frame's camera, bounce-1 "
                         "and bounce-3 states")
    ap.add_argument("--camera-stage", action="store_true",
                    help="only the modular route's camera stage on 921,600 lanes: its ATen "
                         "ops, and N4 where the tree has it")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from raytracing_course_2024_tpu_torch.ops import bounce as B
    from raytracing_course_2024_tpu_torch.ops import kernels
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer
    from raytracing_course_2024_tpu_torch.scene import load_scene

    def say(**kw):
        CS.say(args.label, **kw)

    gpu = CS.gpu_line()
    say(gpu=f'"{gpu}"', clocks=f'"{CS.clocks_line()}"', root=root)
    kernels.library()
    entry = ""
    for ln in kernels.BUILD_INFO["log"].splitlines():
        if "Compiling entry" in ln:
            entry = re.sub(r".*function '([^']*)'.*", r"\1", ln)
        elif re.search(r"Used \d+ registers|spill", ln) and re.search(
                r"bounce|primary|persistent|nearest|sampler|bvh|shade|finish|refill|restart",
                entry):
            say(ptxas=entry, line=f'"{ln.split(":", 1)[-1].strip()}"')

    dev = torch.device("cuda", 0)
    w, h, spp = CS.FRAME
    if args.bvh_kernel:
        say(geometry=json.dumps(kernels.launch_geometry()).replace(" ", ""))
        r = Renderer(CS.bvh_desc(w, h, spp), device=dev)
        CS.bvh_launch_times(r, gpu, CS.bvh_state(r, w * h, plain=False), args.reps, args.label,
                            models=False)
        return 0
    if args.camera_stage:
        camera_stage(dev, load_scene(CS.CORNELL, w, h, spp), say, args.reps)
        return 0
    if args.modular_frames:
        modular_frames(dev, CS.bvh_desc(w, h, spp), load_scene(CS.CORNELL, w, h, spp),
                       args.frames, say)
        return 0
    if args.lane_frames:
        lane_frames(dev, CS.bvh_desc(w, h, spp), load_scene(CS.CORNELL, w, h, spp),
                    args.frames, say)
        return 0
    if args.sweep_rounds:
        sweep_rounds(dev, CS.bvh_desc(w, h, spp), load_scene(CS.CORNELL, w, h, spp),
                     [int(x) for x in args.sweep_rounds.split(",")], args.frames, say)
        return 0
    if args.lane_kernels:
        if not os.path.exists(os.path.join(root, "raytracing_course_2024_tpu_torch", "ops",
                                           "refill.py")):
            say(lane_kernels="none in this tree")
            return 0
        CS.phase_kernels_round(dev, gpu)
        return 0
    if args.lane_kernel_parts:
        lane_kernel_parts(dev, root, gpu, say, args.reps)
        return 0
    if args.loop_kernel:
        loop_kernel(dev, load_scene(CS.CORNELL, w, h, spp), gpu, say, args.reps)
        return 0
    if args.loop_kernel_parts:
        loop_kernel_parts(dev, root, load_scene(CS.CORNELL, w, h, spp), gpu, say, args.reps)
        return 0
    if args.sector_writes:
        sector_writes(dev, say, args.reps)
        return 0
    if args.shade_kernels:
        scene, cfg, camera = CS.n1_scene(dev, "bvh81920", w, h)
        wid, _, states = CS.n1_states(dev, scene, cfg, camera, w, h, deep=True)
        n1 = {name: CS.n1_timing_case(states[name], scene, cfg, wid, level)
              for name, level in CS.N1_LEVELS.items()}
        CS.shade_times(dict(n1, scene=scene, cfg=cfg, wid=wid), gpu, args.reps, args.label)
        return 0
    if args.bvh_turns > 0:
        CS.bvh_engine_turns(dev, gpu, CS.bvh_desc(w, h, spp), args.bvh_turns, args.label,
                            eager=args.eager)
        return 0
    desc = load_scene(CS.CORNELL, w, h, spp)

    def frames(path: str, **kw) -> None:
        """``--frames`` frames of a Cornell renderer (and its eager twin)."""
        r = Renderer(desc, device=dev, **kw)
        if not args.eager:
            CS.frame_times(r, f"{args.label}-{path}", gpu, reps=args.frames)
            return
        CS.frames_in_turns({path: r, f"{path}-eager": Renderer(desc, device=dev, eager=True,
                                                               **kw)},
                           gpu, args.frames, args.label)

    if args.cornell_engines:
        for engine in args.cornell_engines.split(","):
            frames(engine, engine=engine)
        return 0
    r = Renderer(desc, device=dev)
    scene, cam, bg = r.scene, r.cam_row, r.bg
    idx = torch.arange(w * h, device=dev, dtype=torch.int32)
    seed_t, off_t = CS.route_pair(1, 0, dev)  # as the graphed routes launch K1 and K2
    st0 = B.primary_bounce(scene, cam, (idx % w).float(), (idx // w).float(), idx, off_t,
                           seed_t, bg, CS.K, w, h)
    ins, st5, args5 = CS.sticky_inputs(dev, desc, w, h, spp)
    from raytracing_course_2024_tpu_torch.ops.loop import LoopState
    from raytracing_course_2024_tpu_torch.ops.persistent import persistent_round

    ls, k5 = LoopState(dev), CS.k5_args(args5, dev)
    for _ in range(CS.K5_CHAIN):
        persistent_round(*ins, st5, ls, *k5, out=st5)
    m = CS.Modular(dev, desc, w, h, levels=True)
    if args.modular_only:
        CS.modular_times(m, gpu, args.reps, args.label)
        CS.modular_levels(m, gpu, args.reps, args.label)
        return 0
    ms, fresh, _ = CS.launch_times(scene, cam, bg, st0, idx, w, h, m, (ins, st5, args5),
                                   args.reps, gpu, args.label)
    for k, v in ms.items():
        say(kernel=k, lanes=w * h, ms=round(v, 4),
            **({"ms_fresh_buffer": round(fresh[k], 4)} if k in fresh else {}))
    CS.modular_levels(m, gpu, args.reps, args.label)

    # K1 level by level on the states of one sample of the batch engine, then
    # K1-final on the last: what each level of the frame costs
    depth = desc.settings.ray_depth
    states = [st0]
    for i in range(1, depth - 1):
        states.append(B.bounce(scene, states[-1], idx, off_t, seed_t, i, bg, CS.K))
    buf = torch.empty_like(st0)
    for i, st in enumerate(states, start=1):
        final = i == depth - 1
        t = CS.cuda_ms(lambda: B.bounce(scene, st, idx, off_t, seed_t, i, bg, CS.K,
                                        final_only=final, out=buf), args.reps)
        t_in = CS.cuda_ms_in_place(
            lambda: B.bounce(scene, buf, idx, off_t, seed_t, i, bg, CS.K, final_only=final,
                             out=buf),
            lambda: buf.copy_(st), args.reps)
        say(level=i, final_only=final, alive_in=round(float((st[12] > 0.5).float().mean()), 4),
            ms=round(t_in, 4), ms_fresh_buffer=round(t, 4))
    if args.frames < 1:
        return 0
    CS.persistent_rounds(dev, gpu, desc)
    for engine in ("batch", "sticky", "wavefront"):
        frames(engine, engine=engine)
    frames("batch-modular-rr", russian_roulette=True)
    return 0


# the hand-written kernels, by the names the profiler gives them: a device
# row that names none of them is an ATen op (or a copy or a fill)
HAND_WRITTEN = ("bounce_kernel", "primary_kernel", "persistent_kernel", "dense_nearest_kernel",
                "bvh_nearest_kernel", "sampler_kernel", "shade_kernel", "finish_kernel",
                "refill", "restart_kernel", "camera_kernel", "round_test_kernel",
                "round_tail_kernel", "set_condition_kernel")


def modular_frame_cases(bvh, cornell):
    """(name, scene, Renderer keywords) of ``modular_frames``: the four
    frames of the modular bounce, graphed; the two batch frames again
    eagerly."""
    return (("bvh-batch", bvh, {"engine": "batch"}),
            ("cornell-modular-rr", cornell, {"russian_roulette": True}),
            ("bvh-wavefront", bvh, {"engine": "wavefront"}),
            ("bvh-sticky", bvh, {"engine": "sticky"}),
            ("bvh-batch-eager", bvh, {"engine": "batch", "eager": True}),
            ("cornell-modular-rr-eager", cornell, {"russian_roulette": True, "eager": True}))


def modular_frames(dev, bvh, cornell, frames: int, say) -> None:
    """The frames whose bounce is the modular one: the BVH frame on the batch,
    wavefront and sticky engines and the Cornell frame on the batch engine
    with roulette, each graphed, and the others of ``modular_frame_cases``; a
    warm-up frame (it captures) and then
    ``frames`` frames under torch.profiler (``chip_smoke.profiled_frame``):
    wall ms, device ms, busy share, device launches, the image's digest,
    N1a's, N1b's and N4's device ms and launches, the device ms and launches
    of the rows outside the hand-written kernels (``HAND_WRITTEN``: the ATen
    ops), the largest rows; then, for the four graphed modular frames, the
    summed bound of N1a's and N1b's launches in the frame of seed 1."""
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer

    for name, desc, kw in modular_frame_cases(bvh, cornell):
        r = Renderer(desc, device=dev, **kw)
        r.render_frame_device(seed=0)
        n1_ms = {seed: _profiled(r, name, seed, say) for seed in range(1, frames + 1)}
        del r
        torch.cuda.empty_cache()
        if frames >= 1 and not kw.get("eager"):
            b = CS.n1_frame_bounds(desc, dev, 1, **kw)
            out = {}
            for k, tag in (("shade", "n1a"), ("finish", "n1b")):
                out.update({f"{tag}_launches": b[k]["launches"],
                            f"{tag}_bound_ms": round(b[k]["bound_ms"], 5),
                            f"{tag}_share": round(b[k]["bound_ms"] / n1_ms[1][k], 4)})
            say(frame=name, seed=1, **out)
            torch.cuda.empty_cache()


def _profiled(r, name: str, seed: int, say) -> dict:
    """One profiled frame of ``modular_frames``, printed; returns N1a's and
    N1b's device ms by kernel name."""
    p = CS.profiled_frame(r, seed)

    def rows(match):
        return [sum(x[i] for x in p["rows"] if match(x[2])) for i in (0, 1)]

    n1 = {k: rows(lambda key, k=k: f"{k}_kernel" in key) for k in ("shade", "finish")}
    cam = rows(lambda key: "camera_kernel" in key)
    aten = rows(lambda key: not any(k in key for k in HAND_WRITTEN))
    say(frame=name, seed=seed, wall_ms=round(p["wall_ms"], 3),
        device_ms=round(p["device_ms"], 3), busy_share=round(p["busy_share"], 4),
        device_launches=p["launches"], path_vertices=int(p["path_vertices"]),
        image_sha=p["image_sha"], **({} if r.engine == "batch" else {"rounds": r.rounds}),
        n1a_ms=round(n1["shade"][0], 4), n1a_launches=n1["shade"][1],
        n1b_ms=round(n1["finish"][0], 4), n1b_launches=n1["finish"][1],
        n4_ms=round(cam[0], 4), n4_launches=cam[1],
        aten_ms=round(aten[0], 4), aten_launches=aten[1],
        top=json.dumps([[round(ms, 3), n, k[:40]] for ms, n, k in p["rows"][:5]])
        .replace(" ", ""))
    return {k: v[0] for k, v in n1.items()}


CAMERA_HOST_US = 3000  # what the held stream allows the host for one call of the ATen stage


def camera_stage(dev, desc, say, reps: int) -> None:
    """The modular route's camera stage on the Cornell frame's 921,600 lanes,
    seed and work-id offset read from a device pair as a ``SampleBody``
    hands them over: the ATen ops of the route before N4, written out here
    op for op (the work key, the two jitter draws, ``generate_rays_u``, the
    fresh state's stack), counted (``chip_smoke.aten_ops``) and timed per
    call with an event pair while the stream is held (``cuda_ms_each``);
    then, on a tree that has it, N4 (``ops/camera.py:camera_state``) into a
    buffer, the same way, and whether it equals the ops bit for bit."""
    from raytracing_course_2024_tpu_torch.ops import camera as C
    from raytracing_course_2024_tpu_torch.ops.rng import (CTR_JITTER, offset_ids, uniform_ctr,
                                                          work_key)

    w, h = desc.settings.width, desc.settings.height
    n = w * h
    cam = C.camera_arrays(desc.settings.camera)
    cam_row = torch.from_numpy(C.pack_camera_row(cam)[0]).to(dev)
    wid = torch.arange(n, device=dev, dtype=torch.int32)
    px, py = (wid % w).float(), (wid // w).float()
    pair = torch.tensor([1, 3 * n], dtype=torch.int64, device=dev)

    def stage_ops():
        key = work_key(pair[0], offset_ids(wid, pair[1]))
        ro, rd = C.generate_rays_u(cam, px, py, w, h, uniform_ctr(key, CTR_JITTER),
                                   uniform_ctr(key, CTR_JITTER + 1))
        zero = ro.x * 0.0
        one = zero + 1.0
        return torch.stack([*ro, *rd, one, one, one, zero, zero, zero, one])

    ops = CS.aten_ops(stage_ops)
    stats: dict = {}
    ms = CS.cuda_ms_each(stage_ops, reps, stats, host_us=CAMERA_HOST_US)
    say(stage="camera-aten", lanes=n, aten_ops=sum(ops.values()), ms=round(ms, 4),
        min_ms=round(stats["min_ms"], 4), max_ms=round(stats["max_ms"], 4),
        gap_ms=round(stats["gap_ms"], 4),
        top=json.dumps(sorted(ops.items(), key=lambda kv: -kv[1])[:6]).replace(" ", ""))
    if not hasattr(C, "camera_state"):
        return
    out = torch.empty((13, n), dtype=torch.float32, device=dev)

    def n4():
        C.camera_state(pair[0], wid, pair[1], px, py, cam, cam_row, w, h, out=out)

    stats = {}
    ms = CS.cuda_ms_each(n4, reps, stats)
    n4()
    want = stage_ops()
    b = CS.camera_bytes(n)
    say(stage="camera-n4", lanes=n, ms=round(ms, 4), min_ms=round(stats["min_ms"], 4),
        max_ms=round(stats["max_ms"], 4), bound_ms=round(CS.bound(b, 0)[0], 5),
        bit_equal=CS.bit_equal(out, want))


# the hand-written kernels a lane frame may launch, by the name the profiler gives them
LANE_KERNELS = {"K6": "bvh_nearest_kernel", "N1a": "shade_kernel", "K3": "sampler_kernel",
                "N1b": "finish_kernel", "N2a": "refill", "N2b": "restart_kernel",
                "K1": "bounce_kernel", "K5": "persistent_kernel",
                "N5": "round_t",  # round_tail_kernel; round_test_kernel on older trees
                "if": "set_condition_kernel"}


def lane_frames(dev, bvh, cornell, frames: int, say) -> None:
    """The lane frames of ``chip_smoke.LOOP_FRAMES``, graphed: a warm-up
    frame (it captures), then per seed of ``frames``: the host ms of an
    unprofiled frame (ending in a device sync), the waits of a second one on
    the card (``chip_smoke.host_reads``: event syncs and host reads of CUDA
    tensors), and a third under torch.profiler (``chip_smoke.profiled_frame``):
    device ms, its wall and busy share, device launches, the card's idle
    time inside it (``chip_smoke.device_gaps``: its span, short and long
    gaps), and the idle share of the unprofiled frame, 1 - device ms / its
    host ms; rounds, path
    vertices, the image's digest (``image_sha``: equal on two trees when
    their frames of one seed are equal bit for bit), and the device ms and
    launches of each kernel of ``LANE_KERNELS`` (N2a of a tree with the
    two-launch refill: both launches together), and of the rows that name
    no hand-written kernel (``aten_ms``, ``aten_launches``: ATen ops,
    copies and fills); on the BVH frames, the ATen ops of one round beside
    its kernels (``tree_round_ops``)."""
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer

    descs = {"bvh": bvh, "cornell": cornell}
    for name, (scene, kw) in CS.LOOP_FRAMES.items():
        desc = descs[scene]
        r = Renderer(desc, device=dev, **kw)
        r.render_frame_device(seed=0)
        for seed in range(1, frames + 1):
            wall = CS.unprofiled_ms(r, [seed])[0]
            torch.cuda.synchronize()
            with CS.host_reads() as waits:
                r.render_frame_device(seed=seed)
            p = CS.profiled_frame(r, seed)
            kern = {}
            for tag, key in LANE_KERNELS.items():
                rows = [x for x in p["rows"] if key in x[2]]
                if rows:
                    kern[tag] = [round(sum(x[0] for x in rows), 4), sum(x[1] for x in rows)]
            aten = [x for x in p["rows"] if not any(k in x[2] for k in HAND_WRITTEN)]
            say(frame=name, seed=seed, wall_ms=round(wall, 3),
                device_ms=round(p["device_ms"], 3),
                idle_share=round(1.0 - p["device_ms"] / wall, 4), host_reads=waits[0],
                profiled_wall_ms=round(p["wall_ms"], 3),
                busy_share_profiled=round(p["busy_share"], 4),
                **{k: round(v, 4) for k, v in p["gaps"].items()},
                device_launches=p["launches"], rounds=r.rounds,
                path_vertices=int(p["path_vertices"]), image_sha=p["image_sha"],
                kernels=json.dumps(kern).replace(" ", ""),
                aten_ms=round(sum(x[0] for x in aten), 4),
                aten_launches=sum(x[1] for x in aten),
                top=json.dumps([[round(ms, 3), n, k[:40]] for ms, n, k in p["rows"][:5]])
                .replace(" ", ""))
        if name.startswith("bvh"):
            ops = tree_round_ops(Renderer(desc, device=dev, eager=True, **kw))
            say(frame=name, aten_ops_per_round=sum(ops.values()),
                top=json.dumps(sorted(ops.items(), key=lambda kv: -kv[1])[:6]).replace(" ", ""))
        del r
        torch.cuda.empty_cache()


def sweep_rounds(dev, bvh, cornell, counts: list, frames: int, say) -> None:
    """Each lane frame of ``chip_smoke.LOOP_FRAMES`` with the lane loops'
    rounds per replay (``integrator/wavefront.py:ROUNDS_PER_REPLAY``) set to
    each of ``counts`` in turns, forward then backward, on one graphed
    renderer (a count is a cache entry of its own, captured by its first
    frame): per count the median host ms of ``frames`` unprofiled frames
    per turn, and the waits on the card of one more frame
    (``chip_smoke.host_reads``)."""
    from raytracing_course_2024_tpu_torch.integrator import wavefront as W
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer

    default = W.ROUNDS_PER_REPLAY
    descs = {"bvh": bvh, "cornell": cornell}
    try:
        for name, (scene, kw) in CS.LOOP_FRAMES.items():
            r = Renderer(descs[scene], device=dev, **kw)
            times, reads = {c: [] for c in counts}, {}
            for c in list(counts) + list(reversed(counts)):
                W.ROUNDS_PER_REPLAY = c
                r.render_frame_device(seed=0)
                times[c] += CS.unprofiled_ms(r, range(1, frames + 1))
                torch.cuda.synchronize()
                with CS.host_reads() as waits:
                    r.render_frame_device(seed=1)
                reads[c] = waits[0]
            for c in counts:
                say(frame=name, rounds_per_replay=c,
                    wall_ms=round(statistics.median(times[c]), 3),
                    frames_ms=json.dumps([round(t, 3) for t in times[c]]).replace(" ", ""),
                    host_reads=reads[c], rounds=r.rounds)
            del r
            torch.cuda.empty_cache()
    finally:
        W.ROUNDS_PER_REPLAY = default


def tree_round_ops(r) -> dict:
    """``chip_smoke.round_ops`` of the tree timed; on a tree before the
    lane loops' control moved to the card (no ``wavefront_loop``), the
    ATen ops of its round bodies as it called them: the counter refill and
    the core with its live count, or the sticky round with its live test."""
    from raytracing_course_2024_tpu_torch.integrator import wavefront as W

    if hasattr(W, "wavefront_loop"):
        return CS.round_ops(r)
    s = r.settings
    n_pix, spp = s.width * s.height, s.samples
    lanes = min(r.batch_size, n_pix * spp)
    if r.engine == "wavefront":
        _, run_core, refill, run_refill = W.wavefront_bodies(
            r.cfg, r.scene, r.cam, s.width, s.height, n_pix, spp, lanes)
        refill.reset(1, 0, 0)

        def run():
            run_refill()
            run_core()
    else:
        run = W.StickyBody(r.cfg, r.scene, r.cam, s.width, s.height, n_pix, spp, lanes)
        run.reset(1, 0, 0)
    run()
    ops = CS.aten_ops(run)
    torch.cuda.synchronize()
    return ops


# variants of csrc/refill.cu: kernel -> [(name, [(lines of the tree, their
# replacement), ...]), ...]; count-launch-only, refill-launch-only,
# no-flush-stores, kmax-computed and no-acc fit the earlier two-launch N2a
# and one-lane N2b (where their time went, before the redesign), the others
# the one-launch N2a and the two-route N2b (their design items; N2b's
# "always-*" fix its route: whole sectors, or each lane writing only what
# changes)
WHOLE_RULE = "const bool whole = b > restart_whole_lanes();"
LANE_PARTS = {
    "refill": [
        ("count-launch-only", [("  refill_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(p);\n",
                                "")]),
        ("refill-launch-only", [("  refill_count_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(p);\n",
                                 "")]),
        ("no-flush-stores", [(
            "        if (w >= 0 && w < p.total) p.done[c * p.done_cols + w] = "
            "p.state[(9 + c) * b + i];\n", "")]),
        ("tile-1024", [("constexpr int kItems = 8; ", "constexpr int kItems = 4; ")]),
        ("tile-4096", [("constexpr int kItems = 8; ", "constexpr int kItems = 16; ")]),
        ("look-back-1-window", [("constexpr int kLook = 4; ", "constexpr int kLook = 1; ")]),
        ("no-flush-columns", [(
            "        if (wk >= 0 && wk < p.total) p.done[c * p.done_cols + wk] = rad[k][c];\n",
            "")]),
    ],
    "restart": [
        ("kmax-computed", [(
            "const bool take = dead && k < p.kmax[i];",
            "const bool take = dead && k < (i < p.f.n_pix ? (long long)((uint32_t)(p.f.n_pix"
            " - 1 - i) / (uint32_t)b + 1u) * p.f.samples : 0LL);")]),
        ("no-acc", [(
            "    for (int c = 0; c < 3; ++c) p.acc[c * p.acc_cols + slot] += "
            "p.state[(9 + c) * b + i];\n", "    (void)slot;\n")]),
        ("always-in-part", [(WHOLE_RULE, "const bool whole = false;")]),
        ("always-whole", [(WHOLE_RULE, "const bool whole = true;")]),
        ("in-part-1-lane-a-thread", [(WHOLE_RULE, "const bool whole = false;"), (
            "constexpr int kPartLanes = 2; ", "constexpr int kPartLanes = 1; ")]),
        ("whole-2-lanes-a-thread", [(WHOLE_RULE, "const bool whole = true;"), (
            "constexpr int kWholeLanes = 1; ", "constexpr int kWholeLanes = 2; ")]),
        ("in-part-rad-every-lane", [("const bool need = in && (kWhole || alive[r] < 0.5f);",
                                     "const bool need = in;")]),
        ("in-part-1-lane-rad-every-lane", [
            (WHOLE_RULE, "const bool whole = false;"),
            ("const bool need = in && (kWhole || alive[r] < 0.5f);", "const bool need = in;"),
            ("constexpr int kPartLanes = 2; ", "constexpr int kPartLanes = 1; ")]),
        ("no-acc-slot", [
            ("slot_v[r][c] = flush ? p.acc[c * p.acc_cols + slot[r]] : 0.0f;",
             "slot_v[r][c] = 0.0f * (float)flush;"),
            ("for (int c = 0; c < 3; ++c) p.acc[c * p.acc_cols + slot[r]] = slot_v[r][c] + "
             "rad[r][c];", "(void)slot[r];")]),
    ],
}


class _Swapped:
    """The kernel library with one launcher taken from a variant's library."""

    def __init__(self, base, so, name: str):
        self.base, self.name = base, name
        self.fn = getattr(so, name)
        self.fn.argtypes = getattr(base, name).argtypes
        self.fn.restype = getattr(base, name).restype

    def __getattr__(self, attr):
        return self.fn if attr == self.name else getattr(self.base, attr)


# the states the variants are timed on: the round-10 states of the BVH lane
# engines (1,048,576 lanes), and for N2b also its 262,144-lane state whose
# lanes own 4 pixels (the size of the Cornell sticky frame off the K5 route)
PART_STATES = {"refill": (CS.ROUND_TIMED,), "restart": (CS.ROUND_TIMED, "jmax")}


def lane_kernel_parts(dev, root: str, gpu: str, say, reps: int) -> None:
    """N2a and N2b as built and their ``LANE_PARTS`` variants, ms per launch
    in place (``chip_smoke.cuda_ms_in_place``, ``reps`` launches, the state
    put back outside the event pair, ``done`` not) on the states of
    ``PART_STATES`` (``chip_smoke.lane_snapshots``), the variants in turns:
    forward, backward, forward, backward; then each variant's median. Each
    variant is ``csrc/refill.cu`` of the tree under ``root`` with its lines
    replaced, compiled alone with the package's flags; its launcher stands
    in for the built one (N2a through ``ops/kernels.py:launch_refill`` with a
    scratch of one word per 256 lanes, enough for any tile size; N2b through
    ``ops/refill.py:restart``). Every variant's scratch starts at zero and
    stays its own."""
    from pathlib import Path

    from raytracing_course_2024_tpu_torch.ops import kernels
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer

    csrc = Path(root) / "raytracing_course_2024_tpu_torch" / "csrc"
    src = (csrc / "refill.cu").read_text()
    base = kernels.library()
    out_dir = kernels.BUILD_DIR / "lane_parts"
    out_dir.mkdir(parents=True, exist_ok=True)
    w, h, spp = CS.FRAME
    r = Renderer(CS.bvh_desc(w, h, spp), device=dev, eager=True)
    snaps = CS.lane_snapshots(r, CS.STICKY_JMAX_LANES)
    del r
    for kind, variants in LANE_PARTS.items():
        libs = {"as-built": base}
        for name, patches in variants:
            text = src
            if not all(text.count(old) == 1 for old, _ in patches):
                say(part=kind, variant=name, built="no: its lines are not in this tree")
                continue
            for old, new in patches:
                text = text.replace(old, new)
            cu, so = out_dir / f"{kind}-{name}.cu", out_dir / f"lib{kind}-{name}.so"
            cu.write_text(text)
            subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(csrc), "-shared",
                            "-o", str(so), str(cu)], check=True, capture_output=True)
            libs[name] = ctypes.CDLL(str(so))
        for tag in PART_STATES[kind]:
            part_times(kind, tag, snaps[kind][tag], libs, base, dev, gpu, say, reps)


def part_times(kind: str, tag: str, snap: tuple, libs: dict, base, dev, gpu: str, say,
               reps: int) -> None:
    """``lane_kernel_parts`` on one state: every library of ``libs`` in
    turns, then each one's median."""
    from raytracing_course_2024_tpu_torch.ops import kernels
    from raytracing_course_2024_tpu_torch.ops import refill as RF

    rnd, bufs, args = snap
    seed_off, bases, frame = args
    state = bufs[0]
    b = state.shape[1]
    total = frame.n_pix * frame.samples
    nbytes = (CS.refill_bytes(state, bufs[1], bufs[2], total) if kind == "refill"
              else CS.restart_bytes(state, bufs[1], bufs[2]))
    bound_ms = CS.bound(nbytes, 0.0)[0]
    scans = {n: torch.zeros((1 + -(-b // 256),), dtype=torch.int64, device=dev) for n in libs}
    order = (list(libs) + list(reversed(libs))) * 2
    times = {n: [] for n in libs}
    for turn, name in enumerate(order):
        work = [x.clone() for x in bufs]
        back = [(x, y) for i, (x, y) in enumerate(zip(work, bufs))
                if kind != "refill" or i != 3]

        def restore():
            for x, y in back:
                x.copy_(y)

        def launch():
            if kind == "refill":
                kernels.launch_refill(*work, seed_off, frame.cam_row, bases, frame.n_pix,
                                      frame.samples, frame.width, frame.height, scans[name])
            else:
                RF.restart(*work, *args)

        real = kernels.library
        kernels.library = (lambda: base) if name == "as-built" else (
            lambda so=libs[name]: _Swapped(base, so, f"rt_launch_{kind}"))
        try:
            if name == "refill-launch-only":  # its offsets: one whole launch first
                restore()
                kernels.library = lambda: base
                launch()
                kernels.library = lambda so=libs[name]: _Swapped(base, so, "rt_launch_refill")
            ms = CS.cuda_ms_in_place(launch, restore, reps)
        finally:
            kernels.library = real
        times[name].append(ms)
        say(part=kind, state=tag, variant=name, turn=turn, round=rnd, lanes=b,
            dead=round(float((state[12] < 0.5).float().mean()), 4), ms=round(ms, 4),
            bound_ms=round(bound_ms, 5), share=round(bound_ms / ms, 4), gpu=f'"{gpu}"')
    for name, ms in times.items():
        med = statistics.median(ms)
        say(part=kind, state=tag, variant=name, turns=len(ms), median_ms=round(med, 4),
            min_ms=round(min(ms), 4), max_ms=round(max(ms), 4),
            share=round(bound_ms / med, 4), gpu=f'"{gpu}"')


def loop_kernel(dev, desc, gpu: str, say, reps: int) -> None:
    """N5 of the tree per launch: the test alone on 1,048,576 and 262,144
    lanes in both modes (``chip_smoke.loop_times``, its bounds), then the end
    of the fused lane rounds on ``chip_smoke.TAIL_STATES`` (the Cornell
    counter wavefront's and 262,144-lane sticky frame's round-10 states,
    ``chip_smoke.tail_times``): the ATen steps and test the round ran
    before N5 took its tail over, and the fused tail where the tree has
    it."""
    t = CS.loop_times(dev, reps)
    for key, v in t.items():
        say(loop=key, value=json.dumps([round(x, 5) if isinstance(x, float) else x for x in v])
            if isinstance(v, tuple) else round(v, 5), gpu=f'"{gpu}"')
    for name, res in CS.tail_times(dev, desc, gpu, reps).items():
        say(loop_tail=name, **{k: (round(v, 5) if isinstance(v, float) else v)
                               for k, v in res.items() if k != "bound"},
            **({"bound_ms": round(res["bound"][0], 5)} if "bound" in res else {}),
            gpu=f'"{gpu}"')


# variants of csrc/loop.cu: (name, [(lines of the tree, their replacement), ...])
DEPTH_LOAD = ("      if (TAIL != kTailNone) load4<int, int4>(p.depth, i0 + 4 * g, b, p.vec, "
              "d + 4 * g);\n")
LOOP_PARTS = [
    # a lane parked on entry keeps its rows: origin x read with alive and
    # depth, and the six writes left out where it holds PARK_ORIGIN
    ("skip-parked-lanes", [
        ("    float a[kLanes];\n", "    float a[kLanes], ox[kLanes];\n"),
        (DEPTH_LOAD, DEPTH_LOAD + "      if (TAIL == kTailFused) load4<float, float4>(p.rows, "
         "i0 + 4 * g, b, p.vec, ox + 4 * g);\n"),
        ("TAIL == kTailFused && in && !cont);", "TAIL == kTailFused && in && !cont && "
         "ox[j] != kParkOrigin);")]),
    # the grid's count as the earlier N5 took it: one atomic a block into a
    # partial count, a fence and a ticket (loop.cuh:last_block_totals, K5's)
    ("two-atomics-and-a-fence", [(
        "  const unsigned long long mine = (1ull << kTicketShift) | (unsigned long long)count;\n"
        "  const unsigned long long before = atomicAdd(&p.out.scratch[kWord], mine);\n"
        "  if ((before >> kTicketShift) != gridDim.x - 1) return;\n"
        "  p.out.scratch[kWord] = 0;\n"
        "  finish<MODE>(p, (long long)((before + mine) & ((1ull << kTicketShift) - 1)), was);\n",
        "  long long total = count, none = 0;\n"
        "  if (!last_block_totals(p.out, total, none)) return;\n"
        "  finish<MODE>(p, total, was);\n")]),
    ("8-lanes-a-thread", [("constexpr int kGroups = 1; ", "constexpr int kGroups = 2; ")]),
    ("16-lanes-a-thread", [("constexpr int kGroups = 1; ", "constexpr int kGroups = 4; ")]),
    ("scalar-loads", [("  p.vec = aligned(alive) && (tail == 0 || aligned(depth));\n",
                       "  p.vec = false;\n")]),
    # where the fused tail's time goes: its ray-row stores left out (its
    # output is then wrong; a measurement only)
    ("no-ray-row-stores", [(
        "        for (int r = 0; r < 6; ++r) p.rows[r * b + i] = r < 3 ? kParkOrigin : kParkDir;\n",
        "        (void)i;\n")]),
]


def loop_kernel_parts(dev, root: str, desc, gpu: str, say, reps: int) -> None:
    """N5 as built and its ``LOOP_PARTS`` variants, in turns (forward,
    backward, forward, backward; then each one's median): the test alone
    per launch (``chip_smoke.cuda_ms_each``) on 1,048,576 lanes in counter
    mode and 262,144 in sticky mode, and the fused tail per launch in place
    on ``chip_smoke.TAIL_STATES``. Each variant is ``csrc/loop.cu`` of the
    tree under ``root`` with its lines replaced, compiled alone with the
    package's flags; its ``rt_launch_round_tail`` stands in for the built
    one; every launch is held against the plain version first."""
    from pathlib import Path

    from raytracing_course_2024_tpu_torch.ops import kernels
    from raytracing_course_2024_tpu_torch.ops import loop as LP

    csrc = Path(root) / "raytracing_course_2024_tpu_torch" / "csrc"
    src = (csrc / "loop.cu").read_text()
    base = kernels.library()
    out_dir = kernels.BUILD_DIR / "loop_parts"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {"as-built": base}
    for name, patches in LOOP_PARTS:
        text = src
        if not all(text.count(old) == 1 for old, _ in patches):
            say(part="loop", variant=name, built="no: its lines are not in this tree")
            continue
        for old, new in patches:
            text = text.replace(old, new)
        cu, so = out_dir / f"loop-{name}.cu", out_dir / f"libloop-{name}.so"
        cu.write_text(text)
        subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(csrc), "-shared",
                        "-o", str(so), str(cu)], check=True, capture_output=True)
        libs[name] = ctypes.CDLL(str(so))
    gen = torch.Generator().manual_seed(CS.SEED + 2)
    tests = {"test-counter-1048576": (LP.COUNTER, CS.loop_inputs(1_048_576, 0.5, gen, dev)),
             "test-sticky-262144": (LP.STICKY, CS.loop_inputs(262_144, 0.24, gen, dev))}
    states = {}
    for name, (kw, rnd) in CS.TAIL_STATES.items():
        t = CS.tail_state(desc, dev, kw, rnd)
        states[name] = (t, ({"k": t["k"], "n_pix": t["n_pix"], "samples": t["samples"]}
                            if t["sticky"] else
                            {key: t[key] for key in ("counter", "total", "thresh")}))
    cases = list(tests) + list(states)
    times = {(c, n): [] for c in cases for n in libs}
    order = (list(libs) + list(reversed(libs))) * 2
    real = kernels.library
    for turn, lib in enumerate(order):
        kernels.library = (lambda: base) if lib == "as-built" else (
            lambda so=libs[lib]: _Swapped(base, so, "rt_launch_round_tail"))
        try:
            for case in cases:
                ls, twin = LP.LoopState(dev), LP.LoopState(dev)
                if case in tests:
                    mode, ins = tests[case]
                    LP.round_test(ls, mode, **ins)
                    LP.round_test_plain(twin, mode, **ins)
                    torch.cuda.synchronize()
                    ok = CS.same_loop(ls, twin)
                    ms = CS.cuda_ms_each(lambda: LP.round_test(ls, mode, **ins), reps)
                else:
                    t, kw = states[case]
                    mode = LP.STICKY if t["sticky"] else LP.COUNTER
                    st, d = t["state"].clone(), t["depth"].clone()
                    pst, pd = t["state"].clone(), t["depth"].clone()
                    LP.round_tail(ls, mode, st, d, LP.TAIL_FUSED, t["last"], **kw)
                    LP.round_tail_plain(twin, mode, pst, pd, LP.TAIL_FUSED, t["last"], **kw)
                    torch.cuda.synchronize()
                    ok = (CS.bit_equal(st, pst) and torch.equal(d, pd)
                          and CS.same_loop(ls, twin))

                    def restore():
                        st.copy_(t["state"])
                        d.copy_(t["depth"])

                    ms = CS.cuda_ms_in_place(lambda: LP.round_tail(
                        ls, mode, st, d, LP.TAIL_FUSED, t["last"], **kw), restore, reps)
                times[(case, lib)].append(ms)
                say(part="loop", case=case, variant=lib, turn=turn, ms=round(ms, 5),
                    bit_equal=ok, gpu=f'"{gpu}"')
        finally:
            kernels.library = real
    for (case, lib), ms in times.items():
        say(part="loop", case=case, variant=lib, turns=len(ms),
            median_ms=round(statistics.median(ms), 5), min_ms=round(min(ms), 5),
            max_ms=round(max(ms), 5), gpu=f'"{gpu}"')


SECTOR_CU = r"""
#include <cuda_runtime.h>
// 13 rows of n floats; lane i writes where m[i] (whole = 0), or where any
// lane of its 8-lane group has m set, a zero if its own is not (whole = 1),
// or its own value read back first if its own is not (whole = 2)
__global__ void rows_kernel(float* out, const unsigned char* m, int n, int whole) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool mine = i < n && m[i];
  unsigned lanes = __ballot_sync(0xffffffffu, mine);
  bool write = whole ? (lanes & (0xffu << (threadIdx.x & 24u))) != 0u : mine;
  if (i >= n || !write) return;
  float old[13];
  for (int r = 0; r < 13; ++r) old[r] = whole == 2 && !mine ? out[(long long)r * n + i] : 0.0f;
  for (int r = 0; r < 13; ++r) out[(long long)r * n + i] = mine ? 1.0f + r : old[r];
}
extern "C" int rt_sector_rows(void* out, const void* m, int n, int whole, void* stream) {
  rows_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (float*)out, (const unsigned char*)m, n, whole);
  return (int)cudaGetLastError();
}
"""


def sector_writes(dev, say, reps: int) -> None:
    """13 rows of 921,600 floats written on a random share of the lanes:
    each writing lane alone, so that a 32-byte sector of a row is written in
    part, against every lane of an 8-lane group holding a writing lane
    (zeros from the others), so that it is written whole, and against the
    same with the others' own values read back first (what a lane must do
    whose value has to stay); ms per launch, an event pair per launch, the
    L2 cache flushed outside it."""
    from raytracing_course_2024_tpu_torch.ops import kernels

    out_dir = kernels.BUILD_DIR / "sector_writes"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "sector_writes.cu", out_dir / "libsector_writes.so"
    src.write_text(SECTOR_CU)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    so.rt_sector_rows.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p]
    n = 921_600
    out = torch.empty((13, n), device=dev)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    gen = torch.Generator(device=dev).manual_seed(7)
    for share in (1.0, 0.76, 0.67, 0.64, 0.38, 0.10, 0.03):
        mask = (torch.rand(n, generator=gen, device=dev) < share).to(torch.uint8)
        for whole in (0, 1, 2):
            def launch():
                rc = so.rt_sector_rows(out.data_ptr(), mask.data_ptr(), n, whole,
                                       torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"rt_sector_rows: CUDA error {rc}")

            ms = CS.cuda_ms_in_place(launch, flush.zero_, reps)
            say(sector_writes=("in-part", "whole", "whole-read-back")[whole], share=share,
                rows=13, lanes=n, ms=round(ms, 4))


if __name__ == "__main__":
    sys.exit(main())
