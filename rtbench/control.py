"""Readings that the limits of ``correct`` are set from, at a cell's own
size, in one process:

* ``program``: for each seed, the frames a run of that seed renders first
  (the cell's ``check.frames``), judged as a run judges them
  (``check.compare``);
* ``control``: the reference computed in bfloat16, the precision below the
  configuration's float32, put in the program's place: its radiance of the
  same pixels of the same frames, and its path-vertex count of them scaled
  to the frame, against the float32 reference.

    python3 -m rtbench.control --workload <cell> --seeds 1,2,... --control-seeds 7,8,9

Prints one JSON line per seed and kind (to ``--out`` too, when given).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import check, registry, scenes
from .reference import tracer
from .reference.rng import frame_seed32
from .run import frame_seed


def _ints(s: str) -> list:
    return [int(x) for x in s.split(",") if x]


def _reference(scene, cell, seed: int, i: int, pixels, lane: bool):
    tr, cfg = cell.traffic, cell.config
    return tracer.render_pixels(scene, frame_seed32(frame_seed(seed, i)), pixels, tr["spp"],
                                lane, cfg["max_tries"], tr["russian_roulette"])


def main(argv=None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description="readings of the program and of the control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = registry.Cell(args.workload)
    tr, cfg, st = cell.traffic, cell.config, cell.settings
    spec = scenes.build(cfg["scene"], cell.config_dir, tr["width"], tr["height"])
    n_pix, n_judged = spec.width * spec.height, st["check"]["pixels"]
    frames = st["check"]["frames"]
    home = torch.device("cuda", 0) if device == "cuda" else torch.device(device)
    out = open(args.out, "a") if args.out else None

    def emit(rec: dict) -> None:
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    ref32 = tracer.Scene(spec, home, tree=cfg["backend"] == "bvh")
    lane = None
    if args.seeds:
        from .program import System
        system = System(spec, tr["spp"], cell.chips, cfg["backend"], cfg["max_tries"],
                        tr["russian_roulette"], device=device)
        lane = system.engine != "batch"
        for k in range(st["warmup_frames"]):
            system.frame(frame_seed(0, -1 - k))
        for seed in args.seeds:
            pixels = torch.from_numpy(check.judged_pixels(seed, n_pix, n_judged)).to(home)
            prog, ref = [], []
            for i in range(frames):
                img, verts = system.frame(frame_seed(seed, i))
                prog.append((img[:, pixels].float().cpu(), verts))
            t0 = time.perf_counter()
            for i in range(frames):
                r, rv = _reference(ref32, cell, seed, i, pixels, lane)
                ref.append((r.cpu(), rv.sum().cpu()))
            emit(dict(cell=cell.name, kind="program", seed=seed, engine=system.engine,
                      reference_s=time.perf_counter() - t0,
                      **check.compare(prog, ref, n_pix, n_judged)))
        del system
    if args.control_seeds:
        if lane is None:
            lane = cfg["backend"] == "bvh"  # the program's default engine of the backend
        ref16 = tracer.Scene(spec, home, dtype=torch.bfloat16, tree=cfg["backend"] == "bvh")
        for seed in args.control_seeds:
            pixels = torch.from_numpy(check.judged_pixels(seed, n_pix, n_judged)).to(home)
            ctrl, ref = [], []
            for i in range(frames):
                r, rv = _reference(ref32, cell, seed, i, pixels, lane)
                c, cv = _reference(ref16, cell, seed, i, pixels, lane)
                ref.append((r.cpu(), rv.sum().cpu()))
                ctrl.append((c.cpu(), float(cv.sum()) * n_pix / n_judged))
            emit(dict(cell=cell.name, kind="control", seed=seed, precision="bfloat16",
                      **check.compare(ctrl, ref, n_pix, n_judged)))
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
