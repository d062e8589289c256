"""Positional CLI of the PyTorch/CUDA port, the same contract as the JAX
package's (and the reference binary's, src/main.rs:28-72):

    python -m raytracing_course_2024_tpu_torch SCENE WIDTH HEIGHT SAMPLES OUT.ppm [OUT_PNG]

* SCENE: .gltf or .txt (text scenes carry their own dimensions/spp; nonzero
  argv values override them).
* The optional 6th arg gets ".png" appended, like the reference.
* Renders on the CUDA device through the hand-written kernels; fails when
  no CUDA device is present.

Under a launcher (``python -m torch.distributed.run --nproc-per-node N -m
raytracing_course_2024_tpu_torch ...``) every process joins the group
(``parallel.init_distributed``: NCCL when each process has a card of its
own, else gloo) and renders its rows of the frame; process 0 alone writes
``out.log``, prints and writes the images. A single run is unchanged.
"""

from __future__ import annotations

import logging
import sys
import time

import torch.distributed as dist

from ..parallel.shard import init_distributed, process_count, process_index
from ..scene import load_scene
from .image_io import write_png, write_ppm
from .render import render_scene


def main(argv=None, *, device="cuda") -> int:
    """CLI entry; ``device`` is for in-process callers (the argv contract
    always renders on CUDA)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    # joins the launcher's group, unless the caller has joined one already
    owns_group = not dist.is_initialized() and init_distributed()
    lead = process_index() == 0
    # reference logs Debug to out.log (src/main.rs:29-34)
    log = logging.getLogger("rt_torch")
    log.setLevel(logging.DEBUG)
    handlers = [logging.FileHandler("out.log", mode="w"), logging.StreamHandler()] if lead else []
    for h in handlers:
        log.addHandler(h)
    say = print if lead else (lambda *a: None)
    try:
        if len(argv) < 5:
            say(__doc__)
            return 2
        scene_path = argv[0]
        width, height, samples = int(argv[1]), int(argv[2]), int(argv[3])
        out_ppm = argv[4]
        out_png = argv[5] if len(argv) > 5 else None

        desc = load_scene(scene_path, width, height, samples)
        if process_count() > 1:
            say(f"Processes: {process_count()}, backend: {dist.get_backend()}")
        say(
            f"Scene finite primitives: {len(desc.primitives)}, "
            f"light sources: {sum(p.is_emissive for p in desc.primitives)}, "
            f"planes: {len(desc.planes)}"
        )
        t0 = time.perf_counter()
        img = render_scene(desc, device=device)
        say(f"Rendering took {time.perf_counter() - t0:.2f}s")
        if not lead:
            return 0
        write_ppm(out_ppm, img)
        print(f"Dumping to {out_ppm}")
        if out_png:
            write_png(f"{out_png}.png", img)
            print(f"Image dumped to {out_png}.png")
        return 0
    finally:
        for h in handlers:
            log.removeHandler(h)
            h.close()
        if owns_group:
            dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
