"""GPU smoke test of the PyTorch/CUDA port (raytracing_course_2024_tpu_torch).

    python3 chip_smoke.py            # one CUDA card
    python3 chip_smoke.py --cards    # the multiproc phase over every card (2+)
    python3 chip_smoke.py --graphs   # the build and the graphs phase alone
    python3 chip_smoke.py --many     # the build and K3 above 32 lights alone
    python3 chip_smoke.py --many --parent TREE  # and against TREE's K3 (a checkout)

Every phase runs the Renderer as a user gets it: on the card the batch
engine's samples and the lane engines' rounds, the K5 loop's too, replay
captured CUDA graphs on both routes (``runtime/graphs.py``; a lane loop's
graph holds ``ROUNDS_PER_REPLAY`` rounds, each in an IF node on the device
round test N5, which also ends the round: the depth step, and after K1
the final-depth cap and park). A batch sample's replay adds the launches
recorded at capture; a lane loop adds its rounds' and refills' launches times the
rounds and refills its device counters report; so every launch count below
holds graphed. K1 and K2 read the seed and the work-id offset
from a device pair, as the graphed routes hand it to them, in every phase.

Phases (each prints lines tagged with its name; any failure raises and
exits non-zero):

1. device   -- a CUDA card is required; prints ``nvidia-smi`` name and
               power limit;
2. build    -- builds the kernels of csrc/ with nvcc (sm_90a, one process per
               source, all started together) and prints the build time and
               the ptxas register / spill lines;
3. kernels  -- every kernel against its plain PyTorch version on the card,
               same counter draws:
               fused path, 262,144 lanes, inline MIXED text scene and the
               in-repo Cornell glTF: K2, then 3 x K1, then K1 final_only,
               each fed the plain version's previous state, the kernels
               given the seed and a work-id offset past 2^32 as a device
               pair, the plain versions as ints;
               modular path: K4 on Cornell camera rays and bounce-1 rays at
               262,144 and 921,600 lanes, without a live mask and with the
               state's own (t and idx equal on every lane, masked lanes the
               miss); K3 on real ``surface_detail`` outputs at bounces 0
               and 1 of MIXED and LIGHTS (262,144 lanes) and of Cornell
               (262,144 and 921,600 lanes), ``ok`` equal on every lane and
               MIXED bit for bit; both at 921,600 lanes on a lane count that
               is no multiple of the tile (921,600 - 77), whole dead warps
               and tiles and every lane masked, K4 also with the rays and
               live masks of the modular frame's levels 1 to 5;
               lane engines: K1 in lane mode chained over 3 rounds from
               random per-lane depths and work ids (MIXED and Cornell at
               262,144 lanes; Cornell at the wavefront engine's 1,048,576
               lanes over the 1280x720 x 16 spp work ids); K5 chained over 10 rounds,
               each fed the plain version's previous state, on MIXED and
               Cornell at 262,144 lanes and Cornell at 921,600 (16 spp);
               K1, K1-final and K5 once more, in place, on Cornell states
               the tile walk has to get right: a lane count that is no
               multiple of the tile (921,600 - 77), whole dead warps and
               whole dead tiles, and every lane dead; lanes dead on entry
               must come out bit for bit as the plain version's, and the
               kernels' own live counts must be exact;
               N1a and N1b (the modular bounce's shade and finish) on the
               81,920-triangle BVH scene's and the Cornell scene's 921,600
               camera and bounce-1 lanes and MIXED's 262,144, a sparse
               state of each (at most 5 % live) and the BVH scene's
               bounce-3 state: N1a in the
               batch layout, in the lane layout (per-lane depths, the
               final-depth rule) and at the last level; N1b in the batch
               layout with roulette off and on, faithful acceptance off and
               on (the seed pair on the device, a work-id offset past 2^32)
               and in the lane layout; the share of lanes bit for bit equal
               beside the gate;
               K6 against the sweep on 65,536 lanes of the 81,920-triangle
               BVH scene (camera and bounce-1 rays with and without their
               live mask, a ragged lane count, dead warps and tiles, every
               lane masked, axis-parallel rays from origins on box planes),
               a 600-primitive soup of rotated boxes, ellipsoids and
               triangles, and the 5,120-triangle scene with every primitive
               twice (the lower row must win): t, hit flag and row equal on
               every lane, masked lanes (inf, 0); with K6's launch geometry
               (stack, shared and local bytes, resident blocks);
               the lane round on the BVH scene's 1,048,576 lanes
               (``phase_kernels_round``): N2a on the counter wavefront's
               refills at rounds >= 1, >= 10, its last and the work's tail,
               N2b on the sticky rounds >= 1, >= 10 and its last and on a
               262,144-lane state whose lanes own 4 pixels, every output
               equal to the plain version's bit for bit on every lane; K3 in
               lane mode on the same rounds' bounces at K3's gate, ``ok``
               exact;
               K3 above 32 lights (``phase_kernels_many``) on the course's
               practice6_1 scene (``rtbench/scenes/practice6_1.py``: 1,164
               triangle lights, the light pdf walked in the lights' own
               tree) at the counter wavefront's 1,048,576 lanes: its
               bounces at rounds >= 1, >= 10 and its last against the
               plain version, whose (B, L) sweep runs 32,768 lanes at a
               time, at K3's gate with ``ok`` exact (with ``--many
               --parent TREE`` also against TREE's K3, bit for bit: l, pdf
               and ok, and both timed); and one graphed frame of the
               scene, whose launches must match the wavefront's rounds
               (``sampler_many`` in place of ``sampler``); its timing row
               carries K3's launch geometry above 32 lights (stack, staged
               nodes, shared and local bytes, registers, resident blocks);
               N4 (the modular route's camera stage) on 997, 262,144,
               921,523 and 921,600 lanes, bit for bit on every lane and row,
               launched eagerly and replayed from a captured CUDA graph
               after the seed pair changed on the device;
               N5 (the lane round's tail and test) on 997, 262,144,
               921,523 and 1,048,576 lanes in the counter wavefront's and
               the sticky engine's modes, the test alone and each tail
               (none, the depth step, the fused core's cap, park and depth
               step) on states with parked rays and depths among their
               lanes, exactly equal to its plain version (counters,
               predicates, alive, depth and ray rows) eagerly and replayed
               from a graph with the launch in an IF node whose predicate
               goes true, false, true (K5 ends its own rounds with the
               test: its [kernels] lines hold that test too);
4. main     -- the port's CLI renders scenes/cornell_box.gltf at 1280x720,
               16 spp four times: by default (the fused path: K2, K1,
               K1-final), with RT_RR=1 (the modular path: N4 once per
               sample; K4, N1a, K3, N1b), with
               RT_ENGINE=sticky (K5 only, once per round) and with
               RT_ENGINE=wavefront (K1 in lane mode once per round, N2a once
               per refill); then the BVH scene on its default engine, which
               must be the counter wavefront, with RT_ENGINE=batch (N4; K6,
               N1a, K3, N1b) and with RT_ENGINE=wavefront and =sticky (K6,
               N1a, K3 in lane mode and N1b per round; N2a per refill, N2b
               per round and once for the final flush);
               the launch counters are set to 0 before each run, read after
               it, and must match that path exactly (the lane engines: the
               rounds they report, the refills the engine counts);
5. render   -- 320x180 x 16 spp frames: fused kernels against fused plain;
               modular kernels against modular plain (roulette on);
               modular against fused kernels (roulette off: the scene's
               ``ModularScene`` on the batch engine); the
               sticky engine's kernels against its plain versions (K5; with
               roulette, K4) and against the counter wavefront and the
               sticky engine on 16,384 lanes (K1 lane mode); MIXED through
               K5 against plain; a 1281-primitive mesh (K3 + the chunked
               sweep) at 4 spp against its plain version, with its peak
               memory (the render's own, over what the script already held);
               the 5,120-triangle BVH scene at 4 spp, K6 against the sweep,
               on the batch engine and the counter wavefront; a single
               ellipsoid and a lone emitter, kernels against plain, on the
               dense and the BVH backend;
6. timing   -- kernel against plain once more at the main path's shapes
               (921,600 lanes); medians of 3 frames (fused kernels,
               modular kernels with roulette, sticky and counter wavefront
               kernels; one fused plain frame); ms per launch of each kernel
               from CUDA events (K5 on the Cornell state after 10 rounds;
               K1, K1-final and K5 in place, as the engines launch them,
               and beside that into a separate buffer; K4 and K3 with an
               event pair per launch while a spin kernel holds the stream,
               so that the host's cost per call is not in the number, on
               the camera and on the bounce-1 state, K4 with and without
               the live mask, and level by level over one sample of the
               modular frame; N1a and N1b in place, an event pair per
               launch with the stream held, on the BVH frame's camera,
               bounce-1 and bounce-3 states; N4 into one buffer on the
               Cornell frame's 921,600 lanes),
               path vertices, Mrays/s, rounds, peak memory; K1 and K1-final
               on the bounce-1 state as it is, with its live lanes sorted to
               the front, with every lane alive, and with every lane alive
               and sorted by the sampler component of its first try; K5
               round by round over a whole sticky frame (ms and live share
               of each round); the BVH frame (81,920 smooth-shaded
               triangles, two rotated boxes, a rotated ellipsoid, a ground
               plane, a triangle light; 1280x720 x 16 spp, depth 4) on each
               engine, the counter wavefront's frame twice from one seed
               (equal bit for bit), K6 per launch on its 921,600 camera and
               bounce-1 rays, the walk model of K6's 4-wide tree equal to
               K6 on 4,096 of them, and K6's bound from the binary walk
               model's node and primitive counts over those rays (the
               yardstick of the binary walk), and the sweep once; N5
               alone on 1,048,576 and 262,144 lanes in both modes, and its
               fused tail on the Cornell counter wavefront's and 262,144-
               lane sticky frame's round-10 states beside the ATen steps it
               replaced (``[timing] kernel=loop-tail``);
7. runtime  -- checkpointed resume: the Cornell frame (fused batch path, 64
               spp; sticky, 32 spp; on a (2, 2) mesh of the card repeated,
               32 spp) and the BVH frame (its default engine, the counter
               wavefront, 32 spp) in 16-spp chunks, each
               chunk's launches exact, interrupted at half time and resumed
               in a fresh process (``chip_smoke.py --resume DIR``), equal
               bit for bit; the Cornell checkpoint refused by the BVH
               renderer; sharded frames (Cornell at 16 spp on (2,1), (1,2),
               (2,2) on the three engines, the BVH frame at 4 spp on (2,2)
               on its default engine)
               against the single-card frame, rtol 1e-4 / atol 1e-5, launches
               summed over the shards; ``device_trace`` around one Cornell
               frame naming 16 K2 and 80 K1;
8. multiproc -- rendering across processes on the one card: the Cornell
               frame (batch, 16 spp) in a group of one over NCCL; the
               Cornell frame on the three engines and the BVH frame (4 spp)
               in two processes over gloo (``init_distributed`` picks it: two
               processes, one card); each frame bit for bit the
               one-process frame of the same mesh, within rtol 1e-4 / atol
               1e-5 of the single-device frame, the processes' launches
               summed exactly; the CLI under ``python -m
               torch.distributed.run --standalone --nproc-per-node 2``
               writing one PPM, the one-process (2, 1) frame. Every process
               runs under a timeout. ``--cards`` runs this phase alone with
               one process per card over NCCL;
9. graphs   -- the BVH batch, Cornell modular (RT_RR=1), BVH wavefront and
               BVH sticky frames, and on the fused route the Cornell batch,
               counter wavefront, sticky (262,144 lanes: K1 in lane
               mode, not K5) and sticky K5 frames, at 1280x720 x 16 spp,
               graphed and with ``eager=True``: equal bit for bit (image,
               path vertices, rounds, launches) for two seeds and a second
               ``samp_base``, with one capture per cache entry (one per
               case: a lane loop's guarded rounds hold its refill or
               restart); capture ms, pool MB, launches
               per replay beside the eager frame's peak memory; eager and
               graphed frame ms in turns (median of 3 each); the busy share
               under torch.profiler, graphed and eager, of the BVH batch,
               Cornell fused batch and Cornell counter wavefront frames; no
               frame calls the plain modular stages or the plain camera
               stage, and one sample of each modular batch case dispatches
               at most SAMPLE_OPS_MAX ATen ops (the camera stage is in N4,
               the shade and finish work in N1a and N1b); no frame
               calls the plain sampler, refill or restart either, and one
               round of the BVH counter wavefront (refill, bounce, N5) and
               of the BVH sticky engine dispatches at most ROUND_OPS_MAX;
               one round of the Cornell counter wavefront and of the
               262,144-lane sticky frame (K1 in lane mode) none at all
               beside their kernels.
               It runs after the timing phase, before loop;
10. loop    -- the five lane frames (BVH counter wavefront and sticky;
               Cornell counter wavefront, sticky on 262,144 lanes and K5),
               1280x720 x 16 spp, graphed against ``eager=True``: equal
               ``image_sha``, path vertices, rounds, refills and launches;
               the graphed frame waits on the card at most
               ceil(rounds / ROUNDS_PER_REPLAY) + 2 times (a spy on every
               event sync and every host read of a CUDA tensor), each a read
               of the loop's pinned counters, and no wait that ATen makes on
               its own (sync debug mode); unprofiled wall ms, graphed and
               eager in turns; in a fresh process (``--traced``) a
               profiled frame's device ms (for the idle share) and each
               hand-written kernel's count in the traces of up to 3
               profiled frames, which must equal its launches counted (a
               guarded body's launches are counted from the device's
               counters). It runs before runtime.

The last lines are the card's name and power limit, the per-kernel JSON
record (K1-K6, N1a/N1b, N2a/N2b, N4 and N5: thirteen rows; K3's has its
lane mode beside it, N5's its sticky mode, 262,144 lanes and its fused
tail) and ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import logging
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

# kernels vs plain: per launch, on >= 99.9 % of lanes (far hits 1e5 units
# away and grazing accept or Fresnel decisions may differ on a few lanes)
ATOL = RTOL = 1e-4
LANE_FRAC = 0.999
# whole frames, kernels vs plain, linear radiance
PIX_ATOL = 1e-3
PIX_FRAC = 0.99
VERTS_RTOL = 0.01  # a frame's path vertices against its plain route's
# published peaks of one H100 SXM (fp32 outside the tensor cores; HBM3)
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

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

# every light shape, rotated and not: box, ellipsoid, triangle lights
LIGHTS_SCENE = """
DIMENSIONS 24 16
RAY_DEPTH 4
SAMPLES 4
BG_COLOR 0.05 0.05 0.1
CAMERA_POSITION 0 0 8
CAMERA_FORWARD 0 0 -1
CAMERA_FOV_X 1.1

NEW_PRIMITIVE
PLANE 0 1 0
POSITION 0 -2 0
COLOR 0.6 0.6 0.6

NEW_PRIMITIVE
BOX 0.6 0.2 0.4
POSITION -1.5 2 0
ROTATION 0.2 0.3 0.1 0.927
EMISSION 3 3 3

NEW_PRIMITIVE
BOX 0.3 0.3 0.3
POSITION 2 -1 -1
EMISSION 1 2 1

NEW_PRIMITIVE
ELLIPSOID 0.5 0.3 0.4
POSITION 1.5 1.5 0.5
ROTATION 0 0.3826834 0 0.9238795
EMISSION 2 1 1

NEW_PRIMITIVE
ELLIPSOID 0.3 0.3 0.3
POSITION -2 -1 1
EMISSION 1 1 2

NEW_PRIMITIVE
TRIANGLE -1 1 -2  1 1 -2  0 2.5 -2
EMISSION 2 2 2

NEW_PRIMITIVE
ELLIPSOID 0.8 0.8 0.8
POSITION 0 -1 0
COLOR 0.7 0.5 0.3
"""

# degenerate scenes (tests/test_edge_cases.py): one diffuse ellipsoid, and
# a lone emitter with nothing else to hit
EDGE_SCENES = {name: """
DIMENSIONS 16 12
RAY_DEPTH {depth}
SAMPLES 4
BG_COLOR 0.25 0.5 0.75
CAMERA_POSITION 0 0 5
CAMERA_FORWARD 0 0 -1
CAMERA_FOV_X 1.0
NEW_PRIMITIVE
ELLIPSOID {radius}
POSITION 0 0 0
{material}
""".format(**kw) for name, kw in (
    ("single-ellipsoid", dict(depth=2, radius="1 1 1", material="COLOR 0.9 0.1 0.1")),
    ("light-only", dict(depth=4, radius="0.5 0.5 0.5", material="EMISSION 7 7 7")))}

ROOT = os.path.dirname(os.path.abspath(__file__))
CORNELL = os.path.join(ROOT, "scenes", "cornell_box.gltf")
TPU_OPS = "raytracing_course_2024_tpu/ops"
CSRC = "raytracing_course_2024_tpu_torch/csrc"
KERNELS = {  # name -> (replaced TPU kernel body file:line, CUDA source)
    "primary": (f"{TPU_OPS}/pallas_bounce.py:515", f"{CSRC}/bounce.cu"),
    "bounce": (f"{TPU_OPS}/pallas_bounce.py:421", f"{CSRC}/bounce.cu"),
    "final": (f"{TPU_OPS}/pallas_bounce.py:421", f"{CSRC}/bounce.cu"),
    "nearest": (f"{TPU_OPS}/pallas_intersect.py:33", f"{CSRC}/dense_nearest.cu"),
    "sampler": (f"{TPU_OPS}/pallas_sampling.py:97", f"{CSRC}/sampler.cu"),
    # K3 above 32 lights has no Pallas source either: the JAX package sums the
    # light pdf over every light in one dense XLA sweep
    "sampler_many": (f"{TPU_OPS}/sampling.py:330", f"{CSRC}/sampler.cu"),
    "persistent": (f"{TPU_OPS}/pallas_bounce.py:651", f"{CSRC}/persistent.cu"),
    # K6 has no Pallas source: the JAX package walks its BVH in XLA
    "bvh": (f"{TPU_OPS}/treelet.py:175", f"{CSRC}/bvh_traverse.cu"),
    # N1a and N1b neither: XLA fuses the modular bounce's element-wise work
    # (_fold_in_planes + surface_detail + _collect_hit's accumulation; the
    # counter draws + _finish_bounce)
    "shade": (f"{TPU_OPS}/scene_intersect.py:249", f"{CSRC}/shade.cu"),
    "finish": ("raytracing_course_2024_tpu/integrator/path.py:140", f"{CSRC}/shade.cu"),
    # N2a and N2b neither: XLA fuses the lane engines' refill and restart
    # inside their lax.while_loop
    "refill": ("raytracing_course_2024_tpu/integrator/wavefront.py:236", f"{CSRC}/refill.cu"),
    "restart": ("raytracing_course_2024_tpu/integrator/wavefront.py:455", f"{CSRC}/refill.cu"),
    # N4 neither: XLA fuses the camera stage (generate_rays) into the JAX
    # package's jitted sample scan
    "camera": ("raytracing_course_2024_tpu/ops/camera.py:48", f"{CSRC}/camera.cu"),
    # N5 neither: XLA fuses the lane round's tail (the fused core's cap and
    # park, the depth step) and the loop's test (the while_loop's cond, the
    # path-vertex sum, the refill's lax.cond predicate) into the loop
    "loop": ("raytracing_course_2024_tpu/integrator/wavefront.py:300", f"{CSRC}/loop.cu"),
}
# launched on the modular main path only
MODULAR = ("nearest", "sampler", "shade", "finish", "camera")
# where each kernel launches inside a replayed CUDA graph (runtime/graphs.py)
GRAPHED = {
    "primary": "the batch engine's fused route",
    "bounce": "the batch engine's fused route; the lane engines' fused rounds (lane mode)",
    "final": "the batch engine's fused route",
    "persistent": "the sticky engine's K5 loop, in guarded rounds (IF nodes), each ending "
                  "with the round test",
    "nearest": "the batch engine's modular route; the lane engines' rounds on a dense "
               "ModularScene",
    "sampler": "the batch engine's modular route; the lane engines' rounds on a "
               "ModularScene (lane mode)",
    "sampler_many": "as K3's, on a ModularScene of more than 32 lights",
    "bvh": "the batch engine's modular route; the lane engines' rounds",
    "shade": "the batch engine's modular route; the lane engines' rounds on a ModularScene",
    "finish": "the batch engine's modular route; the lane engines' rounds on a ModularScene",
    "refill": "the counter wavefront's refill, both routes, an IF node in its round",
    "restart": "the sticky engine's round off the K5 route, both routes",
    "camera": "the batch engine's modular route",
    "loop": "the guarded rounds of the counter wavefront and of the sticky engine off the "
            "K5 route: the round's tail and the test that the next round's IF nodes read",
}
SEED = 20240917
K = 4  # max_tries
FRAME = (1280, 720, 16)  # the main path: width, height, spp (one 921,600-lane batch)
RENDER = (320, 180, 16)  # the frame-against-frame phase
PLAIN_BVH = (96, 54, 4)  # the 81,920-triangle frames against the plain route's sweep
MESH_SPP = 4
LANES = ((512, 512), (1280, 720))  # kernel-against-plain sizes: 262,144 and 921,600
K5_CHAIN = 10  # K5 rounds held against the plain version; the timed state is the last
LANE_ROUNDS = 3  # K1 lane-mode rounds held against the plain version
# the work-id offset of [kernels]' fused cases: past 2^32, so that K1 and K2
# (the device pair) and their plain versions (ints) agree on its low 32 bits
KERNEL_WID_OFF = 2**32 + 3 * LANES[0][0] * LANES[0][1]

# fp32 operations (add, sub, mul, div, min, max, abs, compare, sqrt, rsqrt,
# sin, cos: one each; selects and integer hashing not counted) of the
# device functions, counted from csrc/dense_nearest.cu and csrc/common.cuh
OPS_TRI_K4 = 53  # one Moller-Trumbore test + running min in dense_nearest_kernel, per live lane
# the fused loop (csrc/bounce_body.cuh) does the same test per entry, and the
# facing normal (cross, dot, compare, scale: 18) once per live lane, for the
# winner. Until the normal left the loop it was counted per entry (71).
OPS_TRI_FUSED = 53
OPS_WINNER_NORMAL = 18
OPS_TRI_FUSED_OLD = 71
OPS_CAND = {"which": 1, "accept": 12, "cosine": 24, "vndf": 159,
            "light": {0: 70, 1: 67, 2: 62}}  # sample_light_dir by light type
OPS_PDF = 7 + 127 + 5  # pdf_cosine + pdf_vndf + sums, divide, clamp
OPS_LIGHT_PDF = {0: 89, 1: 87, 2: 141}  # pdf_lights per light, unrotated
OPS_LIGHT_ROT = {1: 180, 2: 120}  # extra of a rotated box / ellipsoid
# N1a (csrc/shade.cu shade_kernel) per live lane: the fold of one plane (two
# quaternion rotations, the plane test: 86), the surface of the winner (a
# triangle's test, both normals, the facing flips: 110; a box's or an
# ellipsoid's is about as long), the radiance, the point and v (20); N1b
# (finish_kernel) per live lane: the BRDF (130), cos / pdf and the weight
# (15), the throughput and roulette (15). Selects and the hash not counted.
OPS_SHADE_PLANE = 86
OPS_SHADE = 130
OPS_FINISH = 160
# bytes: counted lane by lane from what N1a's and N1b's outputs depend on
# (``n1_bytes``). Of the scene's tables N1a needs the plane table and the 28
# floats (vertices, shading normals, material) of each triangle row that
# some lane hit, each read once.
SHADE_BYTES_ROW = 28 * 4
SURF_BYTES = 21 * 4  # the surface of a hit lane: K3's 13 rows and the 8 fields only N1b reads


def say(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def gpu_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def clocks_line() -> str:
    """The card's SM and memory clocks as ``nvidia-smi`` reads them now."""
    return gpu_line("clocks.sm,clocks.mem")


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


def hold_stream(ms: float) -> None:
    """Keeps the card busy for about ``ms`` with a spin kernel, so that what
    the host enqueues meanwhile waits on the stream and then runs back to
    back: an event pair around a launch made while the stream is held spans
    the kernel alone, not the host's way to the launch."""
    khz = getattr(torch.cuda.get_device_properties(0), "clock_rate", 1_755_000)
    torch.cuda._sleep(int(ms * khz))


HOST_US_PER_LAUNCH = 400  # what ``hold_stream`` allows the host for one timed launch


def cuda_ms_each(fn, reps: int, stats: dict | None = None,
                 host_us: float = HOST_US_PER_LAUNCH) -> float:
    """Device ms per call of ``fn`` (same inputs, fresh outputs each call)
    from one pair of CUDA events per launch, recorded while the stream is
    held (``hold_stream``), so the host's cost per call (argument checks,
    allocations, the ctypes call) is not in the number, however slow the host
    is. Returns the median launch: where the host did fall behind the card (a
    launch made on an idle stream starts late, inside its event pair), those
    launches do not move it. ``stats`` receives the mean, the least and the
    largest launch, and ``gap_ms``: the median idle time between one launch's
    end event and the next one's start event, a few microseconds while the
    host stayed ahead of the card. ``host_us`` is what the hold allows the
    host for one call (a chain of ATen ops needs more than one launch)."""
    fn()  # warm-up
    marks = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    torch.cuda.synchronize()
    hold_stream(reps * host_us / 1e3)
    for start, end in marks:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = [start.elapsed_time(end) for start, end in marks]
    if stats is not None:
        gaps = [a[1].elapsed_time(b[0]) for a, b in zip(marks, marks[1:])]
        stats.update(mean_ms=sum(times) / reps, min_ms=min(times), max_ms=max(times),
                     gap_ms=statistics.median(gaps) if gaps else 0.0)
    return statistics.median(times)


def cuda_ms_in_place(fn, restore, reps: int) -> float:
    """Device ms per call of ``fn`` where ``fn`` overwrites its input, as the
    engines call K1 and K5: ``restore`` puts the input back before every
    call, outside the pair of CUDA events that times the call. The stream is
    held while the host enqueues, as in ``cuda_ms_each``."""
    marks = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps + 1)]
    torch.cuda.synchronize()
    hold_stream(reps * HOST_US_PER_LAUNCH / 1e3)
    for start, end in marks:  # the first pair is the warm-up
        restore()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in marks[1:]) / reps


def bound(nbytes: float, ops: float) -> tuple:
    """(least ms the card could take, the side that sets it)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(res: dict, what: str, ok: bool) -> dict:
    say("kernels", case=what, **res)
    if not ok:
        raise SystemExit(f"kernel/plain mismatch in {what}: {res}")
    return res


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
    return check(res, what, alive_agree >= LANE_FRAC and worst_frac >= LANE_FRAC and finite)


def compare_rows(kern, plain, mask_k, mask_p, what: str) -> dict:
    """Kernel vs plain outputs of K3/K4: the masks (hit / accepted) agree on
    >= 99.9 % of lanes, and each value row within atol = rtol = 1e-4 on
    >= 99.9 % of the lanes where both masks hold."""
    mask_agree = (mask_k == mask_p).float().mean().item()
    both = mask_k & mask_p
    worst_frac, max_err = 1.0, 0.0
    for a, b in zip(kern, plain):
        a, b = a[both].float(), b[both].float()
        if a.numel() == 0:
            continue
        err = (a - b).abs()
        worst_frac = min(worst_frac, (err <= ATOL + RTOL * b.abs()).float().mean().item())
        max_err = max(max_err, err.max().item())
    res = dict(mask_agree=round(mask_agree, 6), row_agree_min=round(worst_frac, 6),
               max_abs_err=max_err, mask_frac=round(mask_p.float().mean().item(), 4))
    return check(res, what, mask_agree >= LANE_FRAC and worst_frac >= LANE_FRAC)


def phase_kernels(dev) -> None:
    from raytracing_course_2024_tpu_torch.ops import bounce as B
    from raytracing_course_2024_tpu_torch.ops.camera import camera_arrays, pack_camera_row
    from raytracing_course_2024_tpu_torch.scene import (
        build_scene_arrays, load_scene, parse_text_scene)

    w, h = LANES[0]
    for name in ("mixed", "cornell"):
        desc = (parse_text_scene(MIXED_SCENE) if name == "mixed"
                else load_scene(CORNELL, w, h, 1))
        arrays, statics = build_scene_arrays(desc)
        scene = B.bounce_scene(arrays, statics, dev)
        cam = torch.from_numpy(pack_camera_row(camera_arrays(desc.settings.camera))[0]).to(dev)
        bg = tuple(desc.settings.bg_color)
        idx = torch.arange(w * h, device=dev, dtype=torch.int32)
        px, py = (idx % w).float(), (idx // w).float()
        # the kernels read the pair on the device, the plain versions get ints
        seed_t, off_t = route_pair(SEED, KERNEL_WID_OFF, dev)
        st_k = B.primary_bounce(scene, cam, px, py, idx, off_t, seed_t, bg, K, w, h)
        st_p = B.primary_plain(scene, cam, px, py, idx, KERNEL_WID_OFF, SEED, bg, K, w, h)
        torch.cuda.synchronize()
        compare_states(st_k, st_p, f"{name}:primary")
        for i in range(1, 4):
            k = B.bounce(scene, st_p.clone(), idx, off_t, seed_t, i, bg, K)
            nxt = B.bounce_plain(scene, st_p, idx, KERNEL_WID_OFF, SEED, i, bg, K)
            torch.cuda.synchronize()
            compare_states(k, nxt, f"{name}:bounce{i}")
            st_p = nxt
        k = B.bounce(scene, st_p.clone(), idx, off_t, seed_t, 4, bg, K, final_only=True)
        p = B.bounce_plain(scene, st_p, idx, KERNEL_WID_OFF, SEED, 4, bg, K, final_only=True)
        torch.cuda.synchronize()
        compare_states(k, p, f"{name}:final")


def compare_persistent(kern, plain, ls, live, more, what: str) -> dict:
    """K5 against its plain version: rows 0-12 as ``compare_states`` holds
    K1's, the counters k and depth equal, the accumulators within atol =
    rtol = 1e-4 on >= 99.9 % of lanes; and the round test its last block
    wrote into ``ls`` (a fresh ``LoopState``): the live count (the path
    vertices) equal, the work-left count (``n``) within 0.1 % of the lanes,
    another round and its IF predicate where that count is > 0, no refill,
    the scratch back at 0."""
    from raytracing_course_2024_tpu_torch.ops import loop as LP

    res = compare_states(kern[:13], plain[:13], f"{what}:rows0-12")
    kd_equal = bool(torch.equal(kern[13:15], plain[13:15]))
    err = (kern[15:18] - plain[15:18]).abs()
    acc_frac = (err <= ATOL + RTOL * plain[15:18].abs()).all(dim=0).float().mean().item()
    n = kern.shape[1]
    loop = ls.loop.tolist()
    live_k, more_k = loop[LP.NVERTS], loop[LP.N_ALIVE]
    go = more_k > 0
    test_ok = (loop[LP.MORE] == go and loop[LP.ROUNDS] == go and loop[LP.REFILL] == 0
               and loop[LP.REFILLS] == 0 and ls.preds.tolist() == [go, False]
               and not ls.scratch.any().item())
    out = dict(k_depth_equal=kd_equal, acc_agree=round(acc_frac, 6),
               acc_max_abs_err=err.max().item(), live=[live_k, int(live)],
               more=[more_k, int(more)], round_test_ok=test_ok)
    check(out, what, kd_equal and acc_frac >= LANE_FRAC and live_k == int(live)
          and abs(more_k - int(more)) <= (1.0 - LANE_FRAC) * n and test_ok)
    return dict(res, max_abs_err=max(res["max_abs_err"], out["acc_max_abs_err"]))


def k5_args(args, dev) -> tuple:
    """K5's launch arguments after its ``LoopState`` from ``args``, the
    plain version's (seed, frame_pix, pix_base, samp_base, bg, ...): the
    device triple (seed, pix_base, samp_base) and the rest."""
    from raytracing_course_2024_tpu_torch.ops.persistent import ids

    return (ids(args[0], args[2], args[3], dev), args[1], *args[4:])


def sticky_inputs(dev, desc, w: int, h: int, spp: int):
    """What ``_sticky_fused`` hands K5 for a w x h frame at ``spp`` (the
    engine's own ``_sticky_inputs``): (scene, camera row, px, py, kmax), the
    initial (18, B) state and the launch arguments after the state."""
    from raytracing_course_2024_tpu_torch.integrator import wavefront as W
    from raytracing_course_2024_tpu_torch.integrator.path import TraceConfig
    from raytracing_course_2024_tpu_torch.ops import bounce as B
    from raytracing_course_2024_tpu_torch.ops.camera import camera_arrays
    from raytracing_course_2024_tpu_torch.scene import build_scene_arrays

    arrays, statics = build_scene_arrays(desc)
    scene = B.bounce_scene(arrays, statics, dev)
    cfg = TraceConfig(ray_depth=desc.settings.ray_depth,
                      bg_color=tuple(desc.settings.bg_color), max_tries=K)
    return W._sticky_inputs(SEED, 0, 0, camera_arrays(desc.settings.camera), scene, cfg,
                            w, h, w * h, spp)


def lane_mode_chain(dev, gen, name: str, desc, w: int, h: int, spp: int, lanes: int) -> float:
    """K1 in lane mode against its plain version over ``LANE_ROUNDS``
    rounds, as the wavefront engine runs it: ``lanes`` lanes on random work
    ids of the w x h x spp frame, each starting a camera ray at a random
    depth in [0, ray_depth); each round is fed the plain version's previous
    state after the engine's depth cap and park, and every lane's depth
    then grows by one. Returns the largest absolute error."""
    from raytracing_course_2024_tpu_torch.integrator import wavefront as W
    from raytracing_course_2024_tpu_torch.ops import bounce as B
    from raytracing_course_2024_tpu_torch.ops import refill as RF
    from raytracing_course_2024_tpu_torch.ops.camera import camera_arrays
    from raytracing_course_2024_tpu_torch.ops.rng import work_key
    from raytracing_course_2024_tpu_torch.ops.shade import park
    from raytracing_course_2024_tpu_torch.scene import build_scene_arrays

    arrays, statics = build_scene_arrays(desc)
    scene = B.bounce_scene(arrays, statics, dev)
    bg, depth_n = tuple(desc.settings.bg_color), desc.settings.ray_depth
    wid = torch.randint(0, w * h * spp, (lanes,), generator=gen, device=dev, dtype=torch.int32)
    pix = wid.long() % (w * h)
    st = W._initial_state(B.N_STATE, lanes, dev)
    RF.restart_rows(st, torch.ones_like(pix, dtype=torch.bool), RF.camera_rows(
        camera_arrays(desc.settings.camera), pix % w, pix // w, w, h, work_key(SEED, wid)))
    depth = torch.randint(0, depth_n, (lanes,), generator=gen, device=dev, dtype=torch.int32)
    err = 0.0
    seed_t, off_t = route_pair(SEED, 0, dev)
    for r in range(LANE_ROUNDS):
        k = B.bounce(scene, st.clone(), wid, off_t, seed_t, 0, bg, K, depth=depth)
        p = B.bounce_plain(scene, st, wid, 0, SEED, 0, bg, K, depth=depth)
        torch.cuda.synchronize()
        res = compare_states(k, p, f"{name}-{lanes}-lanes:bounce-lane-mode-round{r}")
        err = max(err, res["max_abs_err"])
        st = park(p, (p[12] > 0.5) & (depth < depth_n - 1))
        depth = depth + 1
    return err


def phase_kernels_lanes(dev) -> tuple:
    """K1 in lane mode on MIXED and Cornell at 262,144 lanes and on the
    main path's Cornell shape (the wavefront engine's 1,048,576 lanes over
    the 1280x720 x 16 spp work ids), and K5 chained round by round (each
    round fed the plain version's previous state) on MIXED and Cornell at
    262,144 lanes and on Cornell at 921,600. Returns the largest absolute
    errors of K1 in lane mode and of K5 at the main path's shapes, and the
    Cornell inputs and state at 921,600 lanes after ``K5_CHAIN`` rounds at
    the main path's spp, for the timing phase."""
    from raytracing_course_2024_tpu_torch.ops.loop import LoopState
    from raytracing_course_2024_tpu_torch.ops.persistent import persistent_plain, persistent_round
    from raytracing_course_2024_tpu_torch.runtime.render import DEFAULT_BATCH
    from raytracing_course_2024_tpu_torch.scene import load_scene, parse_text_scene

    gen = torch.Generator(device=dev).manual_seed(SEED)
    w, h = LANES[0]
    for name in ("mixed", "cornell"):
        desc = parse_text_scene(MIXED_SCENE) if name == "mixed" else load_scene(CORNELL, w, h, 1)
        lane_mode_chain(dev, gen, name, desc, w, h, 1, w * h)
    fw, fh, fspp = FRAME
    lanes = min(DEFAULT_BATCH, fw * fh * fspp)  # the wavefront engine's lanes
    bounce_err = lane_mode_chain(dev, gen, "cornell-1280x720x16", load_scene(
        CORNELL, fw, fh, fspp), fw, fh, fspp, lanes)

    err, main = 0.0, None
    for name, (w, h), spp in (("mixed", LANES[0], 4), ("cornell", LANES[0], 4),
                              ("cornell", LANES[1], FRAME[2])):
        desc = parse_text_scene(MIXED_SCENE) if name == "mixed" else load_scene(CORNELL, w, h, 1)
        ins, st_p, args = sticky_inputs(dev, desc, w, h, spp)
        for r in range(K5_CHAIN):
            ls = LoopState(dev)
            kern = persistent_round(*ins, st_p, ls, *k5_args(args, dev))
            nxt, live, more = persistent_plain(*ins, st_p, *args)
            torch.cuda.synchronize()
            res = compare_persistent(kern, nxt, ls, live, more,
                                     f"{name}-{w}x{h}:persistent-round{r}")
            if (w, h) == LANES[1]:
                err = max(err, res["max_abs_err"])
            st_p = nxt
        if (w, h) == LANES[1]:
            main = (ins, st_p, args)
    return {"bounce": bounce_err, "persistent": err}, main


def tile_patterns(n: int, dev) -> dict:
    """Lane masks the tile walk has to get right, as ``keep`` flags over
    ``n`` lanes: whole warps dead (every third group of 32 lanes) and whole
    tiles dead (every second group of 4,096 lanes, a multiple of any tile up
    to 1,024 lanes); no lane kept at all."""
    i = torch.arange(n, device=dev)
    return {"dead-warps-and-tiles": ((i // 32) % 3 != 0) & ((i // 4096) % 2 == 0),
            "all-dead": torch.zeros(n, dtype=torch.bool, device=dev)}


def phase_kernels_tiles(dev, k5) -> None:
    """K1, K1-final and K5 against their plain versions, run in place as the
    engines run them, on Cornell states at the main path's 921,600 lanes cut
    or masked so that the tile walk meets a ragged last tile, whole dead
    warps and tiles, and no live lane at all. Beyond the usual gates: of a
    lane dead on entry (K5: finished) every row but its parked ray (the
    plain versions move it, nothing reads it) comes out bit for bit as the
    plain version's, and K1's own count equals the lanes alive on entry."""
    from raytracing_course_2024_tpu_torch.ops import bounce as B
    from raytracing_course_2024_tpu_torch.ops.loop import LoopState
    from raytracing_course_2024_tpu_torch.ops.persistent import persistent_plain, persistent_round
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer
    from raytracing_course_2024_tpu_torch.scene import load_scene

    w, h, spp = FRAME
    r = Renderer(load_scene(CORNELL, w, h, spp), device=dev)
    scene, cam, bg = r.scene, r.cam_row, r.bg
    n = w * h
    idx = torch.arange(n, device=dev, dtype=torch.int32)
    p0 = B.primary_plain(scene, cam, (idx % w).float(), (idx // w).float(), idx, 0, 1, bg, K,
                         w, h)
    ragged = n - 77
    cases = {"ragged": (p0[:, :ragged].contiguous(), idx[:ragged].contiguous())}
    for name, keep in tile_patterns(n, dev).items():
        st = p0.clone()
        st[12] *= keep
        cases[name] = (st, idx)
    seed_t, off_t = route_pair(1, 0, dev)
    for name, (st, wid) in cases.items():
        dead = st[12] < 0.5
        for final, level in ((False, 1), (True, 5)):
            count = torch.zeros((), dtype=torch.int64, device=dev)
            k = st.clone()
            B.bounce(scene, k, wid, off_t, seed_t, level, bg, K, final_only=final, out=k,
                     count=count)
            p = B.bounce_plain(scene, st, wid, 0, 1, level, bg, K, final_only=final)
            torch.cuda.synchronize()
            what = f"cornell-{st.shape[1]}-lanes-{name}:{'final' if final else 'bounce'}"
            compare_states(k, p, what)
            exact = dict(dead_lanes_equal=bool(torch.equal(k[6:, dead], p[6:, dead])),
                         count=[int(count), int((~dead).sum())])
            check(exact, what + "-exact",
                  exact["dead_lanes_equal"] and exact["count"][0] == exact["count"][1])

    ins, st5, args5 = k5  # the Cornell frame's state after K5_CHAIN rounds
    scene5, cam5, px5, py5, kmax5 = ins
    cases5 = {"ragged": ((scene5, cam5, px5[:ragged].contiguous(), py5[:ragged].contiguous(),
                          kmax5[:ragged].contiguous()), st5[:, :ragged].contiguous())}
    for name, keep in tile_patterns(n, dev).items():
        st = st5.clone()  # the other lanes have finished: dead, no path left
        st[12] *= keep
        st[13] = torch.where(keep, st[13], kmax5)
        cases5[name] = (ins, st)
    for name, (ins_c, st) in cases5.items():
        finished = (st[12] < 0.5) & (st[13] >= ins_c[4])
        ls = LoopState(dev)
        k = st.clone()
        persistent_round(*ins_c, k, ls, *k5_args(args5, dev), out=k)
        p, live, more = persistent_plain(*ins_c, st, *args5)
        torch.cuda.synchronize()
        what = f"cornell-{st.shape[1]}-lanes-{name}:persistent"
        compare_persistent(k, p, ls, live, more, what)
        same = bool(torch.equal(k[6:, finished], p[6:, finished]))
        check(dict(finished_lanes_equal=same, finished=int(finished.sum())), what + "-exact", same)


class Modular:
    """One scene on the modular path at w x h lanes: camera rays from the
    counter draws of sample 0, the plain bounce-0 hit and surface, the
    inputs K3 reads there, bounce 1's rays and live mask, and the inputs K3
    reads at bounce 1 (counter base ``draws_per_bounce``), as the main path
    feeds them. ``levels`` also walks the plain modular path with roulette,
    as the main run does, down to the last depth level: ``self.levels[i]`` is
    (ro, rd, alive, K3's arguments or None at the last level) on entry to
    level i."""

    def __init__(self, dev, desc, w: int, h: int, levels: bool = False):
        from raytracing_course_2024_tpu_torch.integrator import path as P
        from raytracing_course_2024_tpu_torch.ops import rng
        from raytracing_course_2024_tpu_torch.ops.camera import camera_arrays, camera_state_plain
        from raytracing_course_2024_tpu_torch.ops.scene_intersect import (
            modular_scene, surface_detail)
        from raytracing_course_2024_tpu_torch.ops.traverse import nearest_hit
        from raytracing_course_2024_tpu_torch.ops.vec import Vec3
        from raytracing_course_2024_tpu_torch.scene import build_scene_arrays
        from raytracing_course_2024_tpu_torch.scene.types import DIELECTRIC, MIRROR

        arrays, statics = build_scene_arrays(desc)
        self.scene = modular_scene(arrays, statics, dev)
        self.cfg = P.TraceConfig(ray_depth=desc.settings.ray_depth,
                                 bg_color=tuple(desc.settings.bg_color), max_tries=K)
        self.wid = torch.arange(w * h, device=dev, dtype=torch.int32)
        self.key = rng.work_key(SEED, self.wid)
        px, py = (self.wid % w).float(), (self.wid // w).float()
        st = camera_state_plain(SEED, self.wid, 0, px, py, camera_arrays(desc.settings.camera),
                                w, h)
        self.ro, self.rd = Vec3(st[0], st[1], st[2]), Vec3(st[3], st[4], st[5])

        def sampler_inputs(ro, rd, alive, bounce_i):
            hit = nearest_hit(ro, rd, self.scene, plain=True)
            surf = surface_detail(ro, rd, hit, self.scene)
            is_delta = (surf.mkind == MIRROR) | (surf.mkind == DIELECTRIC)
            need = alive & hit.valid & ~is_delta
            args = (self.scene, SEED, self.wid, 0,
                    rng.batch_ctr(bounce_i * rng.draws_per_bounce(K), K), surf.point,
                    surf.n_geom, surf.n_shade, rd * -1.0, surf.roughness, need, K)
            return surf, need, args

        self.alive = self.ro.x < math.inf
        self.surf, self.need, self.sampler_args = sampler_inputs(
            self.ro, self.rd, self.alive, 0)
        # bounce 1's rays: the plain modular bounce 0 of the camera rays
        step = modular_steps(P, st.clone(), self.scene, SEED, self.wid, plain=True)
        ro1, rd1, alive1 = step(self.cfg, 0)
        self.bounce1 = (ro1, rd1)
        self.alive1 = alive1
        self.surf1, self.need1, self.sampler_args1 = sampler_inputs(ro1, rd1, alive1, 1)
        self.levels = [(self.ro, self.rd, self.alive, self.sampler_args),
                       (ro1, rd1, alive1, self.sampler_args1)]
        if levels:
            cfg = self.cfg._replace(rr=True)
            for i in range(1, cfg.ray_depth - 1):
                ro_i, rd_i, alive_i = step(cfg, i)
                args = (sampler_inputs(ro_i, rd_i, alive_i, i + 1)[2]
                        if i + 1 < cfg.ray_depth - 1 else None)
                self.levels.append((ro_i, rd_i, alive_i, args))


def modular_steps(P, state, scene, seed, wid, plain: bool):
    """``step(cfg, bounce_i) -> (ro, rd, alive)``: one modular bounce after
    another (``P._bounce`` on a (13, B) state) of the paths that start in
    ``state``, the fresh state of ``ops/camera.py:camera_state_plain``."""
    from raytracing_course_2024_tpu_torch.ops.vec import Vec3

    box = [state, None]

    def step(cfg, i):
        box[0], box[1] = P._bounce(box[0], scene, cfg, seed, wid, 0, i, plain=plain,
                                   live=box[1])
        st = box[0]
        return Vec3(st[0], st[1], st[2]), Vec3(st[3], st[4], st[5]), box[1]

    return step


def sampler_ops(m: Modular, bounce_i: int = 0) -> float:
    """fp32 operations K3 does on the inputs of bounce ``bounce_i`` (0: the
    camera state, 1: the bounce-1 state) of ``m`` (``mixture_ops``)."""
    from raytracing_course_2024_tpu_torch.ops import rng

    s, need, rd = ((m.surf, m.need, m.rd) if bounce_i == 0
                   else (m.surf1, m.need1, m.bounce1[1]))
    return mixture_ops(m.scene, s.point, s.n_geom, s.n_shade, rd * -1.0, s.roughness, need,
                       m.key, rng.batch_ctr(bounce_i * rng.draws_per_bounce(K), K))


def mixture_ops(scene, point, n_geom, n_shade, v, roughness, need, key, ctr) -> float:
    """fp32 operations K3 does on these inputs with draws at ``ctr`` (an
    ``ops.rng.Ctr``, a base per lane in the lane layout): per lane that
    samples, the candidates drawn until the first accepted one (each: the
    pick, its component's sampler, the acceptance test), then the mixture
    pdf with the light pdf of every light. Above 32 lights K3 walks the
    lights' tree for the light pdf; its nodes and tests are not counted
    here, so the bound made from these operations is a lower one."""
    from raytracing_course_2024_tpu_torch.ops import rng
    from raytracing_course_2024_tpu_torch.ops import sampling as S

    statics, lp = scene.statics, scene.lp_np
    n_comp = 3 if statics.num_lights > 0 else 2
    pending = need.clone()
    ops = torch.zeros_like(point.x, dtype=torch.float64)
    lt = torch.tensor(list(statics.light_types) or [0], device=ops.device)
    cost_light = torch.tensor([OPS_CAND["light"][int(t)] for t in lt], dtype=torch.float64,
                              device=ops.device)
    for t in range(K):
        draw = [rng.uniform_ctr(key, ctr.mix(t, r)) for r in range(7)]
        which = torch.clamp((draw[0] * n_comp).to(torch.int32), max=n_comp - 1)
        cand = S.sample_cosine_u(draw[1], draw[2], n_geom)
        cand = S.where3(which == 1, S.sample_vndf_u(draw[1], draw[2], n_geom, v, roughness),
                        cand)
        c = torch.where(which == 0, float(OPS_CAND["cosine"]), float(OPS_CAND["vndf"]))
        if statics.num_lights > 0:
            cand = S.where3(which == 2, S.sample_light_dir_u(draw[1:7], point, lp, statics),
                            cand)
            li = torch.clamp((draw[6] * statics.num_lights).to(torch.int64),
                             max=statics.num_lights - 1)
            c = torch.where(which == 2, cost_light[li], c.double())
        ops += torch.where(pending, c.double() + OPS_CAND["which"] + OPS_CAND["accept"], 0.0)
        ok = (cand.dot(n_shade) > 0.0) & (cand.dot(n_geom) > 0.0)
        pending = pending & ~ok
    per_pdf = OPS_PDF + (0 if statics.num_lights > S.UNROLL_MAX_LIGHTS else sum(
        OPS_LIGHT_PDF[t] + (OPS_LIGHT_ROT.get(t, 0) if r else 0)
        for t, r in zip(statics.light_types, statics.light_rotated)))
    return float(ops.sum()) + per_pdf * float(need.sum())


def nearest_case(what: str, ro, rd, scene, live) -> float:
    """K4 against its plain version on one set of rays, with or without a
    live mask: t and idx must be equal on every lane, masked ones included
    (the miss, t = inf and idx = 0). Returns the largest absolute error."""
    from raytracing_course_2024_tpu_torch.ops.dense_nearest import (
        dense_nearest, dense_nearest_plain)

    tk, ik = dense_nearest(ro, rd, scene.tri_pack, live=live, records=scene.tri_rec)
    tp, ip = dense_nearest_plain(ro, rd, scene.tri_pack, live=live)
    torch.cuda.synchronize()
    idx_agree = ((ik == ip) | ~torch.isfinite(tp)).float().mean().item()
    res = compare_rows([tk], [tp], torch.isfinite(tk), torch.isfinite(tp), what)
    off = torch.zeros_like(ik, dtype=torch.bool) if live is None else ~live
    exact = dict(idx_agree=round(idx_agree, 6), t_equal=bool(torch.equal(tk, tp)),
                 idx_equal=bool(torch.equal(ik, ip)),
                 masked_are_misses=bool(torch.isinf(tk[off]).all() and (ik[off] == 0).all()),
                 live_frac=round(1.0 - off.float().mean().item(), 4))
    check(exact, what + "-idx", exact["t_equal"] and exact["idx_equal"]
          and exact["masked_are_misses"] and idx_agree >= LANE_FRAC)
    return res["max_abs_err"]


def sampler_case(what: str, args: tuple, bit_exact: bool) -> float:
    """K3 against its plain version on one set of inputs: ``ok`` equal on
    every lane, l and pdf within the gate on the accepted ones (``bit_exact``:
    equal bit for bit there). Returns the largest absolute error."""
    from raytracing_course_2024_tpu_torch.ops.sampler import (
        sample_mixture_kernel, sampler_plain)

    lk, pk, okk = sample_mixture_kernel(*args)
    lp_, pp, okp = sampler_plain(*args)
    torch.cuda.synchronize()
    res = compare_rows([*lk, pk], [*lp_, pp], okk, okp, what)
    exact = dict(ok_equal=bool(torch.equal(okk, okp)),
                 bits_equal=all(bool(torch.equal(a[okp], b[okp]))
                                for a, b in zip([*lk, pk], [*lp_, pp])),
                 need_frac=round(args[10].float().mean().item(), 4))
    check(exact, what + "-exact", exact["ok_equal"] and (exact["bits_equal"] or not bit_exact))
    return res["max_abs_err"]


def first_lanes(x, n: int):
    """A tensor or Vec3 cut to its first ``n`` lanes; anything else as it is."""
    from raytracing_course_2024_tpu_torch.ops.vec import Vec3

    if isinstance(x, Vec3):
        return Vec3(*(c[:n].contiguous() for c in x))
    return x[:n].contiguous() if isinstance(x, torch.Tensor) else x


def cut_lanes(args: tuple, n: int, need) -> tuple:
    """K3's arguments on the first ``n`` lanes, with ``need`` in place of theirs."""
    out = [first_lanes(x, n) for x in args]
    out[10] = first_lanes(need, n)
    return tuple(out)


def phase_kernels_modular(dev, sizes=LANES) -> tuple:
    """K4 and K3 against their plain versions: K4 on camera and bounce-1 rays
    without a mask, with every lane live and with the bounce-1 live mask; K3
    on the surfaces of bounces 0 and 1. At the main path's 921,600 lanes
    also on what the tile walk has to get right: a lane count that is no
    multiple of the tile (921,600 - 77), whole dead warps and tiles, every
    lane masked, and K4 with the rays and live masks of the frame's levels 1
    to 5. Returns the largest absolute error of each kernel at the main
    path's lanes, and the Cornell case at those lanes for the timing phase."""
    from raytracing_course_2024_tpu_torch.scene import load_scene, parse_text_scene

    errs, cases = {"nearest": 0.0, "sampler": 0.0}, {}
    main = sizes[-1]

    def worst(kernel, size, err):
        if size == main:
            errs[kernel] = max(errs[kernel], err)

    for w, h in sizes:
        n = w * h
        m = Modular(dev, load_scene(CORNELL, w, h, 1), w, h, levels=(w, h) == main)
        for rays, (ro, rd), alive in (("camera", (m.ro, m.rd), m.alive),
                                      ("bounce1", m.bounce1, m.alive1)):
            for mask, live in (("", None), ("-masked", alive)):
                worst("nearest", (w, h), nearest_case(
                    f"cornell-{w}x{h}:nearest-{rays}{mask}", ro, rd, m.scene, live))
        for b, args in ((0, m.sampler_args), (1, m.sampler_args1)):
            worst("sampler", (w, h), sampler_case(
                f"cornell-{w}x{h}:sampler-bounce{b}", args, False))
        cases[(w, h)] = m
        if (w, h) != main:
            continue
        ro, rd = m.bounce1
        patterns = dict(tile_patterns(n, dev), ragged=None)
        for name, keep in patterns.items():
            k = n - 77 if keep is None else n  # ragged: no multiple of the tile
            ro_k, rd_k = first_lanes(ro, k), first_lanes(rd, k)
            live = first_lanes(m.alive1 if keep is None else m.alive1 & keep, k)
            nearest_case(f"cornell-{k}-lanes-{name}:nearest-bounce1-masked", ro_k, rd_k,
                         m.scene, live)
            if keep is None:
                nearest_case(f"cornell-{k}-lanes-{name}:nearest-bounce1", ro_k, rd_k,
                             m.scene, None)
            need = m.need1 if keep is None else m.need1 & keep
            sampler_case(f"cornell-{k}-lanes-{name}:sampler-bounce1",
                         cut_lanes(m.sampler_args1, k, need), False)
        for lvl, (lro, lrd, alive, _) in enumerate(m.levels):
            if lvl >= 1:
                nearest_case(f"cornell-{w}x{h}:nearest-level{lvl}-masked", lro, lrd, m.scene,
                             alive)
    w, h = sizes[0]
    for name, text in (("mixed", MIXED_SCENE), ("lights", LIGHTS_SCENE)):
        m = Modular(dev, parse_text_scene(text), w, h)
        for b, args in ((0, m.sampler_args), (1, m.sampler_args1)):
            sampler_case(f"{name}-{w}x{h}:sampler-bounce{b}", args, name == "mixed")
    return errs, cases[main]


# N1a and N1b against their plain versions: (scene, lanes) of each case
N1_CASES = (("bvh81920", LANES[1]), ("cornell", LANES[1]), ("mixed", LANES[0]))


def bit_share(kern: list, plain: list, lanes) -> float:
    """Share of ``lanes`` on which every row of ``kern`` equals ``plain``'s
    bit for bit."""
    same = lanes.clone()
    for a, b in zip(kern, plain):
        same &= a.contiguous().view(torch.int32) == b.contiguous().view(torch.int32)
    return same.float().sum().item() / max(lanes.float().sum().item(), 1.0)


def shade_case(what: str, state, t, idx, scene, bg, **kw) -> tuple:
    """N1a against its plain version on one state: the state as
    ``compare_states`` holds it, the surface rows on the lanes alive on both
    sides as ``compare_rows`` does, ``need`` on >= 99.9 % of the lanes, and
    the share of those lanes bit for bit equal. Returns (the plain version's
    outputs, the largest absolute error)."""
    from raytracing_course_2024_tpu_torch.ops.shade import shade, shade_plain

    ks, ksurf, kneed = shade(state.clone(), t, idx, scene, bg, **kw)
    ps, psurf, pneed = shade_plain(state, t, idx, scene, bg, **kw)
    torch.cuda.synchronize()
    err = compare_states(ks, ps, what)["max_abs_err"]
    both = (ks[12] > 0.5) & (ps[12] > 0.5)
    exact = dict(bit_share=round(bit_share(list(ks), list(ps), both), 6))
    ok = True
    if ksurf is not None:
        kcols, pcols = ksurf.columns(), psurf.columns()
        rows = compare_rows(kcols, pcols, ks[12] > 0.5, ps[12] > 0.5, what + "-surface")
        err = max(err, rows["max_abs_err"])
        exact.update(need_agree=round((kneed == pneed).float().mean().item(), 6),
                     bit_share=round(bit_share(list(ks) + kcols, list(ps) + pcols, both), 6))
        ok = exact["need_agree"] >= LANE_FRAC
    check(exact, what + "-exact", ok)
    return (ps, psurf, pneed), err


def finish_case(what: str, state, surf, sample, wid, seed_k, off_k, off_p, cfg, **kw) -> float:
    """N1b against its plain version on one state and sampler output: the
    state as ``compare_states`` holds it, ``live`` equal to its alive row and
    agreeing on >= 99.9 % of the lanes, the share of the lanes alive on both
    sides bit for bit equal. ``seed_k``/``off_k`` reach the kernel as the
    graphed routes hand them over, ``SEED``/``off_p`` the plain version as
    ints. Returns the largest absolute error."""
    from raytracing_course_2024_tpu_torch.ops.shade import finish, finish_plain

    l_s, pdf, ok = sample
    kf, klive = finish(state.clone(), surf, l_s, pdf, ok, wid, seed_k, off_k, cfg, **kw)
    pf, plive = finish_plain(state.clone(), surf, l_s, pdf, ok, wid, SEED, off_p, cfg, **kw)
    torch.cuda.synchronize()
    err = compare_states(kf, pf, what)["max_abs_err"]
    both = (kf[12] > 0.5) & (pf[12] > 0.5)
    exact = dict(live_agree=round((klive == plive).float().mean().item(), 6),
                 live_is_alive=bool(torch.equal(klive, kf[12] > 0.5)),
                 bit_share=round(bit_share(list(kf), list(pf), both), 6))
    check(exact, what + "-exact", exact["live_agree"] >= LANE_FRAC and exact["live_is_alive"])
    return err


def n1_scene(dev, name: str, w: int, h: int):
    """(modular scene, TraceConfig, camera description) of one N1 case."""
    from raytracing_course_2024_tpu_torch.integrator import path as P
    from raytracing_course_2024_tpu_torch.ops.scene_intersect import modular_scene
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer
    from raytracing_course_2024_tpu_torch.scene import (
        build_scene_arrays, load_scene, parse_text_scene)

    if name == "bvh81920":
        r = Renderer(bvh_desc(w, h, 1), device=dev)
        return r.scene, r.cfg, r.settings.camera
    desc = parse_text_scene(MIXED_SCENE) if name == "mixed" else load_scene(CORNELL, w, h, 1)
    arrays, statics = build_scene_arrays(desc)
    cfg = P.TraceConfig(ray_depth=desc.settings.ray_depth,
                        bg_color=tuple(desc.settings.bg_color), max_tries=K)
    return modular_scene(arrays, statics, dev), cfg, desc.settings.camera


N1_SPARSE = 0.04  # the sparse state keeps this share of the bounce-1 state's live lanes
N1_DEEP = 3  # the deep state: the lanes entering this level
N1_LEVELS = {"camera": 0, "bounce1": 1, f"bounce{N1_DEEP}": N1_DEEP}  # timed state -> level


def n1_states(dev, scene, cfg, camera, w: int, h: int, deep: bool) -> tuple:
    """(work ids, keys, states) of one (w, h) frame's sample 0 on the modular
    route: the camera state, the state after one bounce through the route's
    kernels (``bounce1``) and, with ``deep``, after ``N1_DEEP`` bounces
    (``bounce3``: the lanes entering the last level of a depth-4 frame, most
    of them dead)."""
    from raytracing_course_2024_tpu_torch.integrator import path as P
    from raytracing_course_2024_tpu_torch.ops import rng
    from raytracing_course_2024_tpu_torch.ops.camera import camera_arrays, camera_state_plain

    n = w * h
    wid = torch.arange(n, device=dev, dtype=torch.int32)
    key = rng.work_key(SEED, wid)
    st = camera_state_plain(SEED, wid, 0, (wid % w).float(), (wid // w).float(),
                            camera_arrays(camera), w, h)
    states = {"camera": st.clone()}
    for b in range(N1_DEEP if deep else 1):
        st, _ = P._bounce(st, scene, cfg, SEED, wid, 0, b)
        if b == 0:
            states["bounce1"] = st.clone()
    if deep:
        states[f"bounce{N1_DEEP}"] = st
    return wid, key, states


def n1_timing_case(st, scene, cfg, wid, bounce_i: int) -> dict:
    """What ``shade_times`` reads of one state in the batch layout at level
    ``bounce_i``: the nearest hit over the finite table, the plain N1a's
    outputs and K3's sample on them."""
    from raytracing_course_2024_tpu_torch.ops import rng
    from raytracing_course_2024_tpu_torch.ops.sampler import sample_mixture_kernel
    from raytracing_course_2024_tpu_torch.ops.shade import sampler_inputs, shade_plain
    from raytracing_course_2024_tpu_torch.ops.traverse import nearest_table
    from raytracing_course_2024_tpu_torch.ops.vec import Vec3

    t, idx = nearest_table(Vec3(st[0], st[1], st[2]), Vec3(st[3], st[4], st[5]), scene,
                           live=st[12] > 0.5)
    ps, psurf, pneed = shade_plain(st, t, idx, scene, cfg.bg_color)
    sargs = (scene, SEED, wid, 0, rng.batch_ctr(bounce_i * rng.draws_per_bounce(K), K),
             *sampler_inputs(psurf), pneed, K)
    return dict(st=st, t=t, idx=idx, ps=ps, psurf=psurf, sample=sample_mixture_kernel(*sargs),
                bounce_i=bounce_i)


def phase_kernels_shade(dev) -> tuple:
    """N1a and N1b against their plain versions on the BVH scene's and the
    Cornell scene's 921,600-lane camera and bounce-1 states and MIXED's
    262,144 (planes, rotated boxes, an ellipsoid, MIRROR and DIELECTRIC),
    on a sparse state of each (``N1_SPARSE`` of the bounce-1 state's live
    lanes kept, at random: at most 5 % live, many warps all dead) and on
    the BVH scene's bounce-3 state: N1a in the batch layout, in the lane
    layout (per-lane depths 0 .. last, the final-depth rule) and at the
    last level (emission only); N1b on the plain N1a's outputs and the
    sampler's, in the batch layout at bounce ``RR_START`` with roulette off
    and on and faithful acceptance off and on (the kernel given the seed and
    a work-id offset past 2^32 as a device pair), and in the lane layout
    with roulette. The bounce-1 state is one bounce of the camera state
    through the modular route's kernels. Returns the largest absolute error
    of each kernel and, for the timing phase, the BVH scene's camera,
    bounce-1 and bounce-3 states."""
    from raytracing_course_2024_tpu_torch.ops import rng
    from raytracing_course_2024_tpu_torch.ops.sampler import sample_mixture_kernel, sampler_plain
    from raytracing_course_2024_tpu_torch.ops.sampling import sample_mixture
    from raytracing_course_2024_tpu_torch.ops.shade import RR_START, sampler_inputs
    from raytracing_course_2024_tpu_torch.ops.traverse import nearest_table
    from raytracing_course_2024_tpu_torch.ops.vec import Vec3

    errs, timing = {"shade": 0.0, "finish": 0.0}, {}
    seed_k, off_k = route_pair(SEED, KERNEL_WID_OFF, dev)
    for name, (w, h) in N1_CASES:
        scene, cfg, camera = n1_scene(dev, name, w, h)
        n, bg, last = w * h, cfg.bg_color, cfg.ray_depth - 1
        bvh = name == "bvh81920"
        wid, key, states = n1_states(dev, scene, cfg, camera, w, h, deep=bvh)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        sparse = states["bounce1"].clone()
        sparse[12] *= (torch.rand(n, generator=gen, device=dev) < N1_SPARSE).float()
        states["sparse"] = sparse
        live_share = float((sparse[12] > 0.5).float().mean())
        say("kernels", case=f"{name}-{n}:sparse", live_share=round(live_share, 4))
        if live_share > 0.05:
            raise SystemExit(f"the sparse state of {name} has {live_share:.2%} live lanes")
        depth = ((torch.arange(n, device=dev) * 7 // 3) % (last + 1)).to(torch.int32)
        for state_name, st in states.items():
            tag = f"{name}-{n}:{state_name}"
            live = st[12] > 0.5
            t, idx = nearest_table(Vec3(st[0], st[1], st[2]), Vec3(st[3], st[4], st[5]), scene,
                                   live=live)
            (ps, psurf, pneed), e1 = shade_case(f"{tag}:shade", st, t, idx, scene, bg)
            (pl, plsurf, plneed), e2 = shade_case(f"{tag}:shade-lane", st, t, idx, scene, bg,
                                                  depth=depth, last=last)
            _, e3 = shade_case(f"{tag}:shade-final", st, t, idx, scene, bg, final=True)
            errs["shade"] = max(errs["shade"], e1, e2, e3)
            ctr = rng.batch_ctr(RR_START * rng.draws_per_bounce(K), K)
            args = (scene, SEED, wid, KERNEL_WID_OFF, ctr, *sampler_inputs(psurf), pneed, K)
            for rr, faithful in ((False, False), (True, False), (False, True), (True, True)):
                c = cfg._replace(rr=rr, faithful=faithful)
                sample = (sampler_plain(*args, faithful=True) if faithful
                          else sample_mixture_kernel(*args))
                mode = "-".join(["rr" if rr else "no-rr"] + (["faithful"] if faithful else []))
                errs["finish"] = max(errs["finish"], finish_case(
                    f"{tag}:finish-{mode}", ps, psurf, sample, wid, seed_k, off_k,
                    KERNEL_WID_OFF, c, bounce_i=RR_START))
            lane_sample = sample_mixture(
                rng.mixture_rows(key, rng.lane_ctr(depth, K), K), *sampler_inputs(plsurf),
                scene.lp_np, scene.statics, K, need=plneed, lp_dev=scene.light_packed)
            errs["finish"] = max(errs["finish"], finish_case(
                f"{tag}:finish-lane-rr", pl, plsurf, lane_sample, wid, SEED, 0, 0,
                cfg._replace(rr=True), depth=depth))
            if bvh and state_name in N1_LEVELS:
                timing[state_name] = n1_timing_case(st, scene, cfg, wid, N1_LEVELS[state_name])
        if bvh:
            timing.update(scene=scene, cfg=cfg, wid=wid)
        del states, sparse
    return errs, timing


# the lane round's kernels against their plain versions (phase_kernels_round):
# the refills and sticky rounds held are the first at or after each of these
# rounds, and the last one
ROUND_AT = (1, 10)
ROUND_TIMED = "round10"  # the state whose times go to the kernels line
ROUND_REPS = 20
STICKY_JMAX_LANES = 262_144  # a sticky state whose lanes own 4 pixels each


def round_tag(rnd: int, taken: dict) -> list:
    """The snapshot names a refill or a round ``rnd`` fills: ``roundN`` for
    the first at or after each of ``ROUND_AT`` not yet taken, and ``last``."""
    return [f"round{r}" for r in ROUND_AT if rnd >= r and f"round{r}" not in taken] + ["last"]


def lane_snapshots(r, sticky_lanes: int | None = None) -> dict:
    """One eager frame of ``r``'s scene (a ``ModularScene``) on each lane
    engine, with the bodies' buffers copied just before chosen calls
    (``lane_spy``): ``refill`` (the counter wavefront's refills), ``core``
    (its bounces, whose sampler inputs K3 in lane mode is held on) and
    ``restart`` (the sticky rounds, restart first), each name -> (round,
    tensors, the arguments after them); ``refill["tail"]`` is the refill
    whose dead lanes outnumber the work items left. ``sticky_lanes`` also renders the
    sticky frame on that many lanes at 4 spp (lanes owning several pixels):
    its round-10 state goes in as ``restart["jmax"]``."""
    from raytracing_course_2024_tpu_torch.integrator import wavefront as W

    s = r.settings
    w, h, spp = s.width, s.height, s.samples
    n_pix = w * h
    snaps = {"refill": {}, "core": {}, "restart": {}}

    def keep(kind, rnd, tensors, args, names=None):
        for name in names or round_tag(rnd, snaps[kind]):
            snaps[kind][name] = (rnd, [x.clone() for x in tensors],
                                 [x.clone() if isinstance(x, torch.Tensor) else x for x in args])

    def on_refill(b, rnd):
        c = b.core
        names = round_tag(rnd, snaps["refill"])
        left = b.total - int(b.counter)
        if "tail" not in snaps["refill"] and 0 < left < int((c.state[12] < 0.5).sum()):
            names.append("tail")  # the work's tail: some dead lanes take nothing
        keep("refill", rnd, (c.state, b.work, b.counter, b.done, c.depth, c.wid),
             (c.seed_off, b.bases, b.frame), names)

    def on_core(c, rnd):
        keep("core", rnd, (c.state, c.wid, c.depth), (c.seed_off,))

    def on_sticky(b, rnd):
        keep("restart", rnd, (b.state, b.k, b.kmax, b.depth, b.wid, b.acc),
             (b.seed_off, b.bases, b.frame))

    seed32 = (SEED * 2654435761) & 0xFFFFFFFF
    lanes = min(r.batch_size, n_pix * spp)
    with lane_spy(on_refill, on_core, on_sticky):
        W.render_wavefront(seed32, 0, 0, r.cam, r.scene, r.cfg, w, h, n_pix, spp, lanes)
        W.render_wavefront_sticky(seed32, 0, 0, r.cam, r.scene, r.cfg, w, h, n_pix, spp,
                                  lanes)
    if sticky_lanes:
        jmax = {}

        def on_jmax(b, rnd):
            if rnd == ROUND_AT[-1]:
                jmax["body"] = b
                keep("restart", rnd, (b.state, b.k, b.kmax, b.depth, b.wid, b.acc),
                     (b.seed_off, b.bases, b.frame), ["jmax"])

        with lane_spy(on_sticky=on_jmax):
            W.render_wavefront_sticky(seed32, 0, 0, r.cam, r.scene, r.cfg, w, h, n_pix, 4,
                                      sticky_lanes)
        if jmax["body"].jmax < 2:
            raise SystemExit(f"the sticky state on {sticky_lanes} lanes has jmax "
                             f"{jmax['body'].jmax}")
    return snaps


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def camera_bytes(n: int) -> float:
    """N4's bytes for ``n`` lanes: the work id, px and py read (12 B a lane),
    the 13 rows of the fresh state written (52 B), the seed pair and the
    camera row's 14 floats read once."""
    return n * (12 + 52) + 16 + 14 * 4


# N4 against its plain version: lanes of the 1280x720 frame's first pixels
# (997 and 921,523 leave a ragged last block) and of the 512x512 frame
CAMERA_LANES = ((997, FRAME[:2]), (262_144, LANES[0]), (921_523, FRAME[:2]),
                (921_600, FRAME[:2]))


def camera_case(n: int, size: tuple, dev):
    """(camera, its row on ``dev``, wid, px, py, width, height) of ``n``
    lanes of a frame of ``size`` (the Cornell camera): the frame's first
    ``n`` pixels."""
    from raytracing_course_2024_tpu_torch.ops import camera as C
    from raytracing_course_2024_tpu_torch.scene import load_scene

    w, h = size
    cam = C.camera_arrays(load_scene(CORNELL, w, h, 1).settings.camera)
    row = torch.from_numpy(C.pack_camera_row(cam)[0]).to(dev)
    wid = torch.arange(n, device=dev, dtype=torch.int32)
    return cam, row, wid, (wid % w).float(), (wid // w).float(), w, h


def phase_kernels_camera(dev) -> float:
    """N4 (``ops/camera.py:camera_state``) against its plain version at
    ``CAMERA_LANES``, bit for bit on every lane and row: launched eagerly
    with the seed pair on the device and a work-id offset past 2^32, then
    captured once in a CUDA graph and replayed after the pair changed on the
    device (another seed and offset). Returns the largest absolute error."""
    from raytracing_course_2024_tpu_torch.ops import camera as C

    err = 0.0
    for n, size in CAMERA_LANES:
        cam, row, wid, px, py, w, h = camera_case(n, size, dev)
        pair = torch.tensor([SEED, KERNEL_WID_OFF], dtype=torch.int64, device=dev)
        got = C.camera_state(pair[0], wid, pair[1], px, py, cam, row, w, h)
        want = C.camera_state_plain(SEED, wid, KERNEL_WID_OFF, px, py, cam, w, h)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        err = max(err, e)
        check({"lanes": n, "frame": f"{w}x{h}", "bit_equal": bit_equal(got, want),
               "max_abs_err": e}, f"camera-{n}", bit_equal(got, want))
        out = torch.empty_like(got)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            C.camera_state(pair[0], wid, pair[1], px, py, cam, row, w, h, out=out)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            C.camera_state(pair[0], wid, pair[1], px, py, cam, row, w, h, out=out)
        seed2, off2 = SEED + 1, 7 * n
        pair.copy_(torch.tensor([seed2, off2], dtype=torch.int64))
        out.fill_(float("nan"))
        graph.replay()
        want = C.camera_state_plain(seed2, wid, off2, px, py, cam, w, h)
        torch.cuda.synchronize()
        same = bit_equal(out, want)
        check({"lanes": n, "bit_equal_replayed": same,
               "max_abs_err": float((out - want).abs().max())}, f"camera-{n}-graphed", same)
        del graph
    return err


def camera_times(dev, reps: int = 50) -> dict:
    """N4 on the main path's 921,600 lanes, written into one buffer as the
    modular route writes its state: ms per launch (``cuda_ms_each``), its
    plain version's ms, the bound of ``camera_bytes``."""
    from raytracing_course_2024_tpu_torch.ops import camera as C

    cam, row, wid, px, py, w, h = camera_case(FRAME[0] * FRAME[1], FRAME[:2], dev)
    pair = torch.tensor([1, 0], dtype=torch.int64, device=dev)
    out = torch.empty((13, wid.shape[0]), dtype=torch.float32, device=dev)
    ms = cuda_ms_each(lambda: C.camera_state(pair[0], wid, pair[1], px, py, cam, row, w, h,
                                             out=out), reps)
    plain = cuda_ms(lambda: C.camera_state_plain(pair[0], wid, pair[1], px, py, cam, w, h), 2)
    return {"ms": ms, "plain_ms": plain, "bound": bound(camera_bytes(wid.shape[0]), 0.0)}


# N5 against its plain version: lane counts (ragged, the sticky engine's
# 262,144, a ragged frame, the lane engines' 1,048,576) and live shares
LOOP_LANES = (997, 262_144, 921_523, 1_048_576)
LOOP_LIVE = 0.03
LOOP_LAST = 5  # the final depth of the tails' cases (the Cornell frame's ray_depth - 1)
LOOP_SAMPLES = 2  # the sticky cases' samples per pixel
# the tails N5 runs: name -> ops/loop.py's TAIL_ constant (None: ``round_test``,
# the test alone on an alive row, kmax read from memory)
LOOP_TAILS = {"test": None, "none": 0, "depth": 1, "fused": 2}


def loop_inputs(n: int, live: float, gen: torch.Generator, dev) -> dict:
    """N5's inputs on ``n`` lanes: an alive row with ``live`` of its lanes
    set, paths started ``k`` and owned ``kmax`` (int64, 0-3), the work
    counter (3 n of 4 n items handed out)."""
    def ints(hi):
        return torch.randint(0, hi, (n,), generator=gen).to(dev)

    return {"alive": (torch.rand(n, generator=gen) < live).float().to(dev), "k": ints(4),
            "kmax": ints(4), "counter": torch.tensor(3 * n, device=dev), "total": 4 * n,
            "thresh": max(n // 8, 1)}


def tail_inputs(n: int, live: float, gen: torch.Generator, dev) -> dict:
    """A round's state as N5's tails find it, on ``n`` lanes: 32-lane runs
    of one kind (all alive, all dying in the round, all parked on entry) or
    mixed lane by lane; a lane alive with ``live`` odds (some of the alive
    flags off 0 and 1), dead lanes parked on entry or holding a ray,
    depths 0 .. LOOP_LAST + 1, paths started ``k`` 0 .. 4 samples; the
    sticky frame's ``n_pix`` (lanes owning 2 or 3 pixels, or past the
    pixels) and the work counter. The state's rows 6-11 random."""
    from raytracing_course_2024_tpu_torch.ops.shade import PARK_DIR, PARK_ORIGIN

    def rand(*shape):
        return torch.rand(*shape, generator=gen)

    run = torch.randint(0, 4, (-(-n // 32),), generator=gen).repeat_interleave(32)[:n]
    alive = torch.where(run == 1, 1.0, torch.where(run >= 2, 0.0, (rand(n) < live).float()))
    odd = rand(n) < 0.01
    alive = torch.where(odd, torch.where(alive > 0.5, 0.75, 0.25), alive)
    parked = (alive < 0.5) & ((run == 3) | ((run == 0) & (rand(n) < 0.5)))
    state = rand(13, n) * 4.0 - 2.0
    state[12] = alive
    state[0:3] = torch.where(parked, PARK_ORIGIN, state[0:3])
    state[3:6] = torch.where(parked, PARK_DIR, state[3:6])
    n_pix = 2 * n + n // 3 if n % 2 == 0 else n - n // 10
    return {"state": state.to(dev),
            "depth": torch.randint(0, LOOP_LAST + 2, (n,), generator=gen,
                                   dtype=torch.int32).to(dev),
            "k": torch.randint(0, 4 * LOOP_SAMPLES, (n,), generator=gen).to(dev),
            "n_pix": n_pix, "samples": LOOP_SAMPLES, "last": LOOP_LAST,
            "counter": torch.tensor(3 * n, device=dev), "total": 4 * n,
            "thresh": max(n // 8, 1)}


def loop_states(dev, start: torch.Tensor):
    """A kernel's and a twin's ``LoopState`` from the same counters."""
    from raytracing_course_2024_tpu_torch.ops.loop import LoopState

    pair = (LoopState(dev), LoopState(dev))
    for ls in pair:
        ls.loop.copy_(start)
    return pair


def same_loop(a, b) -> bool:
    return (torch.equal(a.loop, b.loop) and torch.equal(a.preds, b.preds)
            and not a.scratch.any().item())


def tail_call(ls, mode: int, tail, ins: dict, plain: bool):
    """N5 (or its plain version) of ``tail`` (a ``LOOP_TAILS`` value) on
    ``ins``: ``round_test`` on an alive row and kmax, or ``round_tail`` on
    the state; returns a call of no arguments."""
    from raytracing_course_2024_tpu_torch.ops import loop as LP

    if tail is None:
        fn = LP.round_test_plain if plain else LP.round_test
        keys = ("alive", "k", "kmax", "counter", "total", "thresh")
    else:
        fn = LP.round_tail_plain if plain else LP.round_tail
        keys = ("k", "n_pix", "samples", "last", "counter", "total", "thresh")
    kw = {key: ins[key] for key in keys}
    if tail is None:
        return lambda: fn(ls, mode, **kw)
    return lambda: fn(ls, mode, ins["state"], ins["depth"], tail, **kw)


def tail_case(n: int, mode: int, tail, gen: torch.Generator, dev) -> tuple:
    """Inputs of one N5 case: the kernel's and the twin's (separate state
    and depth buffers, the tails write them)."""
    if tail is None:
        ins = loop_inputs(n, LOOP_LIVE, gen, dev)
        return ins, ins
    ins = tail_inputs(n, 0.5, gen, dev)
    twin = dict(ins, state=ins["state"].clone(), depth=ins["depth"].clone())
    return ins, twin


def same_tail(kern, twin, ins: dict, twin_ins: dict, tail) -> bool:
    """The kernel's loop, predicates, state rows and depths equal the
    twin's, bit for bit, and its scratch is back at 0."""
    if not same_loop(kern, twin):
        return False
    if tail is None:
        return True
    return bit_equal(ins["state"], twin_ins["state"]) and torch.equal(ins["depth"],
                                                                     twin_ins["depth"])


def phase_kernels_loop(dev) -> float:
    """N5 (``ops/loop.py``) against its plain version, exactly, on
    ``LOOP_LANES`` lanes in both lane modes (the counter wavefront's and the
    sticky engine's) and every tail (``LOOP_TAILS``: the test alone, and
    ``round_tail`` with no tail, the depth step and the fused core's cap,
    park and depth step, on states with parked rows and depths among their
    lanes, ``tail_inputs``): three launches in a row from counters that are
    not zero, eagerly; then replayed from a graph captured with the launch
    inside an IF node (``runtime/graphs.py:guard``), the inputs changed
    before each replay and the predicate true, false, true: the kernel's
    counters, predicates, alive row, depth row and six ray rows equal the
    twin's run as often as the predicate was true, and its scratch is back
    at 0. (K5's own round test: ``compare_persistent``.)"""
    from raytracing_course_2024_tpu_torch.ops import loop as LP
    from raytracing_course_2024_tpu_torch.runtime.graphs import capture, guard

    gen = torch.Generator().manual_seed(SEED)
    start = torch.arange(LP.N_LOOP, device=dev) * 7 + 1
    for n in LOOP_LANES:
        for mode, name in ((LP.COUNTER, "counter"), (LP.STICKY, "sticky")):
            for tail_name, tail in LOOP_TAILS.items():
                ins, twin_ins = tail_case(n, mode, tail, gen, dev)
                kern, twin = loop_states(dev, start)
                for _ in range(3):
                    tail_call(kern, mode, tail, ins, False)()
                    tail_call(twin, mode, tail, twin_ins, True)()
                torch.cuda.synchronize()
                eager = same_tail(kern, twin, ins, twin_ins, tail)
                kern, twin = loop_states(dev, start)
                pred = torch.ones((), dtype=torch.bool, device=dev)
                replay, launches, _ = capture(
                    lambda: guard(pred, tail_call(kern, mode, tail, ins, False), "test", {}), dev)
                tail_call(twin, mode, tail, twin_ins, True)()  # the capture's warm-up ran it once
                replayed = []
                for on in (True, False, True):
                    fresh, _ = tail_case(n, mode, tail, gen, dev)
                    for key in ("alive", "k", "kmax", "counter", "state", "depth"):
                        if key in fresh:
                            ins[key].copy_(fresh[key])
                            twin_ins[key].copy_(fresh[key])
                    pred.fill_(on)
                    replay()
                    if on:
                        tail_call(twin, mode, tail, twin_ins, True)()
                    torch.cuda.synchronize()
                    replayed.append(same_tail(kern, twin, ins, twin_ins, tail))
                say("kernels", case=f"loop-{name}-{tail_name}-{n}", lanes=n,
                    live_share=LOOP_LIVE if tail is None else 0.5, bit_equal=eager,
                    bit_equal_replayed=all(replayed), replays="true,false,true",
                    loop=json.dumps(kern.loop.tolist()).replace(" ", ""))
                if not (eager and all(replayed)):
                    raise SystemExit(f"N5 ({name}, tail {tail_name}, {n} lanes) differs from "
                                     f"its plain version: eager {eager}, replayed {replayed}")
    return 0.0


def loop_bytes(n: int, dead: int, sticky: bool) -> float:
    """The test's bytes on ``n`` lanes (no tail): the alive row (4 B a
    lane) and, in sticky mode, k and kmax (16 B, ``round_test`` reads both)
    of the ``dead`` lanes; the counters (6 int64, read and written), the
    predicates, the work counter."""
    return n * 4 + (dead * 16 if sticky else 0) + 6 * 8 * 2 + 2 + 8


def tail_bytes(before: torch.Tensor, after: torch.Tensor, tail: int, sticky: bool) -> float:
    """The bytes one N5 launch of ``tail`` must move on the (13, n) state
    ``before``, which its plain version turns into ``after``, counting an
    output only where it changes: the alive row read; the depths read and
    written (tails depth and fused); alive written where it changes and
    each element of the ray rows that changes (fused: the lanes it parks
    that were not parked); in sticky mode k of the lanes dead after the
    tail (kmax follows from the lane index); the counters, predicates and
    the work counter."""
    n = before.shape[1]
    moved = n * 4 + (n * 8 if tail else 0)
    moved += 4 * float((after[12] != before[12]).sum() + (after[0:6] != before[0:6]).sum())
    if sticky:
        moved += 8 * float((after[12] < 0.5).sum())
    return moved + 6 * 8 * 2 + 2 + 8


LOOP_TIMED_LANES = (1_048_576, 262_144)  # the lane engines' default and the sticky frame's


def loop_times(dev, reps: int = 50) -> dict:
    """N5 alone (the test on an alive row) per launch (``cuda_ms_each``) on
    ``LOOP_TIMED_LANES`` lanes: half of them alive in counter mode, and in
    sticky mode with 76 % dead (the BVH sticky frame's round 10); its plain
    version beside it; the bound from ``loop_bytes``. Then a graph of
    ``ROUNDS_PER_REPLAY`` N5 launches, each in an IF node
    (``runtime/graphs.py:guard``), replayed back to back: device ms a round
    with the predicate false (what a round after the loop's end costs a
    replay) and true (N5 and its IF node). Keys of the 262,144-lane cases
    end in ``_262144``. ``ms_floor``: the test on 4 lanes, one block, the
    launch's fixed cost as an event pair sees it."""
    from raytracing_course_2024_tpu_torch.integrator import wavefront as W
    from raytracing_course_2024_tpu_torch.ops import loop as LP
    from raytracing_course_2024_tpu_torch.runtime.graphs import capture, guard

    gen = torch.Generator().manual_seed(SEED + 1)
    out = {"lanes": LOOP_TIMED_LANES[0]}
    for n in LOOP_TIMED_LANES:
        at = "" if n == LOOP_TIMED_LANES[0] else f"_{n}"
        for mode, name, live in ((LP.COUNTER, "", 0.5), (LP.STICKY, "_sticky", 0.24)):
            ins = loop_inputs(n, live, gen, dev)
            kern, twin = loop_states(dev, torch.zeros(LP.N_LOOP, dtype=torch.int64, device=dev))
            dead = int((ins["alive"] < 0.5).sum())
            out["ms" + name + at] = cuda_ms_each(lambda: LP.round_test(kern, mode, **ins), reps)
            out["plain_ms" + name + at] = cuda_ms(
                lambda: LP.round_test_plain(twin, mode, **ins), reps)
            out["bound" + name + at] = bound(loop_bytes(n, dead, mode == LP.STICKY), 0.0)
            out["active_in" + name + at] = live
    ins = loop_inputs(4, 0.5, gen, dev)
    ls = LP.LoopState(dev)
    out["ms_floor"] = cuda_ms_each(lambda: LP.round_test(ls, LP.COUNTER, **ins), reps)
    per = W.ROUNDS_PER_REPLAY
    ins = loop_inputs(LOOP_TIMED_LANES[0], 0.5, gen, dev)
    ls, pred = LP.LoopState(dev), torch.zeros((), dtype=torch.bool, device=dev)

    def rounds():
        for _ in range(per):
            guard(pred, lambda: LP.round_test(ls, LP.COUNTER, **ins), "round", {})

    replay, _, _ = capture(rounds, dev)
    out["skipped_round_ms"] = cuda_ms(replay, 200) / per
    pred.fill_(True)
    out["guarded_round_ms"] = cuda_ms(replay, 200) / per
    return out


# the lane frames' states on which the fused tail is timed: name -> (Renderer
# keywords, the round), the Cornell frame's state after K1 of that round: in
# the frame's middle no lane enters a round dead (the refill or the restart
# starts them all), near its end most do (of 47 and 295 rounds)
TAIL_STATES = {
    "cornell-wavefront-round10": ({"engine": "wavefront"}, 10),
    "cornell-wavefront-round40": ({"engine": "wavefront"}, 40),
    "cornell-sticky-262144-round10": ({"engine": "sticky", "batch_size": 262_144}, 10),
    "cornell-sticky-262144-round285": ({"engine": "sticky", "batch_size": 262_144}, 285),
}


def tail_state(desc, dev, kw: dict, rnd: int) -> dict:
    """The input of a fused lane round's tail: one eager frame of ``desc``
    on the engine of ``kw`` (the counter wavefront, or the sticky engine
    below one lane per pixel, on K1 in lane mode), its bodies' buffers
    copied just before round ``rnd``; then that round's work before the
    tail on the copies (the sticky restart, N2b; K1 in lane mode, in
    place). Also whether K1 wrote the rays of the lanes dead on entry
    through unchanged and how many of them held a parked ray (a tail could
    leave those lanes' rows alone; N5 rewrites them, which measured
    faster). Works on any tree whose ``ops/refill.py`` has
    ``sticky_kmax``."""
    from raytracing_course_2024_tpu_torch.integrator import wavefront as W
    from raytracing_course_2024_tpu_torch.ops import bounce as B
    from raytracing_course_2024_tpu_torch.ops import refill as RF
    from raytracing_course_2024_tpu_torch.ops.shade import PARK_ORIGIN
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer

    r = Renderer(desc, device=dev, eager=True, **kw)
    s = r.settings
    w, h, spp = s.width, s.height, s.samples
    n_pix = w * h
    lanes = min(r.batch_size, n_pix * spp)
    seed32 = (SEED * 2654435761) & 0xFFFFFFFF
    got, refills = {}, []

    def clone(xs):
        return [x.clone() if isinstance(x, torch.Tensor) else x for x in xs]

    def on_refill(b, _):
        refills[:] = [b]

    def on_core(c, at):
        if at == rnd and not got:
            got["lanes"] = clone((c.state, c.wid, c.depth, c.seed_off))
            got["counter"] = refills[0].counter.clone()
            got["total"] = refills[0].total

    def on_sticky(b, at):
        if at == rnd and not got:
            got["lanes"] = clone((b.state, b.wid, b.depth, b.seed_off))
            got["restart"] = clone((b.k, b.kmax, b.acc, b.bases, b.frame))

    with lane_spy(on_refill, on_core, on_sticky):
        if kw["engine"] == "wavefront":
            W.render_wavefront(seed32, 0, 0, r.cam, r.scene, r.cfg, w, h, n_pix, spp, lanes)
        else:
            W.render_wavefront_sticky(seed32, 0, 0, r.cam, r.scene, r.cfg, w, h, n_pix, spp,
                                      lanes)
    state, wid, depth, pair = got["lanes"]
    out = {"lanes": lanes, "n_pix": n_pix, "samples": spp, "last": r.cfg.ray_depth - 1,
           "sticky": kw["engine"] == "sticky"}
    if out["sticky"]:
        k, kmax, acc, bases, frame = got["restart"]
        RF.restart(state, k, kmax, depth, wid, acc, pair, bases, frame)
        out.update(k=k, kmax=kmax)
    else:
        out.update(counter=got["counter"], total=got["total"],
                   thresh=W.refill_thresh(lanes))
    before = state.clone()
    dead = before[12] < 0.5
    B.bounce(r.scene, state, wid, pair[1], pair[0], 0, r.cfg.bg_color, r.cfg.max_tries,
             out=state, depth=depth)
    torch.cuda.synchronize()
    out.update(state=state, depth=depth, dead_on_entry=int(dead.sum()),
               dead_rows_unchanged=bit_equal(state[0:6][:, dead], before[0:6][:, dead]),
               dead_parked_on_entry=int((before[0][dead] == PARK_ORIGIN).sum()),
               dying=int(((state[12] < 0.5) & ~dead).sum()))
    del r
    return out


def tail_times(dev, desc, gpu: str, reps: int = ROUND_REPS) -> dict:
    """The end of a fused lane round on ``TAIL_STATES``' states
    (``tail_state``), per launch in place, the state and depths put back
    outside each event pair (``cuda_ms_in_place``): ``aten``, the
    sequence the round ran before N5 took the tail over (``ops/shade.py:
    park`` with the final-depth cap and the depth step as ATen ops, then the
    test alone, ``round_test``), and on a tree with ``round_tail`` the
    fused tail (``TAIL_FUSED``), held bit for bit against its plain version
    (state, depths, counters), its plain version's ms and the bound of
    ``tail_bytes``. Prints one ``[timing] kernel=loop-tail`` line a state;
    returns them by state."""
    from raytracing_course_2024_tpu_torch.ops import loop as LP
    from raytracing_course_2024_tpu_torch.ops.refill import sticky_kmax
    from raytracing_course_2024_tpu_torch.ops.shade import park

    out = {}
    for name, (kw, rnd) in TAIL_STATES.items():
        t = tail_state(desc, dev, kw, rnd)
        mode = LP.STICKY if t["sticky"] else LP.COUNTER
        st0, d0 = t["state"], t["depth"]
        st, d = st0.clone(), d0.clone()
        ls = LP.LoopState(dev)
        test = ({"k": t["k"], "kmax": sticky_kmax(t["lanes"], t["n_pix"], t["samples"], dev)}
                if t["sticky"] else {key: t[key] for key in ("counter", "total", "thresh")})

        def restore():
            st.copy_(st0)
            d.copy_(d0)

        def aten():
            park(st, (st[12] > 0.5) & (d < t["last"]))
            d.add_(1)
            LP.round_test(ls, mode, alive=st[12], **test)

        res = {"lanes": t["lanes"], "dead_on_entry": t["dead_on_entry"],
               "dead_rows_unchanged": t["dead_rows_unchanged"],
               "dead_parked_on_entry": t["dead_parked_on_entry"], "dying": t["dying"],
               "aten_ms": cuda_ms_in_place(aten, restore, reps)}
        if hasattr(LP, "round_tail"):
            kw_tail = ({"k": t["k"], "n_pix": t["n_pix"], "samples": t["samples"]}
                       if t["sticky"] else test)
            twin = (st0.clone(), d0.clone(), LP.LoopState(dev))
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            LP.round_tail_plain(twin[2], mode, twin[0], twin[1], LP.TAIL_FUSED, t["last"],
                                **kw_tail)
            end.record()
            restore()
            ls = LP.LoopState(dev)
            LP.round_tail(ls, mode, st, d, LP.TAIL_FUSED, t["last"], **kw_tail)
            torch.cuda.synchronize()
            equal = (bit_equal(st, twin[0]) and torch.equal(d, twin[1])
                     and same_loop(ls, twin[2]))
            parked_now = int(((twin[0][0] != st0[0]) & (twin[0][12] < 0.5)).sum())
            res.update(bit_equal=equal, parked_in_round=parked_now,
                       plain_ms=start.elapsed_time(end),
                       ms=cuda_ms_in_place(lambda: LP.round_tail(
                           ls, mode, st, d, LP.TAIL_FUSED, t["last"], **kw_tail), restore, reps),
                       bound=bound(tail_bytes(st0, twin[0], LP.TAIL_FUSED, t["sticky"]), 0.0))
            if not equal:
                raise SystemExit(f"N5's fused tail on {name} differs from its plain version")
        say("timing", kernel="loop-tail", state=name, **{
            k: (round(v, 5) if isinstance(v, float) else v) for k, v in res.items()
            if k != "bound"}, **({"bound_ms": round(res["bound"][0], 5),
                                  "bound_by": res["bound"][1],
                                  "share": round(res["bound"][0] / res["ms"], 4)}
                                 if "bound" in res else {}), gpu=f'"{gpu}"')
        out[name] = res
        del t, st0, st
        torch.cuda.empty_cache()
    return out


# the lane frames whose loop runs on the card (integrator/wavefront.py):
# name -> (scene, Renderer keywords)
LOOP_FRAMES = {
    "bvh-wavefront": ("bvh", {"engine": "wavefront"}),
    "bvh-sticky": ("bvh", {"engine": "sticky"}),
    "cornell-wavefront-fused": ("cornell", {"engine": "wavefront"}),
    "cornell-sticky-fused-262144": ("cornell", {"engine": "sticky", "batch_size": 262_144}),
    "cornell-sticky-k5": ("cornell", {"engine": "sticky"}),
}
# host reads a frame may make: one per replay of ROUNDS_PER_REPLAY rounds,
# and this many beside (the replay queued before the read that ends the loop)
LOOP_READS_EXTRA = 2
_READS = ("item", "__bool__", "__int__", "__float__", "__index__", "tolist", "cpu", "numpy")


@contextlib.contextmanager
def host_reads():
    """Counts the frame's waits on the card while active: every
    ``torch.cuda.Event.synchronize`` and ``torch.cuda.synchronize``, and
    every read of a CUDA tensor by the host (``item``, ``bool``, ``int``,
    ``float``, ``tolist``, ``cpu``, ``numpy``). Yields a one-element list;
    works on any tree."""
    count = [0]
    saved = [(torch.Tensor, k, getattr(torch.Tensor, k)) for k in _READS]
    saved += [(torch.cuda.Event, "synchronize", torch.cuda.Event.synchronize),
              (torch.cuda, "synchronize", torch.cuda.synchronize)]

    def spy(f, tensor):
        def call(*a, **kw):
            if not tensor or (a and a[0].is_cuda):
                count[0] += 1
            return f(*a, **kw)
        return call

    for owner, name, f in saved:
        setattr(owner, name, spy(f, owner is torch.Tensor))
    try:
        yield count
    finally:
        for owner, name, f in saved:
            setattr(owner, name, f)


@contextlib.contextmanager
def implicit_syncs():
    """Counts, while active, the waits on the card that ATen makes on its
    own (``torch.cuda.set_sync_debug_mode("warn")``: ``item``, a copy to
    the host that waits, ``nonzero``, a boolean mask's index, a stream's
    sync, ...), which ``host_reads`` cannot see; an event's or the device's
    sync that the code asks for is not one of them. Yields a one-element
    list, filled on exit."""
    count = [0]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield count
        finally:
            torch.cuda.set_sync_debug_mode("default")
            count[0] = sum("synchroniz" in str(w.message) for w in caught)


def lane_frame_run(r, seed: int) -> dict:
    """One frame of ``r`` with the counters set to 0 just before and read
    just after: the image's digest, path vertices, rounds, refills,
    launches, the loop's pinned reads (``HOST_READS``), every wait on the
    card that the code asks for (``host_reads``) and every one that ATen
    makes on its own (``implicit_syncs``). The image is read after the
    count."""
    from raytracing_course_2024_tpu_torch.integrator import wavefront as W
    from raytracing_course_2024_tpu_torch.ops import kernels as KN

    torch.cuda.synchronize()
    reset_counts()
    with host_reads() as waits, implicit_syncs() as implicit:
        outs, verts = r.render_frame_device(seed=seed)
    img = torch.cat(list(outs), dim=1).cpu().numpy()
    return {"image_sha": hashlib.sha256(img.tobytes()).hexdigest()[:16], "verts": verts,
            "rounds": r.rounds, "refills": W.REFILLS[0], "launches": dict(KN.LAUNCHES),
            "pinned_reads": W.HOST_READS[0], "waits": waits[0], "implicit": implicit[0]}


# each launch counter of ops/kernels.py:LAUNCHES by the name torch.profiler
# gives its kernel (K1 and K1-final are one kernel)
TRACE_NAMES = {"primary": "primary_kernel", "bounce": "bounce_kernel", "final": "bounce_kernel",
               "persistent": "persistent_kernel", "nearest": "dense_nearest_kernel",
               "bvh": "bvh_nearest_kernel", "sampler": "sampler_kernel",
               "sampler_many": "sampler_many_kernel",
               "shade": "shade_kernel", "finish": "finish_kernel", "refill": "refill_kernel",
               "restart": "restart_kernel", "camera": "camera_kernel",
               "loop": "round_tail_kernel"}


def traced_launches(rows) -> dict:
    """The launches of each hand-written kernel in a profiled frame's device
    rows ((ms, count, name), ``profiled_frame``), by ``TRACE_NAMES``' names,
    and of the IF nodes' ``set_condition_kernel``."""
    out = dict.fromkeys([*sorted(set(TRACE_NAMES.values())), "set_condition_kernel"], 0)
    for _, count, name in rows:
        for kernel in out:
            if kernel in name:
                out[kernel] += count
    return out


def counted_by_name(launches: dict) -> dict:
    """``LAUNCHES`` summed by ``TRACE_NAMES``' kernel names."""
    out = dict.fromkeys(sorted(set(TRACE_NAMES.values())), 0)
    for key, n in launches.items():
        out[TRACE_NAMES[key]] += n
    return out


# profiled frames of one seed over which each kernel's largest traced count
# is held to its launches counted: the card's trace drops a kernel record
# now and then (2 of about 170 profiled lane frames), never adds one
TRACE_TRIES = 3


def launches_ran(r, seed: int) -> tuple:
    """Profiles frames of ``r`` at ``seed`` (``profiled_frame``), the counters
    set to 0 before each, until every hand-written kernel's largest count in
    the traces (``traced_launches``) equals its launches counted
    (``counted_by_name``), at most ``TRACE_TRIES`` frames. Raises where a
    trace holds more launches of a kernel than were counted, or where two
    frames of the seed count differently. Returns (whether they agree, the
    first frame's ``profiled_frame``, the counts, the largest traced counts,
    the frames profiled)."""
    from raytracing_course_2024_tpu_torch.ops import kernels as KN

    first = counted = None
    traced = {}
    for tries in range(1, TRACE_TRIES + 1):
        torch.cuda.synchronize()
        reset_counts()
        p = profiled_frame(r, seed)
        c, t = counted_by_name(KN.LAUNCHES), traced_launches(p["rows"])
        if counted is not None and c != counted:
            raise SystemExit(f"two frames of seed {seed} counted {counted} and {c}")
        if any(t[k] > n for k, n in c.items()):
            raise SystemExit(f"the trace holds more launches {t} than were counted {c}")
        first, counted = first or p, c
        traced = {k: max(traced.get(k, 0), v) for k, v in t.items()}
        if all(traced[k] == n for k, n in counted.items()):
            return True, first, counted, traced, tries
    return False, first, counted, traced, TRACE_TRIES


def traced_main() -> int:
    """``chip_smoke.py --traced``: a fresh process renders each lane frame of
    ``LOOP_FRAMES`` graphed at 1280x720 x 16 spp, after a warm-up frame
    that captures, holds its launches counted to its traces
    (``launches_ran``, seed 9) and prints one JSON line a frame: the frame,
    whether they agree, the counts, the largest traced counts, the frames
    profiled, the rounds and the first profiled frame's device ms. (In the
    long main process the trace of a profiled frame lacked its first
    launches; PERF.md §6 has the runs.)"""
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer
    from raytracing_course_2024_tpu_torch.scene import load_scene

    if not torch.cuda.is_available():
        print("chip_smoke --traced: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    w, h, spp = FRAME
    descs = {"bvh": bvh_desc(w, h, spp), "cornell": load_scene(CORNELL, w, h, spp)}
    for name, (scene, kw) in LOOP_FRAMES.items():
        r = Renderer(descs[scene], device=dev, **kw)
        r.render_frame_device(seed=0)  # captures
        ran, p, counted, traced, tries = launches_ran(r, 9)
        print(json.dumps({"frame": name, "ran": ran, "counted": counted, "traced": traced,
                          "tries": tries, "rounds": r.rounds, "device_ms": p["device_ms"]}),
              flush=True)
        del r
        torch.cuda.empty_cache()
    return 0


def unprofiled_ms(r, seeds) -> list:
    """Host ms of a frame of ``r`` per seed, ending in a device sync."""
    out = []
    for seed in seeds:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs, _ = r.render_frame_device(seed=seed)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def phase_loop(dev, gpu: str) -> dict:
    """The lane frames of ``LOOP_FRAMES`` at 1280x720 x 16 spp, graphed and
    with ``eager=True``, after a warm-up frame each (the graphed one
    captures): equal image (``image_sha``), path vertices, rounds, refills
    and launches; the graphed frame waits on the card at most
    ceil(rounds / ROUNDS_PER_REPLAY) + ``LOOP_READS_EXTRA`` times, every one
    a read of the loop's counters, and ATen makes it wait on its own no time
    (``implicit_syncs``); unprofiled wall ms (3 frames each, in turns),
    device ms of a profiled graphed frame and the idle share, 1 - device /
    unprofiled wall. In the profiled frames every hand-written kernel ran as
    often as ``LAUNCHES`` says (``launches_ran``, in a fresh process,
    ``chip_smoke.py --traced``, which also gives the device ms): the
    launches of a guarded body are added from the device's counts
    (``runtime/graphs.py:settle``), so the trace's own count of each kernel
    is what holds them to the launches that ran. Returns the N5 launches of
    the frames."""
    from raytracing_course_2024_tpu_torch.integrator import wavefront as W
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer
    from raytracing_course_2024_tpu_torch.scene import load_scene

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--traced"],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"the traced process failed ({proc.returncode}):\n{proc.stderr}")
    traced_frames = {d["frame"]: d for d in (json.loads(ln) for ln in proc.stdout.splitlines()
                                             if ln.startswith("{"))}
    w, h, spp = FRAME
    descs = {"bvh": bvh_desc(w, h, spp), "cornell": load_scene(CORNELL, w, h, spp)}
    per = W.ROUNDS_PER_REPLAY
    n5 = 0
    for name, (scene, kw) in LOOP_FRAMES.items():
        rs = {"eager": Renderer(descs[scene], device=dev, eager=True, **kw),
              "graphed": Renderer(descs[scene], device=dev, **kw)}
        for r in rs.values():
            r.render_frame_device(seed=0)  # warm-up; the graphed renderer captures
        e, g = (lane_frame_run(rs[m], 1) for m in ("eager", "graphed"))
        keys = ("image_sha", "verts", "rounds", "refills", "launches")
        same = all(e[k] == g[k] for k in keys)
        most = math.ceil(g["rounds"] / per) + LOOP_READS_EXTRA
        times = {"eager": [], "graphed": []}
        for turn, mode in enumerate(("eager", "graphed", "graphed", "eager", "eager",
                                     "graphed")):
            times[mode] += unprofiled_ms(rs[mode], [2 + turn])
        wall = {m: statistics.median(t) for m, t in times.items()}
        tf = traced_frames[name]
        say("loop", frame=name, rounds=g["rounds"], refills=g["refills"],
            path_vertices=int(g["verts"]), image_sha=g["image_sha"], equal=same,
            reads_graphed=g["pinned_reads"], waits_graphed=g["waits"], reads_most=most,
            implicit_syncs_graphed=g["implicit"], implicit_syncs_eager=e["implicit"],
            reads_eager=e["pinned_reads"], waits_eager=e["waits"],
            wall_ms_graphed=round(wall["graphed"], 3), wall_ms_eager=round(wall["eager"], 3),
            device_ms=round(tf["device_ms"], 3),
            idle_share=round(1.0 - tf["device_ms"] / wall["graphed"], 4),
            frames_ms=json.dumps({k: [round(t, 3) for t in v] for k, v in times.items()})
            .replace(" ", ""), launches=json.dumps({k: v for k, v in g["launches"].items()
                                                    if v}).replace(" ", ""), gpu=f'"{gpu}"')
        if not same:
            raise SystemExit(f"[loop] {name}: the graphed frame differs from the eager one: "
                             f"{ {k: (e[k], g[k]) for k in keys if e[k] != g[k]} }")
        if g["waits"] > most or g["waits"] != g["pinned_reads"] or g["implicit"]:
            raise SystemExit(f"[loop] {name}: {g['waits']} waits on the card "
                             f"({g['pinned_reads']} reads of the loop's counters, "
                             f"{g['implicit']} made by ATen) for {g['rounds']} rounds, "
                             f"more than {most}")
        say("loop", frame=name, profiled_rounds=tf["rounds"], launches_ran=tf["ran"],
            profiled_frames=tf["tries"],
            traced=json.dumps({k: v for k, v in tf["traced"].items() if v}).replace(" ", ""),
            counted=json.dumps({k: v for k, v in tf["counted"].items() if v}).replace(" ", ""))
        if not tf["ran"]:
            raise SystemExit(f"[loop] {name}: the kernels {tf['tries']} profiled frames ran "
                             f"{tf['traced']} differ from the launches counted {tf['counted']}")
        n5 += g["launches"]["loop"]
        del rs
        torch.cuda.empty_cache()
    say("loop", seconds=round(time.perf_counter() - t_phase, 2))
    return n5

def refill_bytes(state, work, counter, total: int) -> float:
    """The bytes one N2a launch must move, counting an output only where it
    changes: every lane's alive flag read; on a dead lane its work item read
    and written, its work id written and its radiance zeroed (a live lane's
    work item and work id stay as they are); where it holds a work item to
    flush, its radiance read and flushed into ``done``; on a taken lane its
    ray, throughput, alive flag and depth written; the counter read and
    written."""
    dead = state[12] < 0.5
    flush = float((dead & (work >= 0)).sum())
    n_dead = float(dead.sum())
    taken = min(n_dead, total - int(counter))
    return state.shape[1] * 4 + n_dead * (8 + 8 + 4 + 12) + flush * (12 + 12) + taken * 44 + 16


def restart_bytes(state, k, kmax) -> float:
    """The bytes one N2b launch must move, counting an output only where it
    changes: every lane's alive flag read; on a dead lane k read, its work
    id written and its radiance zeroed (a live lane's k, work id and slot
    stay as they are; kmax follows from the lane index and is not read);
    where it flushes its radiance read and its slot read and written; on a
    restarted lane k, its ray, throughput, alive flag and depth written.
    ``kmax`` only tells which dead lanes restart."""
    dead = state[12] < 0.5
    flush = float((dead & (k > 0)).sum())
    taken = float((dead & (k < kmax)).sum())
    return (state.shape[1] * 4 + float(dead.sum()) * (8 + 4 + 12) + flush * (12 + 24)
            + taken * (8 + 44))


def lane_kernel_case(kind: str, tag: str, snap: tuple, gpu: str, timed: bool) -> dict:
    """N2a (``kind`` "refill") or N2b ("restart") against its plain version on
    one snapshot: every output equal bit for bit on every lane (``done``'s
    columns of the work items). ``timed``: ms per launch in place, the
    snapshot put back before each launch outside the event pair
    (``cuda_ms_in_place``), the plain version once, and the bound."""
    from raytracing_course_2024_tpu_torch.ops import refill as RF

    rnd, bufs, args = snap
    frame = args[2]
    total = frame.n_pix * frame.samples
    scan = RF.refill_scan(bufs[0].shape[1], bufs[0].device) if kind == "refill" else None
    kernel = (lambda t: RF.refill(*t, *args, scan)) if kind == "refill" else (
        lambda t: RF.restart(*t, *args))
    plain_fn = RF.refill_plain if kind == "refill" else RF.restart_plain
    kern, plain = [x.clone() for x in bufs], [x.clone() for x in bufs]
    kernel(kern)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    plain_fn(*plain, *args)
    end.record()
    torch.cuda.synchronize()
    if kind == "refill":  # the drop columns are written by the plain version only
        kern[3], plain[3] = kern[3][:, :total], plain[3][:, :total]
    names = (("state", "work", "counter", "done", "depth", "wid") if kind == "refill"
             else ("state", "k", "kmax", "depth", "wid", "acc"))
    equal = {n: bit_equal(a, b) for n, a, b in zip(names, kern, plain)}
    state = bufs[0]
    dead = float((state[12] < 0.5).sum())
    res = dict(round=rnd, lanes=state.shape[1], dead=int(dead),
               **({"counter": int(bufs[2]), "total": total, "taken": int(plain[2]) - int(bufs[2])}
                  if kind == "refill" else
                  {"jmax": bufs[5].shape[1] // state.shape[1],
                   "restarted": int((plain[1] != bufs[1]).sum())}),
               **{f"{n}_equal": v for n, v in equal.items()})
    check(res, f"{tag}:{kind}-exact", all(equal.values()))
    if not timed:
        return {}
    work = [x.clone() for x in bufs]
    # the flush writes the same columns every launch: ``done`` is not put back
    back = [(x, y) for i, (x, y) in enumerate(zip(work, bufs)) if kind != "refill" or i != 3]

    def restore():
        for x, y in back:
            x.copy_(y)

    ms = cuda_ms_in_place(lambda: kernel(work), restore, ROUND_REPS)
    nbytes = (refill_bytes(state, bufs[1], bufs[2], total) if kind == "refill"
              else restart_bytes(state, bufs[1], bufs[2]))
    b = bound(nbytes, 0.0)
    say("timing", kernel=kind, state=tag, lanes=state.shape[1],
        active_in=round(dead / state.shape[1], 4), ms=round(ms, 4),
        plain_ms=round(start.elapsed_time(end), 3), bound_ms=round(b[0], 5), bound_by=b[1],
        share=round(b[0] / ms, 4), gpu=f'"{gpu}"')
    return dict(ms=ms, plain_ms=start.elapsed_time(end), bound=b,
                active_in=dead / state.shape[1], lanes=state.shape[1])


# lanes at a time of K3's plain version above 32 lights: its (B, L) sweep
# holds several (lanes, lights) floats at once, too many at 1,048,576 lanes
PLAIN_CHUNK = 32_768


def sampler_plain_lanes(scene, seed, wid, off, depth, ins, chunk=None) -> tuple:
    """``sampler_plain`` in the lane layout (a counter base per lane from
    ``depth``) on ``chunk`` lanes at a time, or all at once: (l, pdf, ok)."""
    from raytracing_course_2024_tpu_torch.ops import rng
    from raytracing_course_2024_tpu_torch.ops.sampler import sampler_plain
    from raytracing_course_2024_tpu_torch.ops.vec import Vec3

    n = wid.shape[0]
    step = chunk or n
    parts = []
    for a in range(0, n, step):
        cut = [Vec3(*(c[a:a + step] for c in x)) if isinstance(x, Vec3)
               else x[a:a + step] if isinstance(x, torch.Tensor) else x for x in ins]
        parts.append(sampler_plain(scene, seed, wid[a:a + step], off,
                                   rng.lane_ctr(depth[a:a + step], K), *cut))
    if len(parts) == 1:
        return parts[0]
    l = Vec3(*(torch.cat([getattr(p[0], c) for p in parts]) for c in "xyz"))
    return l, torch.cat([p[1] for p in parts]), torch.cat([p[2] for p in parts])


# ``--many --parent TREE``: K3 above 32 lights of the checkout at TREE
# (``parent_sampler_many``), held against this tree's on the same states
PARENT_MANY: dict = {}


def parent_sampler_many(tree: str):
    """K3 above 32 lights of another checkout at ``tree`` whose
    ``rt_launch_sampler_many`` takes its warps' ticket pair before the
    stream (its persistent schedule), built alone from its
    ``csrc/sampler.cu`` with this tree's nvcc flags into its git-ignored
    build directory; it gets a ticket pair of its own. Returns a function
    of ``sample_mixture_kernel``'s arguments in lane mode that launches it
    and returns (l, pdf, ok)."""
    import ctypes

    from raytracing_course_2024_tpu_torch.ops import kernels
    from raytracing_course_2024_tpu_torch.ops.rng import WF_STRIDE, seed_off
    from raytracing_course_2024_tpu_torch.ops.vec import Vec3

    pkg = os.path.join(tree, "raytracing_course_2024_tpu_torch")
    os.makedirs(os.path.join(pkg, "build"), exist_ok=True)
    so = os.path.join(pkg, "build", "parent_sampler_many.so")
    t0 = time.perf_counter()
    res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", so,
                          os.path.join(pkg, "csrc", "sampler.cu")], capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed on {tree}'s sampler.cu:\n{res.stdout}{res.stderr}")
    regs = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
            if "registers" in ln or "spill" in ln]
    say("build", parent=tree, seconds=round(time.perf_counter() - t0, 2), ptxas=len(regs))
    for ln in regs:
        print(f"[build] parent {ln}", flush=True)
    lib = ctypes.CDLL(so)
    p, i, u, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong
    lib.rt_launch_sampler_many.argtypes = [p, p, p, p, u, u, u, u, p, u, p, p, i, p, i, i, i,
                                           ll, p, p, p, p]
    lib.rt_launch_sampler_many.restype = i
    tickets = {}  # device -> the parent's pair, zero between launches

    def launch(scene, seed, wid, off, ctr, point, n_geom, n_shade, v, rough, need, max_tries,
               depth):
        dev = point.x.device
        b = point.x.shape[0]
        ins = (*point, *n_geom, *n_shade, *v, rough)
        pair = seed_off(seed, off, dev)
        out = torch.empty((4, b), dtype=torch.float32, device=dev)
        ok = torch.empty((b,), dtype=torch.bool, device=dev)
        tick = tickets.setdefault(dev, torch.zeros((2,), dtype=torch.int32, device=dev))
        rc = lib.rt_launch_sampler_many(
            kernels._ptrs(ins), need.data_ptr(), wid.data_ptr(), pair.data_ptr(),
            *kernels._ctr(ctr), depth.data_ptr(), WF_STRIDE, scene.light_rec.data_ptr(),
            scene.light_leaf.data_ptr(), scene.light_rec.shape[0],
            scene.light_nodes.data_ptr(), scene.light_nodes.shape[0], int(scene.light_stack),
            int(max_tries), b, out.data_ptr(), ok.data_ptr(), tick.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the parent's rt_launch_sampler_many failed: CUDA error {rc}")
        return Vec3(out[0], out[1], out[2]), out[3], ok

    return launch


def lane_sampler_case(tag: str, snap: tuple, scene, cfg, gpu: str, timed: bool) -> tuple:
    """K3 in lane mode against ``sampler_plain`` in the lane layout on the
    sampler inputs of one bounce of the counter wavefront (its nearest hit
    and N1a in the lane layout on the snapshot): ``ok`` equal on every lane,
    l and pdf at K3's gate. Above 32 lights the plain version runs
    ``PLAIN_CHUNK`` lanes at a time. ``timed``: ms per launch
    (``cuda_ms_each``), the plain version's ms and the bound. Returns
    ((largest absolute, largest relative error on the lanes both accept),
    timing dict or {})."""
    from raytracing_course_2024_tpu_torch.ops import rng
    from raytracing_course_2024_tpu_torch.ops.sampler import sample_mixture_kernel
    from raytracing_course_2024_tpu_torch.ops.sampling import UNROLL_MAX_LIGHTS
    from raytracing_course_2024_tpu_torch.ops.shade import sampler_inputs, shade
    from raytracing_course_2024_tpu_torch.ops.traverse import nearest_table
    from raytracing_course_2024_tpu_torch.ops.vec import Vec3

    rnd, (st, wid, depth), (seed_off,) = snap
    many = scene.statics.num_lights > UNROLL_MAX_LIGHTS
    live = st[12] > 0.5
    t, idx = nearest_table(Vec3(st[0], st[1], st[2]), Vec3(st[3], st[4], st[5]), scene,
                           live=live)
    _, surf, need = shade(st.clone(), t, idx, scene, cfg.bg_color, depth=depth,
                          last=cfg.ray_depth - 1)
    ins = (*sampler_inputs(surf), need, K)
    seed, off = seed_off[0], seed_off[1]

    def kernel():
        return sample_mixture_kernel(scene, seed, wid, off, rng.lane_ctr(0, K), *ins, depth)

    parent = PARENT_MANY.get("launch") if many else None

    def parent_kernel():
        return parent(scene, seed, wid, off, rng.lane_ctr(0, K), *ins, depth)

    lk, pk, okk = kernel()
    if parent is not None:  # this tree's K3 against the parent's, bit for bit
        lq, pq, okq = parent_kernel()
        torch.cuda.synchronize()
        same = {c: bool(torch.equal(a, b)) for c, a, b in
                zip(("l_x", "l_y", "l_z", "pdf", "ok"), (*lk, pk, okk), (*lq, pq, okq))}
        differ = int(((lk.x != lq.x) | (lk.y != lq.y) | (lk.z != lq.z) | (pk != pq)
                      | (okk != okq)).sum())
        say("kernels", case=f"{tag}:sampler-many-vs-parent", round=rnd, lanes=st.shape[1],
            bit_equal=all(same.values()), lanes_differing=differ,
            **{f"{c}_equal": v for c, v in same.items()})
        PARENT_MANY.setdefault("bit_equal", []).append(all(same.values()))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    lp_, pp, okp = sampler_plain_lanes(scene, seed, wid, off, depth, ins,
                                       PLAIN_CHUNK if many else None)
    end.record()
    torch.cuda.synchronize()
    res = compare_rows([*lk, pk], [*lp_, pp], okk, okp, f"{tag}:sampler-lane")
    both = okk & okp
    rel = max((float(((a[both] - b[both]).abs() / b[both].abs().clamp(min=1e-30)).max())
               if bool(both.any()) else 0.0) for a, b in zip([*lk, pk], [*lp_, pp]))
    exact = dict(round=rnd, ok_equal=bool(torch.equal(okk, okp)),
                 need_frac=round(float(need.float().mean()), 4), max_rel_err=rel,
                 bit_share=round(bit_share([*lk, pk], [*lp_, pp], okp), 6))
    check(exact, f"{tag}:sampler-lane-exact", exact["ok_equal"])
    if not timed:
        return (res["max_abs_err"], rel), {}
    ms = cuda_ms_each(kernel, ROUND_REPS)
    parent_ms = cuda_ms_each(parent_kernel, ROUND_REPS) if parent is not None else None
    n, n_need = st.shape[1], float(need.sum())
    tables = ((scene.light_rec, scene.light_leaf, scene.light_nodes) if many
              else (scene.light_packed, scene.lspec))
    ltable = sum(x.numel() for x in tables) * 4
    key = rng.work_key(seed, wid)
    ops = mixture_ops(scene, *sampler_inputs(surf), need, key, rng.lane_ctr(depth, K))
    b = bound(n * (1 + 16 + 1) + n_need * (52 + 4 + 4) + ltable, ops)
    say("timing", kernel="sampler_many-lane" if many else "sampler-lane", state=tag, lanes=n,
        active_in=round(n_need / n, 4), ms=round(ms, 4),
        **({} if parent_ms is None else {"parent_ms": round(parent_ms, 4)}),
        plain_ms=round(start.elapsed_time(end), 3), bound_ms=round(b[0], 5), bound_by=b[1],
        share=round(b[0] / ms, 4), gpu=f'"{gpu}"')
    return (res["max_abs_err"], rel), dict(ms=ms, plain_ms=start.elapsed_time(end), bound=b,
                                           active_in=n_need / n, lanes=n)


def phase_kernels_round(dev, gpu: str) -> tuple:
    """The lane round's kernels on the BVH scene at 1280x720 x 16 spp, on
    the lane engines' 1,048,576 lanes: N2a on the counter wavefront's
    refills at rounds >= 1, >= 10 and its last (the work's tail: the counter
    near the total, dead lanes that take nothing), N2b on the sticky
    engine's rounds >= 1, >= 10 and its last, and on a 262,144-lane sticky
    state whose lanes own 4 pixels (jmax > 1), each equal to its plain
    version bit for bit on every lane; K3 in lane mode on the bounces of the
    same rounds at K3's gate with ``ok`` exact. Times per launch on the
    round-10 states. Returns (largest errors, timing by kernel)."""
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer

    t0 = time.perf_counter()
    w, h, spp = FRAME
    r = Renderer(bvh_desc(w, h, spp), device=dev, eager=True)
    snaps = lane_snapshots(r, STICKY_JMAX_LANES)
    if "tail" not in snaps["refill"]:
        raise SystemExit("the counter wavefront had no refill at the work's tail")
    errs = {"refill": 0.0, "restart": 0.0, "sampler": 0.0}
    rel = 0.0
    timing = {}
    for kind in ("refill", "restart"):
        for name, snap in snaps[kind].items():
            got = lane_kernel_case(kind, f"bvh81920-{name}", snap, gpu, name == ROUND_TIMED)
            if got:
                timing[kind] = got
    for name, snap in snaps["core"].items():
        (err, err_rel), got = lane_sampler_case(f"bvh81920-{name}", snap, r.scene, r.cfg,
                                                gpu, name == ROUND_TIMED)
        errs["sampler"] = max(errs["sampler"], err)
        rel = max(rel, err_rel)
        if got:
            timing["sampler-lane"] = got
    timing["sampler-lane"]["max_rel_err"] = rel
    say("kernels", stage="round", seconds=round(time.perf_counter() - t0, 2))
    del snaps
    torch.cuda.empty_cache()
    return errs, timing


def many_desc(w: int, h: int, spp: int):
    """The course's practice6_1 scene (16,910 triangles, 1,164 of them
    lights) as the benchmark builds it (``rtbench/configs/practice6_1.json``)."""
    from rtbench import scenes
    from rtbench.program import scene_desc

    configs = os.path.join(ROOT, "rtbench", "configs")
    with open(os.path.join(configs, "practice6_1.json")) as f:
        conf = json.load(f)
    return scene_desc(scenes.build(conf["scene"], configs, w, h), spp)


def phase_kernels_many(dev, gpu: str) -> tuple:
    """K3 above 32 lights on practice6_1 at 1280x720 x 16 spp, the counter
    wavefront's 1,048,576 lanes: at its bounces of rounds >= 1, >= 10 and
    its last (``lane_snapshots``; its sticky frame runs K3's walk too)
    against the plain version at K3's gate, ``ok`` exact; then one graphed
    frame on the scene's default route (BVH backend, counter wavefront),
    whose launches must be the rounds' and refills' (``expected_launches``:
    K3's as ``sampler_many``, none as ``sampler``). Returns (largest
    absolute error, the round-10 timing with the largest relative error and
    the frame's ``sampler_many`` launches)."""
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer

    t0 = time.perf_counter()
    w, h, spp = FRAME
    desc = many_desc(w, h, spp)
    r = Renderer(desc, device=dev, eager=True)
    if r.backend != "bvh" or k3_key(r) != "sampler_many":
        raise SystemExit(f"practice6_1 took the {r.backend} backend with {k3_key(r)}")
    snaps = lane_snapshots(r)
    err, rel, timing = 0.0, 0.0, {}
    for name, snap in snaps["core"].items():
        (e, e_rel), got = lane_sampler_case(f"practice6_1-{name}", snap, r.scene, r.cfg, gpu,
                                            name == ROUND_TIMED)
        err, rel = max(err, e), max(rel, e_rel)
        timing = got or timing
    del snaps, r
    torch.cuda.empty_cache()
    r = Renderer(desc, device=dev)
    r.render_frame_device(seed=0)  # captures
    run = lane_frame_run(r, 1)
    want = expected_launches(r, w * h, spp, 1, run["rounds"], run["refills"])
    say("kernels", stage="many-lights-frame", engine=r.engine, rounds=run["rounds"],
        refills=run["refills"], launches=json.dumps(run["launches"]).replace(" ", ""))
    if r.engine != "wavefront" or run["launches"] != want:
        raise SystemExit(f"practice6_1 frame on {r.engine}: launched {run['launches']}, "
                         f"expected {want}")
    timing.update(max_rel_err=rel, launches=run["launches"]["sampler_many"])
    del r
    torch.cuda.empty_cache()
    say("kernels", stage="many", seconds=round(time.perf_counter() - t0, 2))
    return err, timing


def many_geometry() -> dict:
    """K3 above 32 lights' launch geometry (``ops/kernels.py:launch_geometry``):
    stack entries in all and in shared memory per thread, staged nodes,
    shared and local bytes, registers, resident blocks per SM."""
    from raytracing_course_2024_tpu_torch.ops import kernels

    geom = kernels.launch_geometry()
    return {**{k: v for k, v in geom.items() if k.startswith("sampler_many_")},
            "sampler_many_resident_blocks": geom["resident_blocks"]["sampler_many"]}


def many_main() -> int:
    """``--many``: the build and ``phase_kernels_many`` alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    from raytracing_course_2024_tpu_torch.ops import kernels

    kernels.library()
    say("build", seconds=round(kernels.BUILD_INFO["seconds"], 2))
    gpu = gpu_line()
    if sys.argv[2:3] == ["--parent"]:
        PARENT_MANY["launch"] = parent_sampler_many(sys.argv[3])
    err, timing = phase_kernels_many(torch.device("cuda", 0), gpu)
    say("timing", kernel="sampler_many", max_abs_err=err,
        **{k: (list(v) if isinstance(v, tuple) else v) for k, v in timing.items()},
        **many_geometry())
    if "bit_equal" in PARENT_MANY:
        say("kernels", case="practice6_1:sampler-many-vs-parent",
            states=len(PARENT_MANY["bit_equal"]), bit_equal=all(PARENT_MANY["bit_equal"]))
    print(gpu, flush=True)
    return 0


def bvh_state(r, n: int, plain: bool) -> dict:
    """``n`` lanes of the Renderer ``r``'s frame (BVH backend), pixels spread
    evenly over the frame: the camera rays of sample 0, and the rays and live
    mask of bounce 1 after one modular bounce (K6, N1a, K3 and N1b, or with
    ``plain`` their plain versions)."""
    from raytracing_course_2024_tpu_torch.integrator import path as P
    from raytracing_course_2024_tpu_torch.ops.camera import camera_state_plain
    from raytracing_course_2024_tpu_torch.ops.vec import Vec3

    w, h = r.settings.width, r.settings.height
    pix = (torch.arange(n, device=r.device, dtype=torch.int64) * (w * h)) // n
    wid = pix.to(torch.int32)
    st = camera_state_plain(SEED, wid, 0, (pix % w).float(), (pix // w).float(), r.cam, w, h)
    ro, rd = Vec3(st[0], st[1], st[2]), Vec3(st[3], st[4], st[5])
    ro1, rd1, alive1 = modular_steps(P, st.clone(), r.scene, SEED, wid, plain)(r.cfg, 0)
    return {"camera": (ro, rd, ro.x < math.inf), "bounce1": (ro1, rd1, alive1)}


def bvh_case(what: str, ro, rd, scene, live, plain_hit, exact_rows: bool = False) -> float:
    """K6 against its plain version on one set of rays, with or without a
    live mask. ``plain_hit`` is the plain version's unmasked (t, row) on
    these rays (the sweep; its masked answer is the miss on masked lanes).
    ``t`` and the hit/miss flag must be equal on every lane; the row may
    differ only where the two rows give the same t (a tie), on under 0.1 %
    of the lanes (with ``exact_rows`` on none); masked lanes must be exactly
    (inf, 0). Returns the largest absolute error of t."""
    from raytracing_course_2024_tpu_torch.ops.scene_intersect import _prim_ts, prim_ref_from_table
    from raytracing_course_2024_tpu_torch.ops.traverse import bvh_nearest
    from raytracing_course_2024_tpu_torch.ops.vec import Vec3

    tk, ik = bvh_nearest(ro, rd, scene, live=live)
    tp, ip = plain_hit
    if live is not None:
        tp, ip = torch.where(live, tp, float("inf")), torch.where(live, ip, 0)
    torch.cuda.synchronize()
    n = tk.shape[0]
    res = compare_rows([tk], [tp], torch.isfinite(tk), torch.isfinite(tp), what)
    differ = torch.nonzero(ik != ip).squeeze(1)
    # a row that differs must be a tie: the kernel's row gives the same t
    t_k_row = _prim_ts(Vec3(*(c[differ] for c in ro)), Vec3(*(c[differ] for c in rd)),
                       prim_ref_from_table(scene.packed, ik[differ].long()), scene.statics, 0.0)
    off = torch.zeros_like(ik, dtype=torch.bool) if live is None else ~live
    exact = dict(t_equal=bool(torch.equal(tk, tp)),
                 valid_equal=bool(torch.equal(torch.isfinite(tk), torch.isfinite(tp))),
                 ties=int(differ.numel()), not_ties=int((t_k_row != tp[differ]).sum()),
                 masked_are_misses=bool(torch.isinf(tk[off]).all() and (ik[off] == 0).all()),
                 live_frac=round(1.0 - off.float().mean().item(), 4), lanes=n)
    check(exact, what + "-exact", exact["t_equal"] and exact["valid_equal"]
          and exact["not_ties"] == 0 and exact["ties"] < (1.0 - LANE_FRAC) * n
          and (exact["ties"] == 0 or not exact_rows) and exact["masked_are_misses"])
    return res["max_abs_err"]


def soup_desc(gen: np.random.Generator, n: int):
    """``n`` primitives with mixed shapes in [-6, 6]^3: rotated boxes,
    rotated ellipsoids and triangles in turn (the BVH's mixed-shape leaves,
    as tests/test_bvh.py:test_bvh_mixed_shapes)."""
    from raytracing_course_2024_tpu_torch.scene.types import (
        BOX, ELLIPSOID, TRI, CameraDesc, PrimitiveDesc, RenderSettings, SceneDesc)

    prims = []
    for i in range(n):
        pos = gen.uniform(-6, 6, 3)
        if i % 3 == 2:
            prims.append(PrimitiveDesc(ptype=TRI, p0=pos, p1=pos + gen.normal(0, 0.6, 3),
                                       p2=pos + gen.normal(0, 0.6, 3), color=np.ones(3)))
            continue
        q = gen.normal(size=4)
        prims.append(PrimitiveDesc(ptype=(BOX, ELLIPSOID)[i % 3], p0=gen.uniform(0.2, 1.0, 3),
                                   position=pos, rotation=q / np.linalg.norm(q),
                                   color=np.ones(3)))
    cam = CameraDesc(position=np.zeros(3), right=np.array([1.0, 0, 0]),
                     up=np.array([0, 1.0, 0]), forward=np.array([0, 0, -1.0]), fov_x=1.0,
                     fov_y=1.0)
    return SceneDesc(settings=RenderSettings(width=8, height=8, samples=1, ray_depth=2,
                                             bg_color=(0.0, 0.0, 0.0), camera=cam),
                     primitives=prims, planes=[])


BVH_RAYS = 65_536  # K6 against the sweep: lanes per case


def phase_kernels_bvh(dev) -> float:
    """K6 against its plain version (the sweep over the whole table) on the
    81,920-triangle BVH scene: camera rays and bounce-1 rays (after one
    plain modular bounce) of 65,536 pixels spread over the 1280x720 frame,
    with and without the live mask; a lane count that is no multiple of the
    tile, whole dead warps and tiles, every lane masked; axis-parallel rays
    (directions along the axes, origins on the wide nodes' box planes: an
    infinite ``inv`` and NaN slabs); a 600-primitive soup of rotated boxes,
    rotated ellipsoids and triangles on random rays; and the 5,120-triangle
    BVH scene with every primitive twice, where the lower row of each pair
    must win on every lane. Returns the largest absolute error of t."""
    from raytracing_course_2024_tpu_torch.ops.traverse import bvh_nearest_plain
    from raytracing_course_2024_tpu_torch.ops.vec import Vec3
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer

    w, h, spp = FRAME
    r = Renderer(bvh_desc(w, h, spp), device=dev)
    if r.backend != "bvh":
        raise SystemExit("the BVH scene did not take the BVH backend")
    from raytracing_course_2024_tpu_torch.ops import kernels
    from raytracing_course_2024_tpu_torch.ops.bvh import tree_depth

    geom = kernels.launch_geometry()
    say("kernels", bvh_scene=f"{len(r.desc.primitives)}-primitives",
        binary_nodes=r.arrays.bvh.node_left.shape[0], depth=tree_depth(r.arrays.bvh),
        wide_nodes=r.scene.bvh_nodes.shape[0], stack_needed=r.scene.bvh_stack,
        builder=r.bvh_builder, **{k: v for k, v in geom.items() if k.startswith("bvh_")},
        resident_blocks=geom["resident_blocks"]["bvh"])
    n, err = BVH_RAYS, 0.0
    state = bvh_state(r, n, plain=True)
    for name, (ro, rd, alive) in state.items():
        t0 = time.perf_counter()
        plain = bvh_nearest_plain(ro, rd, r.scene)
        torch.cuda.synchronize()
        say("kernels", bvh_plain=name, lanes=n, seconds=round(time.perf_counter() - t0, 3))
        for mask, live in (("", None), ("-masked", alive)):
            err = max(err, bvh_case(f"bvh81920-{n}:{name}{mask}", ro, rd, r.scene, live, plain))
        if name != "bounce1":
            continue
        k = n - 77  # ragged: no multiple of the tile
        cut = Vec3(*(c[:k].contiguous() for c in ro)), Vec3(*(c[:k].contiguous() for c in rd))
        bvh_case(f"bvh81920-{k}-lanes-ragged:{name}-masked", *cut, r.scene,
                 alive[:k].contiguous(), tuple(x[:k] for x in plain))
        for pattern, keep in tile_patterns(n, dev).items():
            bvh_case(f"bvh81920-{n}-lanes-{pattern}:{name}-masked", ro, rd, r.scene,
                     alive & keep, plain)
    gen = np.random.default_rng(SEED)
    ro, rd = axis_rays(gen, r.scene, n, dev)
    plain = bvh_nearest_plain(ro, rd, r.scene)
    err = max(err, bvh_case(f"bvh81920-{n}:axis-parallel", ro, rd, r.scene, None, plain))
    soup = Renderer(soup_desc(gen, 600), device=dev, backend="bvh")
    o = torch.from_numpy(gen.uniform(-7, 7, (n, 3)).astype(np.float32)).to(dev)
    d = torch.from_numpy(gen.normal(size=(n, 3)).astype(np.float32)).to(dev)
    d = d / d.norm(dim=1, keepdim=True)
    ro, rd = Vec3(*o.T.contiguous()), Vec3(*d.T.contiguous())
    plain = bvh_nearest_plain(ro, rd, soup.scene)
    live = torch.from_numpy(gen.uniform(size=n) < 0.7).to(dev)
    for mask, lv in (("", None), ("-masked", live)):
        err = max(err, bvh_case(f"soup600-{n}:random{mask}", ro, rd, soup.scene, lv, plain))
    small = bvh_desc(*FRAME, subdiv=4)
    twice = Renderer(dataclasses.replace(small, primitives=small.primitives * 2), device=dev)
    o = torch.from_numpy(gen.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)).to(dev)
    d = torch.from_numpy(gen.normal(size=(n, 3)).astype(np.float32)).to(dev)
    d = d / d.norm(dim=1, keepdim=True)
    ro, rd = Vec3(*o.T.contiguous()), Vec3(*d.T.contiguous())
    plain = bvh_nearest_plain(ro, rd, twice.scene)
    err = max(err, bvh_case(f"bvh{len(twice.desc.primitives)}-duplicates-{n}:random", ro, rd,
                            twice.scene, None, plain, exact_rows=True))
    return err


def axis_rays(gen: np.random.Generator, scene, n: int, dev):
    """``n`` rays along the axes (+-1, some with a -0 component; a sixth
    of them along two axes) from origins in the scene's box, half of whose
    coordinates lie on a plane of one of the wide nodes' child boxes: the
    slab products there are 0 * inf = NaN."""
    from raytracing_course_2024_tpu_torch.ops.vec import Vec3

    nodes = scene.bvh_nodes.cpu().numpy()
    used = ((nodes[:, 24:28].view(np.int32) >= 0) | (nodes[:, 28:32].view(np.int32) > 0)).ravel()
    box_lo = nodes[:, 0:12].reshape(-1, 3, 4).transpose(0, 2, 1).reshape(-1, 3)
    box_hi = nodes[:, 12:24].reshape(-1, 3, 4).transpose(0, 2, 1).reshape(-1, 3)
    planes = np.concatenate([box_lo[used], box_hi[used]])  # empty slots' boxes lie at +inf
    axis = gen.integers(0, 3, n)
    d = np.zeros((n, 3), np.float32)
    d[np.arange(n), axis] = gen.choice([-1.0, 1.0], n)
    neg = np.arange(n // 3, n)[::2]  # a negative zero in another component
    d[neg, (axis[neg] + 2) % 3] = -0.0
    two = np.arange(n // 6)
    d[two, (axis[two] + 1) % 3] = 0.6
    d = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-30)
    lo, hi = planes.min(0), planes.max(0)
    o = gen.uniform(lo, hi, (n, 3))
    on = gen.uniform(size=(n, 3)) < 0.5
    o = np.where(on, planes[gen.integers(0, planes.shape[0], n)], o).astype(np.float32)
    d = d.astype(np.float32)
    return (Vec3(*torch.from_numpy(o.T.copy()).to(dev)),
            Vec3(*torch.from_numpy(d.T.copy()).to(dev)))


class LogLines(logging.Handler):
    """Collects the messages of the port's logger (the CLI's render line)."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


# the main path's runs and their CLI environment; the lane engines launch
# one kernel once per round. "bvh" renders the 81,920-triangle BVH scene
# (written as a text scene) on the BVH backend's default engine, the counter
# wavefront; "bvh-batch" on the batch engine (K6 and N4 through the CLI).
MAIN = {"fused": {}, "modular": {"RT_RR": "1"}, "sticky": {"RT_ENGINE": "sticky"},
        "wavefront": {"RT_ENGINE": "wavefront"}, "bvh": {}, "bvh-batch": {"RT_ENGINE": "batch"},
        "bvh-wavefront": {"RT_ENGINE": "wavefront"}, "bvh-sticky": {"RT_ENGINE": "sticky"}}
BVH_DEFAULT_ENGINE = "wavefront"  # the JAX Renderer's choice for its BVH backend
ROUND_KERNEL = {"sticky": "persistent", "wavefront": "bounce"}


@contextlib.contextmanager
def lane_spy(on_refill=None, on_core=None, on_sticky=None):
    """While active, calls ``on_refill(refill, round)`` before a refill of
    the counter wavefront, ``on_core(core, round)`` before its bounce and
    ``on_sticky(body, round)`` before a sticky round off the K5 route (the
    bodies as they stand, before the call; ``round`` counts the body's
    bounces before it). For eager frames: a graph's replays run no Python."""
    from raytracing_course_2024_tpu_torch.integrator import wavefront as W

    calls = {cls: cls.__call__ for cls in (W.RefillBody, W.CoreBody, W.StickyBody)}

    def rnd(body):
        return getattr(body, "spied_rounds", 0)

    def refill_call(b):
        if on_refill:
            on_refill(b, rnd(b.core))
        calls[W.RefillBody](b)

    def core_call(c):
        if on_core:
            on_core(c, rnd(c))
        calls[W.CoreBody](c)
        c.spied_rounds = rnd(c) + 1

    def sticky_call(b):
        if on_sticky:
            on_sticky(b, rnd(b))
        calls[W.StickyBody](b)
        b.spied_rounds = rnd(b) + 1

    W.RefillBody.__call__, W.CoreBody.__call__ = refill_call, core_call
    W.StickyBody.__call__ = sticky_call
    try:
        yield
    finally:
        for cls, f in calls.items():
            cls.__call__ = f


def reset_counts() -> None:
    """The launch counters, the counter wavefront's count of its refills
    and the lane loops' host reads (``integrator/wavefront.py:REFILLS``,
    ``HOST_READS``) set to 0."""
    from raytracing_course_2024_tpu_torch.integrator import wavefront as W
    from raytracing_course_2024_tpu_torch.ops import kernels as KN

    KN.reset_launches()
    W.REFILLS[0] = W.HOST_READS[0] = 0


def refills_run() -> int:
    """The refills the counter wavefront ran since ``reset_counts``."""
    from raytracing_course_2024_tpu_torch.integrator import wavefront as W

    return W.REFILLS[0]


def phase_main(dev, tmp: str, path: str) -> dict:
    """The CLI on the Cornell frame (the "bvh" runs: on the BVH scene) with
    the launch counters set to 0 just before and read just after; they must
    match the path exactly. The batch engine's modular runs launch N4 once
    per sample. The lane engines' expected counts are the rounds
    the engine reports: one K5 (sticky) or one K1 in lane mode (counter
    wavefront) per round on the Cornell frame, the nearest hit (K6), N1a, K3
    in lane mode and N1b per round on the BVH frame; one N2a per refill (the
    engine's count, from the device), one N2b per round of the BVH sticky
    frame and one for its final flush; N5 once per round and, off the K5
    route, once before the first. The "bvh" run must name the counter
    wavefront."""
    from raytracing_course_2024_tpu_torch.ops import kernels as KN
    from raytracing_course_2024_tpu_torch.runtime import cli
    from raytracing_course_2024_tpu_torch.runtime.image_io import read_png, read_ppm

    (w, h, spp), depth, scene = FRAME, 6, CORNELL  # glTF ray_depth is 6
    bvh = path.startswith("bvh")
    if bvh:
        desc = bvh_desc(w, h, spp)
        depth, scene = desc.settings.ray_depth, os.path.join(tmp, "bvh81920.txt")
        with open(scene, "w") as f:
            f.write(scene_text(desc))
    env = MAIN[path]
    ppm, png = os.path.join(tmp, f"{path}.ppm"), os.path.join(tmp, path)
    logged = LogLines()
    logging.getLogger("rt_torch").addHandler(logged)
    os.environ.update(env)
    try:
        reset_counts()
        t0 = time.perf_counter()
        rc = cli.main([scene, str(w), str(h), str(spp), ppm, png])
        secs = time.perf_counter() - t0
        counts, refills = dict(KN.LAUNCHES), refills_run()
    finally:
        for k in env:
            os.environ.pop(k)
        logging.getLogger("rt_torch").removeHandler(logged)
    if rc != 0:
        raise SystemExit(f"CLI returned {rc}")
    line = [ln for ln in logged.lines if "engine=" in ln]
    if len(line) != 1:
        raise SystemExit(f"{path}: no render line in the log {logged.lines}")
    engine = re.search(r"engine=(\w+)", line[0]).group(1)
    backend = re.search(r"backend=(\w+)", line[0]).group(1)
    if backend != ("bvh" if bvh else "dense"):
        raise SystemExit(f"{path}: rendered on the {backend} backend: {line[0]}")
    want = dict.fromkeys(KN.LAUNCHES, 0)
    extra = {"engine": engine}
    if bvh:
        extra["bvh_builder"] = re.search(r"bvh_builder=(\w+)", line[0]).group(1)
    if path == "bvh" and engine != BVH_DEFAULT_ENGINE:
        raise SystemExit(f"bvh: the default engine is {engine}, not {BVH_DEFAULT_ENGINE}")
    # the modular bounce: N4 once, the nearest hit and N1a at every level, K3
    # and N1b at every level but the last
    modular = dict(sampler=spp * (depth - 1), shade=spp * depth, finish=spp * (depth - 1),
                   camera=spp)
    if path == "modular":  # K4
        want.update(nearest=spp * depth, **modular)
    elif path == "fused":  # 921,600 lanes fit one batch (DEFAULT_BATCH)
        want.update(primary=spp, bounce=spp * (depth - 2), final=spp)
    elif engine == "batch":  # bvh: K6
        want.update(bvh=spp * depth, **modular)
    else:
        found = re.findall(r"rounds=(\d+)", line[0])
        if len(found) != 1:
            raise SystemExit(f"{path}: no round count in the log {logged.lines}")
        rounds = int(found[0])
        # a sticky lane walks spp paths of at most `depth` rounds each
        low, high = (spp, spp * depth) if engine == "sticky" else (1, None)
        if rounds < low or (high and rounds > high):
            raise SystemExit(f"{path} rounds {rounds} outside [{low}, {high}]")
        if bvh:  # the modular core, K3 in lane mode
            want.update(bvh=rounds, shade=rounds, sampler=rounds, finish=rounds)
            if engine == "sticky":  # a restart per round, one more for the final flush
                want["restart"] = rounds + 1
        else:
            want[ROUND_KERNEL[path]] = rounds
        # N5 off the K5 route, once per round and once before the first (K5
        # ends its own rounds with the test)
        if path != "sticky":
            want["loop"] = rounds + 1
        if engine == "wavefront":
            want["refill"] = extra["refills"] = refills
        extra["rounds"] = rounds
    if counts != want:
        raise SystemExit(f"{path} launch counters {counts} != expected {want}")
    img = read_ppm(ppm)
    if img.shape != (h, w, 3) or img.std() == 0:
        raise SystemExit(f"bad image: shape {img.shape}, std {img.std()}")
    if not np.array_equal(img, read_png(png + ".png")):
        raise SystemExit("PPM and PNG disagree")
    say("main", path=path, scene=os.path.basename(scene), size=f"{w}x{h}", spp=spp,
        env=json.dumps(env).replace(" ", ""), seconds=round(secs, 3), **extra,
        launches=json.dumps(counts).replace(" ", ""), mean_u8=round(float(img.mean()), 3))
    return counts


def render_pair(a, b, what: str, **extra) -> None:
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        raise SystemExit(f"non-finite radiance in {what}")
    agree = float((np.abs(a - b) <= PIX_ATOL).all(axis=-1).mean())
    say("render", case=what, pixel_agree=round(agree, 6),
        max_abs_err=float(np.abs(a - b).max()), mean=round(float(a.mean()), 5), **extra)
    if agree < PIX_FRAC:
        raise SystemExit(f"{what}: frames agree on {agree:.4f} < {PIX_FRAC} of pixels")


def modular_pair(desc, dev, what: str, **kw) -> None:
    """A frame of the modular route (its kernels, graphed) against the
    plain route's (``plain=True``): pixels as ``render_pair`` holds them,
    path vertices within ``VERTS_RTOL``."""
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer

    r = Renderer(desc, device=dev, **kw)
    if r.fused:
        raise SystemExit(f"{what}: the frame took the fused path")
    a, sa = r.render_radiance(seed=3, with_stats=True)
    b, sb = Renderer(desc, device=dev, plain=True, **kw).render_radiance(seed=3, with_stats=True)
    verts_err = abs(sa.path_vertices - sb.path_vertices) / max(sb.path_vertices, 1.0)
    s = desc.settings
    render_pair(a, b, what, size=f"{s.width}x{s.height}", spp=s.samples, engine=r.engine,
                backend=r.backend, prims=len(desc.primitives),
                path_vertices=int(sa.path_vertices), plain_path_vertices=int(sb.path_vertices),
                path_vertices_rel_err=verts_err)
    if verts_err > VERTS_RTOL:
        raise SystemExit(f"{what}: path vertices {sa.path_vertices} against the plain "
                         f"route's {sb.path_vertices}")


def phase_render(dev) -> None:
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer
    from raytracing_course_2024_tpu_torch.scene import load_scene, parse_text_scene

    w, h, spp = RENDER
    size = f"{w}x{h}"
    desc = load_scene(CORNELL, w, h, spp)
    fused = Renderer(desc, device=dev).render_radiance(seed=3)
    render_pair(fused, Renderer(desc, device=dev, plain=True).render_radiance(seed=3),
                "fused-kernels-vs-plain", size=size, spp=spp)
    modular_pair(desc, dev, "modular-kernels-vs-plain-rr", russian_roulette=True)
    # the same scene and settings on the modular route: its ModularScene on
    # the batch engine (K4, N1a, K3, N1b), against the fused frame
    from raytracing_course_2024_tpu_torch.integrator.path import render_batches
    from raytracing_course_2024_tpu_torch.ops import kernels as KN
    from raytracing_course_2024_tpu_torch.ops.scene_intersect import modular_scene

    fr = Renderer(desc, device=dev)
    outs, _ = render_batches(modular_scene(fr.arrays, fr.statics, dev),
                             (3 * 2654435761) & 0xFFFFFFFF, fr.cam_row, fr.cfg, w, h, spp,
                             fr.batch_size)
    render_pair(fr._assemble(outs), fused, "modular-vs-fused-kernels", size=size, spp=spp)

    # the lane engines (all from the same work-item streams)
    sticky = Renderer(desc, device=dev, engine="sticky").render_radiance(seed=3)
    render_pair(sticky, Renderer(desc, device=dev, engine="sticky", plain=True)
                .render_radiance(seed=3), "sticky-fused-kernels-vs-plain", size=size, spp=spp)
    render_pair(sticky, Renderer(desc, device=dev, engine="wavefront").render_radiance(seed=3),
                "sticky-fused-vs-wavefront", size=size, spp=spp)
    render_pair(Renderer(desc, device=dev, engine="sticky", batch_size=16_384)
                .render_radiance(seed=3), sticky, "sticky-16384-lanes-vs-sticky-fused",
                size=size, spp=spp)
    rr = Renderer(desc, device=dev, engine="sticky", russian_roulette=True)
    if rr.fused:
        raise SystemExit("sticky with roulette took the fused core")
    render_pair(rr.render_radiance(seed=3),
                Renderer(desc, device=dev, engine="sticky", russian_roulette=True, plain=True)
                .render_radiance(seed=3), "sticky-rr-kernels-vs-plain", size=size, spp=spp)
    mixed = parse_text_scene(MIXED_SCENE)
    mixed.settings.width, mixed.settings.height, mixed.settings.samples = w, h, spp
    render_pair(Renderer(mixed, device=dev, engine="sticky").render_radiance(seed=3),
                Renderer(mixed, device=dev, engine="sticky", plain=True).render_radiance(seed=3),
                "mixed-sticky-fused-kernels-vs-plain", size=size, spp=spp)

    mesh = mesh_desc(w, h, MESH_SPP)
    r = Renderer(mesh, device=dev)
    if r.fused or r.scene.tri_pack is not None:
        raise SystemExit("the mesh did not take the modular sweep")
    want = batch_launches(r, w * h, MESH_SPP)  # the sweep: K3, N1a and N1b
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    KN.reset_launches()
    a = r.render_radiance(seed=3)
    peak = frame_mem_mb(base)
    if KN.LAUNCHES != want:
        raise SystemExit(f"mesh launches {KN.LAUNCHES}: expected {want}")
    render_pair(a, Renderer(mesh, device=dev, plain=True).render_radiance(seed=3),
                "mesh1281-kernels-vs-plain", size=size, spp=MESH_SPP,
                prims=len(mesh.primitives),
                launches=json.dumps({k: v for k, v in want.items() if v}).replace(" ", ""),
                peak_mem_mb=peak)


def phase_render_bvh(dev) -> None:
    """Frames of the BVH backend against their plain versions (K6 against
    the sweep): the 5,120-triangle scene on the batch engine (N4, K6, N1a,
    K3, N1b) and on the counter wavefront (K6, N1a, K3 in lane mode, N1b,
    N2a); the 81,920-triangle scene of the main path at ``PLAIN_BVH`` on the batch, counter wavefront
    and sticky engines, path vertices held too (``modular_pair``); then the
    degenerate scenes, a table of one entry and a scene without a sampled
    surface, on the fused path (K2, K1) and with the BVH backend asked for."""
    from raytracing_course_2024_tpu_torch.ops import kernels as KN
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer
    from raytracing_course_2024_tpu_torch.scene import parse_text_scene

    w, h, spp = RENDER
    size = f"{w}x{h}"
    bvh = bvh_desc(w, h, MESH_SPP, subdiv=4)
    for engine in ("batch", "wavefront"):
        r = Renderer(bvh, device=dev, engine=engine)
        if r.backend != "bvh" or r.fused:
            raise SystemExit(f"the 5,120-triangle scene took {r.backend}, fused={r.fused}")
        KN.reset_launches()
        a = r.render_radiance(seed=3)
        launched = {k: v for k, v in KN.LAUNCHES.items() if v}
        allowed = {"bvh", "sampler", "shade", "finish"} | (
            {"refill", "loop"} if engine == "wavefront" else {"camera"})
        if (not launched.get("bvh") or launched.get("shade") != launched["bvh"]
                or set(launched) - allowed):
            raise SystemExit(f"BVH frame launches {launched}: expected K6, N1a, K3, N1b "
                             "(and N2a and N5 on the counter wavefront, N4 on the batch "
                             "engine)")
        render_pair(a, Renderer(bvh, device=dev, engine=engine, plain=True)
                    .render_radiance(seed=3), f"bvh5124-{engine}-kernels-vs-plain", size=size,
                    spp=MESH_SPP, prims=len(bvh.primitives), builder=r.bvh_builder,
                    launches=json.dumps(launched).replace(" ", ""))
    # the modular frames of the main path's 81,920-triangle scene, cut in
    # size: the plain route sweeps the whole table for every ray
    pw, ph, pspp = PLAIN_BVH
    big = bvh_desc(pw, ph, pspp)
    for engine in ("batch", "wavefront", "sticky"):
        modular_pair(big, dev, f"bvh81920-{engine}-kernels-vs-plain", engine=engine)
    for name, text in EDGE_SCENES.items():
        desc = parse_text_scene(text)
        desc.settings.width, desc.settings.height, desc.settings.samples = w, h, spp
        for backend in ("dense", "bvh"):
            render_pair(Renderer(desc, device=dev, backend=backend).render_radiance(seed=3),
                        Renderer(desc, device=dev, backend=backend, plain=True)
                        .render_radiance(seed=3), f"{name}-{backend}-kernels-vs-plain",
                        size=size, spp=spp)


def displaced_sphere(subdiv: int):
    """(vertices (V, 3), faces, smooth vertex normals) of an icosphere
    subdivided ``subdiv`` times (20 * 4^subdiv faces), displaced radially by
    smooth bumps (tests/meshes.py:displaced_organic_mesh)."""
    t = (1 + 5 ** 0.5) / 2
    verts = [np.array(v, float) for v in ((-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
                                          (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
                                          (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1))]
    verts = [v / np.linalg.norm(v) for v in verts]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9),
             (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2),
             (3, 2, 6), (3, 6, 8), (3, 8, 9), (4, 9, 5), (2, 4, 11), (6, 2, 10),
             (8, 6, 7), (9, 8, 1)]
    for _ in range(subdiv):
        cache, nxt = {}, []

        def mid(i, j):
            k = (min(i, j), max(i, j))
            if k not in cache:
                m = verts[i] + verts[j]
                verts.append(m / np.linalg.norm(m))
                cache[k] = len(verts) - 1
            return cache[k]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nxt += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = nxt
    vs = np.array(verts)
    x, y, z = vs[:, 0], vs[:, 1], vs[:, 2]
    vs = vs * (1.0 + 0.22 * (np.sin(3.1 * x + 1.3) * np.cos(2.3 * y)
                             + 0.6 * np.sin(4.7 * z + 0.5) * np.cos(3.9 * x)))[:, None]
    fa = np.asarray(faces)
    fn = np.cross(vs[fa[:, 1]] - vs[fa[:, 0]], vs[fa[:, 2]] - vs[fa[:, 0]])
    vn = np.zeros_like(vs)
    for c in range(3):
        np.add.at(vn, fa[:, c], fn)
    vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-30)
    return vs, fa, vn


def mesh_desc(w: int, h: int, spp: int, subdiv: int = 3, extras: bool = False):
    """A displaced icosphere of 20 * 4^subdiv smooth-shaded triangles under
    one triangle light; subdiv 3: 1280 triangles, 1281 primitives (the
    chunked sweep, above 128). With ``extras`` (the BVH scenes): two rotated
    boxes (one a mirror), a rotated ellipsoid and a ground plane too."""
    from raytracing_course_2024_tpu_torch.scene.types import (
        BOX, ELLIPSOID, MIRROR, PLANE, CameraDesc, PrimitiveDesc, RenderSettings, SceneDesc)

    vs, faces, vn = displaced_sphere(subdiv)
    color = np.array([0.7, 0.5, 0.6])
    prims = [PrimitiveDesc(ptype=0, p0=vs[a], p1=vs[b], p2=vs[c], sn0=vn[a], sn1=vn[b],
                           sn2=vn[c], color=color, metallic=0.3, roughness=0.4, mkind=3)
             for a, b, c in faces]
    prims.append(PrimitiveDesc(ptype=0, p0=np.array([-2.0, 2.5, -1.0]),
                               p1=np.array([2.0, 2.5, -1.0]), p2=np.array([0.0, 2.5, 2.0]),
                               color=np.zeros(3), emission=np.array([10.0, 9.0, 8.0]),
                               mkind=3))
    planes = []
    if extras:
        def quat(axis, angle):
            a = np.asarray(axis, float) / np.linalg.norm(axis)
            return np.append(a * np.sin(angle / 2), np.cos(angle / 2))

        prims += [
            PrimitiveDesc(ptype=BOX, p0=np.array([0.35, 0.35, 0.35]),
                          position=np.array([-1.6, -0.75, 0.4]),
                          rotation=quat((0.3, 1.0, 0.2), 0.7), color=np.array([0.3, 0.7, 0.3])),
            PrimitiveDesc(ptype=BOX, p0=np.array([0.3, 0.55, 0.3]),
                          position=np.array([1.55, -0.6, -0.3]),
                          rotation=quat((0.0, 1.0, 0.3), -0.5), color=np.array([0.9, 0.9, 0.9]),
                          mkind=MIRROR),
            PrimitiveDesc(ptype=ELLIPSOID, p0=np.array([0.25, 0.4, 0.3]),
                          position=np.array([0.95, 0.95, 0.8]),
                          rotation=quat((1.0, 0.2, 0.4), 0.9), color=np.array([0.8, 0.4, 0.2])),
        ]
        planes.append(PrimitiveDesc(ptype=PLANE, p0=np.array([0.0, 1.0, 0.0]),
                                    position=np.array([0.0, -1.3, 0.0]),
                                    color=np.array([0.6, 0.6, 0.65])))
    cam = CameraDesc(position=np.array([0.0, 0.4, 3.2]), right=np.array([1.0, 0.0, 0.0]),
                     up=np.array([0.0, 1.0, 0.0]), forward=np.array([0.0, 0.0, -1.0]),
                     fov_x=1.0, fov_y=2.0 * np.arctan(np.tan(0.5) * h / w))
    settings = RenderSettings(width=w, height=h, samples=spp, ray_depth=4,
                              bg_color=(0.15, 0.2, 0.3), camera=cam)
    return SceneDesc(settings=settings, primitives=prims, planes=planes)


def bvh_desc(w: int, h: int, spp: int, subdiv: int = 6):
    """The BVH scene: subdiv 6 gives 20 * 4^6 = 81,920 smooth-shaded
    triangles (the size of the largest course mesh) + 2 boxes, an ellipsoid,
    the light triangle and a ground plane; subdiv 4 gives 5,120."""
    return mesh_desc(w, h, spp, subdiv, extras=True)


def scene_text(desc) -> str:
    """``desc`` as a course text scene (scene/text_format.py): its camera,
    settings and primitives. Text triangles are flat-shaded and diffuse."""
    from raytracing_course_2024_tpu_torch.scene.types import BOX, DIELECTRIC, MIRROR, TRI

    s, c = desc.settings, desc.settings.camera

    def v(a):
        return " ".join(f"{float(x):.9g}" for x in a)

    out = [f"DIMENSIONS {s.width} {s.height}", f"RAY_DEPTH {s.ray_depth}",
           f"SAMPLES {s.samples}", f"BG_COLOR {v(s.bg_color)}", f"CAMERA_POSITION {v(c.position)}",
           f"CAMERA_RIGHT {v(c.right)}", f"CAMERA_UP {v(c.up)}",
           f"CAMERA_FORWARD {v(c.forward)}", f"CAMERA_FOV_X {c.fov_x:.9g}"]
    for p in desc.planes:
        out += ["NEW_PRIMITIVE", f"PLANE {v(p.p0)}", f"POSITION {v(p.position)}",
                f"COLOR {v(p.color)}"]
    for p in desc.primitives:
        out.append("NEW_PRIMITIVE")
        if p.ptype == TRI:
            out.append(f"TRIANGLE {v(p.p0)} {v(p.p1)} {v(p.p2)}")
        else:
            out += [f"{'BOX' if p.ptype == BOX else 'ELLIPSOID'} {v(p.p0)}",
                    f"POSITION {v(p.position)}", f"ROTATION {v(p.rotation)}"]
        out.append(f"COLOR {v(p.color)}")
        if p.is_emissive:
            out.append(f"EMISSION {v(p.emission)}")
        if p.mkind == MIRROR:
            out.append("METALLIC")
        elif p.mkind == DIELECTRIC:
            out += ["DIELECTRIC", f"IOR {p.ior:.9g}"]
    return "\n".join(out) + "\n"


def frame_mem_mb(base: int) -> float:
    """Peak device memory of what ran since ``base`` was read
    (``torch.cuda.memory_allocated()``), without the tensors the script
    already held then."""
    return round((torch.cuda.max_memory_allocated() - base) / 2**20, 1)


def frame_times(r, label: str, gpu: str, reps: int = 3) -> float:
    """Median host ms of ``reps`` frames after a warm-up; each frame ends in
    a device sync (reading its path-vertex count)."""
    r.render_frame_device(seed=0)  # warm-up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times, verts = [], 0.0
    for rep in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, verts = r.render_frame_device(seed=rep + 1)
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    say("timing", path=label, ms_per_frame=round(ms, 3), frames_ms=json.dumps(
        [round(t, 3) for t in times]).replace(" ", ""), path_vertices=int(verts),
        mrays_per_s=round(verts / ms / 1e3, 3),
        **({} if r.engine == "batch" else {"rounds": r.rounds}),
        peak_mem_mb=frame_mem_mb(base), gpu=f'"{gpu}"')
    return ms


def persistent_bytes(st: torch.Tensor, kmax: torch.Tensor) -> float:
    """Bytes one K5 round, in place, must move for this state, each input a
    lane needs read once and each output written once. A live lane reads ro, rd, thr,
    rad, alive, k, depth and kmax and writes all but k and kmax (120 B); a
    dead lane reads alive, k and kmax, plus rad and acc to flush when k > 0;
    a restarting one also reads px, py and writes ro, rd, thr, rad, alive, k,
    depth (with a flush: 116 B; without: 80 B); a finished one writes the
    flushed acc and the zeroed rad (60 B)."""
    alive, k = st[12] > 0.5, st[13]
    dead = ~alive
    flush = dead & (k > 0.5)
    take = dead & (k < kmax)
    floats = (alive.sum() * (16 + 14) + (dead.sum() * 3 + flush.sum() * 6)
              + take.sum() * (2 + 15) + flush.sum() * 3 + (flush & ~take).sum() * 3)
    return float(floats) * 4


def bounce_bytes(n: float, alive: float, final: bool, in_place: bool) -> float:
    """Bytes one K1 (``final``: K1-final) launch must move for ``n`` lanes of
    which ``alive`` are alive on entry, each input a lane needs read once and
    each output written once.

    In place, as every engine launches it: a live lane of K1 reads its 13
    rows and its work id and writes the 13 rows (108 B); a dead one reads its
    alive flag and has its throughput zeroed (28 B). K1-final draws nothing
    and leaves direction and throughput as they are: a live lane reads 13
    rows and writes origin, radiance and alive (80 B), a dead one is only
    asked its flag (4 B).

    Into a separate buffer all 13 rows of every lane are written: K1 reads
    origin, direction, radiance and alive of every lane (40 B), throughput
    and work id of the live ones (16 B); K1-final reads all 13 rows."""
    dead = n - alive
    if in_place:
        return alive * (52 + 28) + dead * 4 if final else alive * (56 + 52) + dead * 28
    return n * (52 + 52) if final else n * (40 + 52) + alive * 16


def separate_k1(dev, gpu: str, scene, bg, st0: torch.Tensor, idx: torch.Tensor) -> None:
    """What holds K1 back on the bounce-1 state of the main path, one cause
    at a time: ms per launch, in place, of K1 and K1-final (the loop without
    the sampler) on (i) the state as it is, its live lanes scattered among dead
    ones, (ii) the same lanes with the live ones sorted to the front, so
    that whole warps are live or dead whatever the kernel does, (iii) every
    lane alive (the live lanes repeated to fill the batch, in pixel order),
    and (iv) those sorted by the sampler component their first try picks,
    so that a warp's first candidates all come from one sampler."""
    from raytracing_course_2024_tpu_torch.ops import bounce as B
    from raytracing_course_2024_tpu_torch.ops import rng

    n = st0.shape[1]
    alive = st0[12] > 0.5
    live = torch.nonzero(alive).squeeze(1)
    order = torch.argsort((~alive).to(torch.int8), stable=True)
    fill = live[torch.arange(n, device=dev) % live.numel()]
    # the first try's component, as mixture() picks it at bounce 1
    key = rng.work_key(1, idx[fill].to(torch.int64))
    which = torch.clamp((rng.uniform_ctr(key, B._ctr(1, K, None).base) * 3).to(torch.int32),
                        max=2)
    by_which = fill[torch.argsort(which.to(torch.int8), stable=True)]
    states = {"as-is": (st0, idx), "live-first": (st0[:, order].contiguous(), idx[order]),
              "all-alive": (st0[:, fill].contiguous(), idx[fill]),
              "all-alive-by-component": (st0[:, by_which].contiguous(), idx[by_which])}
    buf = torch.empty_like(st0)
    seed_t, off_t = route_pair(1, 0, dev)
    for name, (st, wid) in states.items():
        wid = wid.contiguous()
        ms = cuda_ms_in_place(lambda: B.bounce(scene, buf, wid, off_t, seed_t, 1, bg, K,
                                               out=buf),
                              lambda: buf.copy_(st), 20)
        fin = cuda_ms_in_place(lambda: B.bounce(scene, buf, wid, off_t, seed_t, 1, bg, K,
                                                final_only=True, out=buf),
                               lambda: buf.copy_(st), 20)
        frac = float((st[12] > 0.5).float().mean())
        say("timing", separate="bounce", state=name, lanes=n, alive_in=round(frac, 4),
            bounce_ms=round(ms, 4), final_ms=round(fin, 4), sampler_ms=round(ms - fin, 4),
            ns_per_live_lane=round(ms * 1e6 / (frac * n), 3), gpu=f'"{gpu}"')


def persistent_rounds(dev, gpu: str, desc) -> None:
    """K5 round by round over one whole sticky frame of the main path: every
    round the engine could need (spp x ray_depth) is launched in place with
    a CUDA event between rounds and nothing is read until the last has run,
    so the ms are the kernel's own. Prints each round's ms and live share
    (the kernel's first count over the lanes) and what the tail costs."""
    from raytracing_course_2024_tpu_torch.ops import loop as LP
    from raytracing_course_2024_tpu_torch.ops.persistent import persistent_round

    w, h, spp = FRAME
    ins, state, args = sticky_inputs(dev, desc, w, h, spp)
    k5 = k5_args(args, dev)
    max_rounds = spp * desc.settings.ray_depth
    lss = [LP.LoopState(dev) for _ in range(max_rounds)]  # each round's counts
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(max_rounds + 1)]
    persistent_round(*ins, state.clone(), LP.LoopState(dev), *k5)  # warm-up
    torch.cuda.synchronize()
    marks[0].record()
    for r in range(max_rounds):
        persistent_round(*ins, state, lss[r], *k5, out=state)
        marks[r + 1].record()
    torch.cuda.synchronize()
    ms = [marks[r].elapsed_time(marks[r + 1]) for r in range(max_rounds)]
    live = [ls.loop[LP.NVERTS].item() / (w * h) for ls in lss]
    used = max(r for r in range(max_rounds) if live[r] > 0) + 1  # rounds with a live lane
    tail = [r for r in range(used) if live[r] < 0.1]
    say("timing", separate="persistent-rounds", lanes=w * h, rounds=used,
        frame_ms=round(sum(ms[:used]), 3), mean_ms=round(sum(ms[:used]) / used, 4),
        mean_live=round(sum(live[:used]) / used, 4), tail_rounds_under_10pct_live=len(tail),
        tail_ms=round(sum(ms[r] for r in tail), 3),
        empty_round_ms=round(ms[-1], 4) if used < max_rounds else None, gpu=f'"{gpu}"')
    say("timing", separate="persistent-rounds", ms_per_round=json.dumps(
        [round(t, 4) for t in ms[:used]]).replace(" ", ""))
    say("timing", separate="persistent-rounds", live_share_per_round=json.dumps(
        [round(x, 4) for x in live[:used]]).replace(" ", ""))


def route_pair(seed: int, wid_off: int, dev) -> tuple:
    """``(seed, wid_off)`` as the graphed routes hand them to K1 and K2: two
    consecutive elements of one int64 device tensor, which the wrappers pass
    to the kernel as they are (no launch), so that a timed launch is the
    kernel's alone. A tree whose K1 and K2 take them by value
    (``kernel_times.py --root``: before ``ops/rng.py:seed_off``) gets the
    ints."""
    from raytracing_course_2024_tpu_torch.ops import rng

    if not hasattr(rng, "seed_off"):
        return seed, wid_off
    pair = torch.tensor([seed, wid_off], dtype=torch.int64, device=dev)
    return pair[0], pair[1]


def k3_args(args: tuple) -> tuple:
    """K3's arguments with the seed and the work-id offset as the modular
    route passes them: consecutive elements of one int64 device tensor,
    which the wrapper hands the kernel as they are, so that a timed launch
    is K3's alone (ints cost the wrapper three small launches of its own). A
    tree whose K3 takes them by value (``kernel_times.py --root``) gets the
    ints."""
    from raytracing_course_2024_tpu_torch.ops import sampler

    if not (hasattr(sampler, "_seed_off") or hasattr(sampler, "seed_off")):
        return args
    so = torch.tensor([args[1], args[3]], dtype=torch.int64, device=args[2].device)
    return (args[0], so[0], args[2], so[1], *args[4:])


def nearest_fn(m: Modular, ro, rd, live):
    """A call of K4 on these rays as the package under test takes it: with
    the scene's records and the live mask where it has them (a tree from
    before the mask takes neither; ``live`` must then be None)."""
    from raytracing_course_2024_tpu_torch.ops.dense_nearest import dense_nearest

    if not has_live_mask():
        if live is not None:
            raise ValueError("this tree's dense_nearest takes no live mask")
        return lambda: dense_nearest(ro, rd, m.scene.tri_pack)
    return lambda: dense_nearest(ro, rd, m.scene.tri_pack, live=live, records=m.scene.tri_rec)


def has_live_mask() -> bool:
    import inspect

    from raytracing_course_2024_tpu_torch.ops.dense_nearest import dense_nearest

    return "live" in inspect.signature(dense_nearest).parameters


def modular_times(m: Modular, gpu: str, reps: int, label: str = "timing") -> dict:
    """K4 and K3 at the main path's lanes on the camera state and on the
    bounce-1 state, each launch between its own pair of CUDA events while the
    stream is held (``cuda_ms_each``): K4 without a mask and, where the tree
    has one, with the state's live mask (on the camera state every lane is
    live), K3 on the surfaces of both states. ``back_to_back_ms`` is the old
    reading, one pair of events around all the launches, which the host's
    cost per call can set. Prints one line per case and returns
    name -> {"ms", "mean_ms", "min_ms", "max_ms", "gap_ms", "back_to_back_ms"}."""
    from raytracing_course_2024_tpu_torch.ops.sampler import sample_mixture_kernel

    cases = {}
    for state, (ro, rd), alive, args in (("camera", (m.ro, m.rd), m.alive, m.sampler_args),
                                         ("bounce1", m.bounce1, m.alive1, m.sampler_args1)):
        cases[f"nearest-{state}"] = (nearest_fn(m, ro, rd, None), 1.0)
        if has_live_mask():
            cases[f"nearest-{state}-masked"] = (nearest_fn(m, ro, rd, alive),
                                                float(alive.float().mean()))
        cases[f"sampler-{state}"] = (lambda args=k3_args(args): sample_mixture_kernel(*args),
                                     float(args[10].float().mean()))
    out = {}
    for name, (fn, active) in cases.items():
        stats = {}
        ms = cuda_ms_each(fn, reps, stats)
        out[name] = dict(stats, ms=ms, back_to_back_ms=cuda_ms(fn, reps), active_in=active)
        say(label, separate="modular-kernels", case=name, lanes=m.wid.shape[0],
            active_in=round(active, 4), ms=round(ms, 4),
            **{k: round(v, 4) for k, v in stats.items()},
            back_to_back_ms=round(out[name]["back_to_back_ms"], 4),
            clocks=f'"{clocks_line()}"', gpu=f'"{gpu}"')
    return out


def modular_levels(m: Modular, gpu: str, reps: int, label: str = "timing") -> None:
    """K4 and K3 level by level on the states of one sample of the modular
    main path (``Modular(levels=True)``: roulette on): ms per launch with the
    level's live mask (where the tree has one) and without, K3 on the level's
    surfaces, and the sums over the levels, i.e. what one sample of the frame
    spends in each kernel."""
    from raytracing_course_2024_tpu_torch.ops.sampler import sample_mixture_kernel

    masked = has_live_mask()
    total = {"nearest": 0.0, "nearest_no_mask": 0.0, "sampler": 0.0}
    for lvl, (ro, rd, alive, args) in enumerate(m.levels):
        plain_ms = cuda_ms_each(nearest_fn(m, ro, rd, None), reps)
        k4 = cuda_ms_each(nearest_fn(m, ro, rd, alive), reps) if masked else plain_ms
        k3 = (cuda_ms_each(lambda a=k3_args(args): sample_mixture_kernel(*a), reps) if args
              else None)
        total["nearest"] += k4
        total["nearest_no_mask"] += plain_ms
        total["sampler"] += k3 or 0.0
        say(label, separate="modular-levels", level=lvl,
            alive_in=round(float(alive.float().mean()), 4),
            need_in=round(float(args[10].float().mean()), 4) if args else None,
            nearest_ms=round(k4, 4), nearest_no_mask_ms=round(plain_ms, 4),
            sampler_ms=None if k3 is None else round(k3, 4))
    say(label, separate="modular-levels", levels=len(m.levels),
        **{f"{k}_ms_per_sample": round(v, 4) for k, v in total.items()}, gpu=f'"{gpu}"')


def launch_times(scene, cam, bg, st0, idx, w: int, h: int, m: Modular, k5, reps: int = 20,
                 gpu: str = "", label: str = "timing"):
    """ms per launch from CUDA events of every kernel at the main path's
    shapes: ``st0`` is the (13, w * h) state after K2, ``m`` the modular
    case, ``k5`` the sticky frame's (inputs, state, arguments) some rounds
    in. K2 writes the state it is handed. K1, K1-final and K5 update their
    state in place on the main path, so they are timed in place, the input
    put back before every launch outside the timed span; K2 too is timed
    with a pair of events per launch while the stream is held. K4 and K3 write
    fresh outputs and take well under 0.1 ms, less than the host needs to
    make one call, so each of their launches has its own pair of events and
    the stream is held while the host enqueues (``modular_times``); their
    entries are the camera state as the main path launches it (K4 with the
    live mask where the tree has one). Returns those times, for K1, K1-final
    and K5 the time of reading the input and writing a separate buffer,
    where a dead lane is copied whole, and ``modular_times``' cases."""
    from raytracing_course_2024_tpu_torch.ops import bounce as B
    from raytracing_course_2024_tpu_torch.ops.loop import LoopState
    from raytracing_course_2024_tpu_torch.ops.persistent import persistent_round

    px, py = (idx % w).float(), (idx // w).float()
    seed_t, off_t = route_pair(1, 0, st0.device)  # as the graphed routes launch K1 and K2
    buf = torch.empty_like(st0)
    ins, st5, args5 = k5
    buf5 = torch.empty_like(st5)
    ls, k5a = LoopState(st0.device), k5_args(args5, st0.device)
    modular = modular_times(m, gpu, reps, label)
    k4 = "nearest-camera-masked" if "nearest-camera-masked" in modular else "nearest-camera"
    launch_ms = {
        # K2 writes a buffer it does not read: nothing to put back, but each
        # launch between its own pair of events while the stream is held
        "primary": cuda_ms_in_place(lambda: B.primary_bounce(
            scene, cam, px, py, idx, off_t, seed_t, bg, K, w, h, out=buf), lambda: None, reps),
        "bounce": cuda_ms_in_place(lambda: B.bounce(scene, buf, idx, off_t, seed_t, 1, bg, K,
                                                    out=buf),
                                   lambda: buf.copy_(st0), reps),
        "final": cuda_ms_in_place(lambda: B.bounce(
            scene, buf, idx, off_t, seed_t, 1, bg, K, final_only=True, out=buf),
            lambda: buf.copy_(st0), reps),
        "nearest": modular[k4]["ms"],
        "sampler": modular["sampler-camera"]["ms"],
        "persistent": cuda_ms_in_place(
            lambda: persistent_round(*ins, buf5, ls, *k5a, out=buf5),
            lambda: buf5.copy_(st5), reps),
    }
    fresh_ms = {
        "bounce": cuda_ms(lambda: B.bounce(scene, st0, idx, off_t, seed_t, 1, bg, K, out=buf),
                          reps),
        "final": cuda_ms(lambda: B.bounce(
            scene, st0, idx, off_t, seed_t, 1, bg, K, final_only=True, out=buf), reps),
        "persistent": cuda_ms(
            lambda: persistent_round(*ins, st5, ls, *k5a, out=buf5), reps),
    }
    return launch_ms, fresh_ms, modular


def shade_bytes(st, t, idx, ps, psurf, scene, depth=None, last: int = 0,
                final: bool = False) -> float:
    """The bytes one N1a launch must move, counted lane by lane from what its
    outputs depend on; the plain version's outputs on the same inputs in
    the batch layout (``ps``, ``psurf``: not ``final``, no ``depth``) say
    which lanes hit and change: alive read on every lane and ``need``
    written (not ``final``); on a live lane t, and the ray where a plane
    may win or (not ``final``) the lane hits; the row on a lane whose table
    row won; the throughput and the radiance (read and written) where the
    radiance changes (the background, an emitter); in the lane layout
    (``depth``, ``last``) the depth where the lane hits; alive written
    where the lane dies; the 21 surface values where it hit (not
    ``final``); each table row hit once (``SHADE_BYTES_ROW``, with ``final``
    its emission's 12 B) and the plane table once. The count does not
    depend on the layout the kernel reads and writes."""
    from raytracing_course_2024_tpu_torch.ops.shade import surface_of

    def f(m) -> float:
        return float(m.sum())

    n = st.shape[1]
    planes = scene.statics.num_planes > 0
    live, hit = st[12] > 0.5, ps[12] > 0.5  # the batch layout: alive after N1a = hit
    t_hit = surface_of(psurf).t
    table = hit & (t_hit == t)  # the table's row, not a plane, won
    lit = live & (ps[9:12] != st[9:12]).any(0)
    ray = live if planes else (torch.zeros_like(live) if final else hit)
    alive = hit if depth is None else hit & (depth < last)
    rows = torch.unique(idx[table]).numel()
    nbytes = (n * 4 + f(live) * 4 + f(ray) * 24 + f(table) * 4 + f(lit) * (12 + 24)
              + f(live & ~alive) * 4 + rows * (12 if final else SHADE_BYTES_ROW)
              + (scene.plane_packed.numel() * 4 if planes else 0))
    if depth is not None:
        nbytes += f(hit) * 4
    if not final:
        nbytes += n * 1 + f(hit) * SURF_BYTES
    return nbytes


def finish_bytes(ps, psurf, ok, pf, cfg, bounce_i: int = 0, depth=None) -> float:
    """The bytes one N1b launch must move, counted lane by lane from what its
    outputs depend on (``ps``, ``psurf``: its inputs; ``pf``: the plain
    version's output): alive read and ``live`` written on every lane and
    the seed pair once; on a lane that hit rd, the throughput, point,
    n_geom and mkind; the color on MIRROR lanes; ior and is_outer on
    DIELECTRIC lanes, and on the transmitted ones ro and t (and the color
    where they enter); on the others the color, metallic,
    roughness, l, pdf and ok; the work id where a draw is used (the
    dielectric split without TIR, roulette); the ray and throughput
    written where the lane lives on, alive where it dies. In the lane
    layout also the depth of a lane that hit, the parked ray and zeroed
    throughput of a lane that dies, and on a lane dead on entry whose rows
    change, the throughput read and the parked rows written."""
    from raytracing_course_2024_tpu_torch.ops.shade import RR_START, sampler_inputs, surface_of
    from raytracing_course_2024_tpu_torch.scene.types import DIELECTRIC, MIRROR

    def f(m) -> float:
        return float(m.sum())

    n = ps.shape[1]
    hit = ps[12] > 0.5
    s = surface_of(psurf)
    point, nrm, _, v, _ = sampler_inputs(psurf)
    mirror, diel = hit & (s.mkind == MIRROR), hit & (s.mkind == DIELECTRIC)
    brdf = hit & ~mirror & ~diel
    cos_i = torch.clamp(v.x * nrm.x + v.y * nrm.y + v.z * nrm.z, 0.0, 1.0)
    eta = torch.where(s.is_outer, 1.0 / s.ior, s.ior)
    tir = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0) > 1.0
    lives = pf[12] > 0.5
    died = hit & ~lives
    # a transmitted ray leaves from past the surface, not from the point; in
    # the lane layout a lane that dies is parked instead
    moved = (pf[0] != point.x) | (pf[1] != point.y) | (pf[2] != point.z)
    transmitted = diel & moved & (lives if depth is not None else True)
    level = bounce_i if depth is None else depth
    rolled = hit & (~brdf | ok) & (level >= RR_START) if cfg.rr else torch.zeros_like(hit)
    nbytes = (n * (4 + 1) + 16 + f(hit) * (12 + 12 + 12 + 12 + 4) + f(mirror) * 12
              + f(diel) * 8 + f(transmitted) * (12 + 4) + f(transmitted & s.is_outer) * 12
              + f(brdf) * (12 + 4 + 4 + 12 + 4 + 1) + f((diel & ~tir) | rolled) * 4
              + f(hit & ~died) * (24 + 12) + f(died) * 4)
    if depth is not None:
        parked = ~hit & (pf[0:9] != ps[0:9]).any(0)
        nbytes += f(hit) * 4 + f(died) * (24 + 12) + f(parked) * (12 + 24 + 12)
    return nbytes


def n1_bytes(st, t, idx, ps, psurf, ok, pf, scene, cfg, bounce_i: int) -> tuple:
    """The bytes N1a and N1b must move on one state of the batch layout
    (``shade_bytes``, ``finish_bytes``): (N1a's bytes, N1b's bytes)."""
    return (shade_bytes(st, t, idx, ps, psurf, scene),
            finish_bytes(ps, psurf, ok, pf, cfg, bounce_i))


def n1_ops(st, ps, scene, final: bool = False) -> tuple:
    """(N1a's, N1b's) fp32 operations on one state: the plane fold on every
    live lane, the surface (not ``final``) and N1b's work on every lane that
    hit (``ps``: the plain N1a's output in the batch layout)."""
    planes = scene.plane_packed.shape[1] if scene.statics.num_planes > 0 else 0
    live, hit = float((st[12] > 0.5).sum()), float((ps[12] > 0.5).sum())
    return (live * planes * OPS_SHADE_PLANE + (0.0 if final else hit * OPS_SHADE),
            hit * OPS_FINISH)


def n1_frame_bounds(desc, dev, seed: int, **kw) -> dict:
    """The least time of every N1a and N1b launch of one eager frame of
    ``Renderer(desc, **kw)`` (the same launches on the same data as the
    graphed frame of that seed), summed over the frame: each launch's bytes
    (``shade_bytes``, ``finish_bytes``) and operations (``n1_ops``) counted
    from the plain versions run on its inputs beside it. Returns kernel ->
    dict(launches, bound_ms)."""
    from raytracing_course_2024_tpu_torch.integrator import path as P
    from raytracing_course_2024_tpu_torch.integrator import wavefront as W
    from raytracing_course_2024_tpu_torch.ops import shade as SH
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer

    sums = {k: {"launches": 0, "bound_ms": 0.0} for k in ("shade", "finish")}

    def add(k: str, nbytes: float, ops: float) -> None:
        sums[k]["launches"] += 1
        sums[k]["bound_ms"] += bound(nbytes, ops)[0]

    def shade(state, t, idx, scene, bg, depth=None, last=0, final=False, count=None):
        ps, psurf, _ = SH.shade_plain(state.clone(), t, idx, scene, bg)
        add("shade", shade_bytes(state, t, idx, ps, psurf, scene, depth, last, final),
            n1_ops(state, ps, scene, final)[0])
        return SH.shade(state, t, idx, scene, bg, depth, last, final, count=count)

    def finish(state, surf, l_s, pdf, ok, wid, seed, wid_off, cfg, bounce_i=0, depth=None):
        pf, _ = SH.finish_plain(state.clone(), surf, l_s, pdf, ok, wid, seed, wid_off, cfg,
                                bounce_i, depth)
        add("finish", finish_bytes(state, surf, ok, pf, cfg, bounce_i, depth),
            float((state[12] > 0.5).sum()) * OPS_FINISH)
        return SH.finish(state, surf, l_s, pdf, ok, wid, seed, wid_off, cfg, bounce_i, depth)

    saved = P.shade, P.finish, W.shade, W.finish
    P.shade, P.finish, W.shade, W.finish = shade, finish, shade, finish
    try:
        Renderer(desc, device=dev, eager=True, **kw).render_frame_device(seed=seed)
    finally:
        P.shade, P.finish, W.shade, W.finish = saved
    torch.cuda.synchronize()
    return sums


def shade_times(n1: dict, gpu: str, reps: int = 20, label: str = "timing") -> dict:
    """N1a and N1b per launch at the main path's shape: the BVH frame's
    921,600 lanes on its camera, bounce-1 and bounce-3 states
    (``n1_states``, ``n1_timing_case``), each launch between its own pair of
    CUDA events while the stream is held, in place as the route launches
    them, the state put back before every launch outside the timed span
    (``cuda_ms_in_place``); N1b given the seed pair as the graphed route
    hands it over, on the sampler K3's output. The plain versions timed
    once each. The bound from this state's lanes (``n1_bytes``,
    ``n1_ops``). Returns state -> kernel -> dict(ms, plain_ms, bound,
    active_in)."""
    from raytracing_course_2024_tpu_torch.ops.shade import finish, finish_plain, shade, shade_plain

    scene, cfg, wid = n1["scene"], n1["cfg"], n1["wid"]
    bg = cfg.bg_color
    seed_t, off_t = route_pair(SEED, 0, wid.device)
    out = {}
    for name in N1_LEVELS:
        c = n1[name]
        st, t, idx, ps, psurf, bi = c["st"], c["t"], c["idx"], c["ps"], c["psurf"], c["bounce_i"]
        l_s, pdf, ok = c["sample"]
        n = st.shape[1]
        buf = torch.empty_like(st)
        ms = {"shade": cuda_ms_in_place(lambda: shade(buf, t, idx, scene, bg),
                                        lambda: buf.copy_(st), reps),
              "finish": cuda_ms_in_place(
                  lambda: finish(buf, psurf, l_s, pdf, ok, wid, seed_t, off_t, cfg, bi),
                  lambda: buf.copy_(ps), reps)}
        plain = {"shade": cuda_ms(lambda: shade_plain(st, t, idx, scene, bg), 2),
                 "finish": cuda_ms(lambda: finish_plain(ps, psurf, l_s, pdf, ok, wid, SEED, 0,
                                                        cfg, bi), 2)}
        pf, _ = finish_plain(ps, psurf, l_s, pdf, ok, wid, SEED, 0, cfg, bi)
        nbytes = n1_bytes(st, t, idx, ps, psurf, ok, pf, scene, cfg, bi)
        ops = n1_ops(st, ps, scene)
        bounds = {k: bound(nbytes[j], ops[j]) for j, k in enumerate(("shade", "finish"))}
        active = {"shade": float((st[12] > 0.5).sum()) / n,
                  "finish": float((ps[12] > 0.5).sum()) / n}
        out[name] = {}
        for k in ("shade", "finish"):
            out[name][k] = dict(ms=ms[k], plain_ms=plain[k], bound=bounds[k], active_in=active[k])
            say(label, kernel=k, state=name, lanes=n, active_in=round(active[k], 4),
                ms=round(ms[k], 4), plain_ms=round(plain[k], 3),
                bound_ms=round(bounds[k][0], 5), bound_by=bounds[k][1],
                share=round(bounds[k][0] / ms[k], 4), clocks=f'"{clocks_line()}"',
                gpu=f'"{gpu}"')
    return out


# K6's fp32 operations on the yardstick of the binary walk, K6's first
# design (box tests as in csrc/bvh_traverse.cu, common.cuh): the bound of
# every K6 design is counted from the binary walk model's counts, so that
# their shares compare
OPS_BOX_K6 = 25  # one box_entry: 6 sub, 6 mul, 12 min/max, 1 compare
OPS_NODE_K6 = 2 * OPS_BOX_K6 + 1  # an internal node: both children's boxes, the order
OPS_PRIM_K6 = OPS_TRI_K4 + 1  # a primitive test (as a triangle's) and the running min
WALK_RAYS = 4_096  # rays of the walk models that K6's work is counted from


def bvh_launch_times(r, gpu: str, states: dict, reps: int = 20, label: str = "timing",
                     models: bool = True) -> dict:
    """K6 at the main path's shape: ``states`` holds the 921,600 camera rays
    of the BVH frame and its bounce-1 rays (after one modular bounce through
    K6 and K3), each with its live mask (``bvh_state``); ms per launch from
    an event pair per launch while the stream is held (``cuda_ms_each``).
    With ``models`` the walk models retrace 4,096 of the rays, spread over
    the frame, on the card: the wide walk (``ops/traverse.py:walk_reference``,
    K6's own) must equal K6 on every one of them, masked lanes included, and
    the binary walk (``walk_binary``) on the live ones; the binary walk's
    internal nodes and primitive tests per ray give K6's work for the bound
    (each binary node and record read once, each ray's 24 B and flag read
    and its 8 B written once), and the wide walk's wide nodes, child boxes
    and primitive tests per ray are printed beside them, with the share of
    the wide visits that K6's staged top serves. Returns name -> dict(ms,
    and with ``models`` bound and counts)."""
    from raytracing_course_2024_tpu_torch.ops.traverse import bvh_nearest
    from raytracing_course_2024_tpu_torch.ops.vec import Vec3

    n = r.settings.width * r.settings.height
    scene = r.scene
    sel = torch.arange(WALK_RAYS, device=r.device) * (n // WALK_RAYS)
    out = {}
    for name, (ro, rd, alive) in states.items():
        stats = {}
        ms = cuda_ms_each(lambda: bvh_nearest(ro, rd, scene, live=alive), reps, stats)
        live = float(alive.sum())
        out[name] = dict(ms=ms, active_in=live / n)
        if not models:
            say(label, kernel="bvh", state=name, lanes=n, active_in=round(live / n, 4),
                ms=round(ms, 4), **{k: round(v, 4) for k, v in stats.items()},
                clocks=f'"{clocks_line()}"', gpu=f'"{gpu}"')
            continue
        from raytracing_course_2024_tpu_torch.ops.bvh import build_bvh_nodes
        from raytracing_course_2024_tpu_torch.ops.traverse import walk_binary, walk_reference

        tk, ik = bvh_nearest(ro, rd, scene, live=alive)
        ro_s, rd_s = Vec3(*(c[sel] for c in ro)), Vec3(*(c[sel] for c in rd))
        live_s = alive[sel]
        t_w, i_w, visits, boxes, tests_w, top = walk_reference(ro_s, rd_s, scene, live=live_s)
        nodes2 = torch.from_numpy(build_bvh_nodes(r.arrays.bvh)).to(r.device)
        t_b, i_b, inner, leaves, tests = walk_binary(ro_s, rd_s, scene, nodes2)
        same = bool(torch.equal(t_w, tk[sel]) and torch.equal(i_w, ik[sel]))
        same_b = bool(torch.equal(t_b[live_s], tk[sel][live_s])
                      and torch.equal(i_b[live_s], ik[sel][live_s]))
        check(dict(walk_equal=same, binary_walk_equal=same_b, walk_rays=WALK_RAYS,
                   live_rays=int(live_s.sum())), f"bvh81920-{n}:{name}-walk", same and same_b)
        per_ray = {k: float(v[live_s].double().mean()) for k, v in
                   (("internal_nodes", inner), ("leaves", leaves), ("prim_tests", tests),
                    ("wide_nodes", visits), ("wide_boxes", boxes), ("wide_prim_tests", tests_w))}
        top_share = float(top[live_s].sum() / visits[live_s].sum())
        ops = live * (per_ray["internal_nodes"] * OPS_NODE_K6 + per_ray["prim_tests"] * OPS_PRIM_K6)
        nbytes = n * (1 + 8) + live * 24 + (nodes2.numel() + scene.bvh_rec.numel()) * 4
        b_ms, b_by = bound(nbytes, ops)
        out[name].update(bound=(b_ms, b_by), top_share=top_share, **per_ray)
        say(label, kernel="bvh", state=name, lanes=n, active_in=round(live / n, 4),
            ms=round(ms, 4), **{k: round(v, 4) for k, v in stats.items()},
            **{f"{k}_per_ray": round(v, 3) for k, v in per_ray.items()},
            wide_top_share=round(top_share, 4), bound_ms=round(b_ms, 5), bound_by=b_by,
            share=round(b_ms / ms, 4),
            clocks=f'"{clocks_line()}"', gpu=f'"{gpu}"')
    return out


def frames_in_turns(rs: dict, gpu: str, turns: int = 3, label: str = "timing") -> dict:
    """The renderers ``rs`` (path name -> Renderer): a warm-up frame each,
    then one frame each in turn, ``turns`` times. Host-bound frames drift
    with the host's speed within a call, so the paths are compared under
    the same drift. Prints each path's median host ms (each frame ends in a
    device sync), its frames, the waits on the card of one more frame
    (``host_reads``), path vertices, rounds and peak memory; returns path ->
    (median ms, Renderer)."""
    for r in rs.values():
        r.render_frame_device(seed=0)
    times = {e: [] for e in rs}
    verts, peak = {}, dict.fromkeys(rs, 0.0)
    for turn in range(turns):
        for e, r in rs.items():
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            _, verts[e] = r.render_frame_device(seed=turn + 1)
            times[e].append((time.perf_counter() - t0) * 1e3)
            peak[e] = max(peak[e], frame_mem_mb(base))
    waits = {}
    for e, r in rs.items():
        torch.cuda.synchronize()
        with host_reads() as n:
            r.render_frame_device(seed=turns + 1)
        waits[e] = n[0]
    out = {}
    for e, r in rs.items():
        ms = statistics.median(times[e])
        out[e] = (ms, r)
        say(label, path=e, ms_per_frame=round(ms, 3), frames_ms=json.dumps(
            [round(t, 3) for t in times[e]]).replace(" ", ""), host_reads=waits[e],
            path_vertices=int(verts[e]),
            mrays_per_s=round(verts[e] / ms / 1e3, 3), engine=r.engine,
            **({} if r.engine == "batch" else {"rounds": r.rounds}), peak_mem_mb=peak[e],
            graphed=r.graphs is not None, gpu=f'"{gpu}"')
    return out


def bvh_engine_turns(dev, gpu: str, desc, turns: int = 3, label: str = "timing",
                     eager: bool = False) -> dict:
    """The frame ``desc`` (the BVH scene) on each engine and on the
    Renderer's default one (path ``bvh-default``, as the CLI renders it), in
    turns (``frames_in_turns``; paths ``bvh-<engine>``, and with ``eager``
    also ``bvh-<engine>-eager``, the same renderer with ``eager=True``);
    returns engine -> (median ms, Renderer) of the graphed renderers."""
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer

    rs = {"bvh-default": Renderer(desc, device=dev)}
    for e in ("batch", "sticky", "wavefront"):
        rs[f"bvh-{e}"] = Renderer(desc, device=dev, engine=e)
        if eager:
            rs[f"bvh-{e}-eager"] = Renderer(desc, device=dev, engine=e, eager=True)
    out = frames_in_turns(rs, gpu, turns, label)
    return {e: out[f"bvh-{e}"] for e in ("batch", "sticky", "wavefront")}


def phase_timing_bvh(dev, gpu: str) -> dict:
    """The BVH frame (81,920 triangles, 1280x720 x 16 spp) on each engine
    (``bvh_engine_turns``: median of 3 frames per engine, taken in turns,
    with the path vertices); the counter wavefront's frame rendered twice
    from one seed must be equal bit for bit; K6 per launch at the main
    path's 921,600 camera and bounce-1 rays (``bvh_launch_times``), and its
    plain version (the sweep) timed once on each state, whose answer K6 must
    then match lane for lane with the state's live mask (``bvh_case``)."""
    from raytracing_course_2024_tpu_torch.ops.traverse import bvh_nearest_plain

    w, h, spp = FRAME
    n = w * h
    engines = bvh_engine_turns(dev, gpu, bvh_desc(w, h, spp))
    r = engines["wavefront"][1]
    twice = [r.render_frame_device(seed=7)[0][0] for _ in range(2)]
    same = bool(torch.equal(*twice))
    say("timing", path="bvh-wavefront-determinism", bit_equal=same,
        max_abs_diff=float((twice[0] - twice[1]).abs().max()))
    if not same:
        raise SystemExit("two counter-wavefront frames from one seed differ")
    states = bvh_state(r, n, plain=False)
    k6 = bvh_launch_times(r, gpu, states)
    plain_ms, err = {}, 0.0
    for name, (ro, rd, alive) in states.items():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        plain = bvh_nearest_plain(ro, rd, r.scene)
        end.record()
        torch.cuda.synchronize()
        plain_ms[name] = start.elapsed_time(end)
        err = max(err, bvh_case(f"bvh81920-{n}:{name}-masked", ro, rd, r.scene, alive, plain))
    frames = {e: ms for e, (ms, _) in engines.items()}
    say("timing", kernel="bvh", plain_ms=round(plain_ms["camera"], 3),
        plain_ms_bounce1=round(plain_ms["bounce1"], 3), lanes=n, gpu=f'"{gpu}"',
        frames_ms=json.dumps({k: round(v, 3) for k, v in frames.items()}).replace(" ", ""))
    return {"k6": k6, "plain_ms": plain_ms["camera"], "frames": frames, "max_abs_err": err}


# the runtime phase: checkpointed resume, the sharded renderer, the device trace
CKPT_CHUNK = 16  # spp per checkpoint chunk
CKPT = {"fused": 64, "sticky": 32, "bvh": 32, "sharded": 32}  # case -> spp of the frame
SHARD_MESHES = ((2, 1), (1, 2), (2, 2))
SHARD_BVH_SPP = 4
SHARD_RTOL, SHARD_ATOL = 1e-4, 1e-5  # JAX test_wavefront_sharded_mesh_invariance


class Interrupted(RuntimeError):
    pass


class Chunked:
    """A renderer as ``render_with_checkpoints`` sees it. Per chunk it sets
    the launch counters to 0 just before the chunk and reads them just after,
    and keeps the chunk's ms, its rounds and the host ms since the previous
    chunk returned (the checkpoint: the f64 sum, the ``.npz`` write, the
    ``os.replace``) and the counter wavefront's refills of the chunk. Raises
    ``Interrupted`` in place of chunk ``stop``."""

    def __init__(self, renderer, stop=None):
        self.r, self.stop = renderer, stop
        self.launches, self.ms, self.rounds, self.between_ms = [], [], [], []
        self.refills = []
        self._end = None

    def __getattr__(self, name):
        return getattr(self.r, name)

    def render_radiance(self, seed, samples):
        from raytracing_course_2024_tpu_torch.ops import kernels as KN

        t0 = time.perf_counter()
        if self._end is not None:
            self.between_ms.append((t0 - self._end) * 1e3)
        if len(self.ms) == self.stop:
            raise Interrupted(f"chunk {self.stop}")
        reset_counts()
        img = self.r.render_radiance(seed=seed, samples=samples)  # ends in a host copy
        self.launches.append(dict(KN.LAUNCHES))
        self.refills.append(refills_run())
        self._end = time.perf_counter()
        self.ms.append((self._end - t0) * 1e3)
        self.rounds.append(getattr(self.r, "rounds", 0))
        return img


def nearest_kernel(r) -> str | None:
    """The nearest-hit kernel of the modular scene of ``r`` (a ``Renderer``
    or a ``ShardedRenderer``): K6, K4 or none (the sweep)."""
    scene = r.scene if hasattr(r, "scene") else next(iter(r.scenes.values()))
    if scene.bvh_nodes is not None:
        return "bvh"
    return "nearest" if scene.tri_pack is not None else None


def k3_key(r) -> str:
    """K3's launch counter for the scene of ``r``: ``sampler_many`` above
    32 lights (the walk of the lights' tree), else ``sampler``."""
    from raytracing_course_2024_tpu_torch.ops.sampling import UNROLL_MAX_LIGHTS

    return "sampler_many" if r.statics.num_lights > UNROLL_MAX_LIGHTS else "sampler"


def batch_launches(r, n_pix: int, spp: int, shards: int = 1) -> dict:
    """The launches of a batch-engine frame of ``shards`` shards of ``n_pix``
    pixels at ``spp`` samples each: per batch and sample, K2 + K1 per middle
    level + K1-final (fused), or N4, the nearest hit (K6 or K4) and N1a per
    level, K3 and N1b per level but the last (modular)."""
    from raytracing_course_2024_tpu_torch.integrator.path import DEFAULT_BATCH, plan_batches
    from raytracing_course_2024_tpu_torch.ops import kernels as KN

    b, replicas = plan_batches(DEFAULT_BATCH, n_pix, spp)
    runs = shards * -(-n_pix // b) * (spp // replicas)
    depth = r.settings.ray_depth
    want = dict.fromkeys(KN.LAUNCHES, 0)
    if r.fused:
        want.update(primary=runs, bounce=runs * (depth - 2), final=runs)
        return want
    want.update(shade=runs * depth, finish=runs * (depth - 1), camera=runs)
    want[k3_key(r)] = runs * (depth - 1)
    if nearest_kernel(r):
        want[nearest_kernel(r)] = runs * depth
    return want


def expected_launches(r, n_pix: int, spp: int, shards: int, rounds, refills: int = 0) -> dict:
    """What a frame must have launched: the batch engine's plan, or per
    round one K5 (sticky) or one K1 in lane mode (counter wavefront; the
    sticky engine below one lane per pixel too) on the fused route, the
    nearest hit (K6 or K4), N1a, K3 in lane mode and N1b on the modular one;
    N2a once per refill (``refills``, the engine's count), N2b
    once per sticky round off the K5 route and once per shard for its final
    flush, and N5, off the K5 route, once per round and once per shard
    before the first (K5 ends its own rounds with the test)."""
    if r.engine == "batch":
        return batch_launches(r, n_pix, spp, shards)
    from raytracing_course_2024_tpu_torch.integrator.path import DEFAULT_BATCH
    from raytracing_course_2024_tpu_torch.ops import kernels as KN

    want = dict.fromkeys(KN.LAUNCHES, 0)
    n = int(np.sum(rounds))
    lanes = min(getattr(r, "batch_size", DEFAULT_BATCH), n_pix * spp)
    k5 = r.engine == "sticky" and r.fused and n_pix <= lanes
    if k5:
        want["persistent"] = n
    elif r.fused:
        want["bounce"] = n
    else:
        want.update(shade=n, finish=n)
        want[k3_key(r)] = 0 if r.cfg.faithful else n
        if nearest_kernel(r):
            want[nearest_kernel(r)] = n
    if r.engine == "sticky" and not k5:
        want["restart"] = n + shards
    if r.engine == "wavefront":
        want["refill"] = refills
    if not k5:
        want["loop"] = n + shards
    return want


def runtime_renderer(case: str, dev):
    """The renderer of one checkpoint case at 1280x720 (the resume process
    builds it again from the name): the Cornell frame on the fused batch path,
    on the sticky engine, on a (2, 2) mesh of ``dev`` repeated; the
    81,920-triangle BVH frame on its default engine, the counter wavefront."""
    from raytracing_course_2024_tpu_torch.parallel import make_mesh
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer, ShardedRenderer
    from raytracing_course_2024_tpu_torch.scene import load_scene

    w, h, _ = FRAME
    if case == "bvh":
        return Renderer(bvh_desc(w, h, CKPT[case]), device=dev)
    desc = load_scene(CORNELL, w, h, CKPT[case])
    if case == "sharded":
        return ShardedRenderer(desc, mesh=make_mesh(2, 2, devices=[dev] * 4))
    return Renderer(desc, device=dev, engine="sticky" if case == "sticky" else None)


def shard_geometry(r, spp: int) -> tuple:
    """(pixels, samples, shards) of each shard of a frame at ``spp``: the
    whole frame for a ``Renderer``; ``ceil(H / tiles)`` rows and ``spp /
    n_spp`` samples for each of a ``ShardedRenderer``'s shards."""
    s = r.settings
    mesh = getattr(r, "mesh", None)
    if mesh is None:
        return s.width * s.height, spp, 1
    tiles, n_spp = mesh.shape["tile"], mesh.shape["spp"]
    return -(-s.height // tiles) * s.width, spp // n_spp, tiles * n_spp


def check_chunks(case: str, c: Chunked, chunks: int) -> None:
    """Each chunk launched exactly what its engine and plan say."""
    if len(c.launches) != chunks:
        raise SystemExit(f"checkpoint {case}: {len(c.launches)} chunks rendered, not {chunks}")
    for i, got in enumerate(c.launches):
        want = expected_launches(c.r, *shard_geometry(c.r, CKPT_CHUNK), c.rounds[i],
                                 c.refills[i])
        if got != want:
            raise SystemExit(f"checkpoint {case} chunk {i}: launches {got} != {want}")


def resume_main(tmp: str) -> int:
    """``chip_smoke.py --resume DIR``: a fresh process resumes every
    ``DIR/<case>-cut.npz`` from the file alone and writes the frame and its
    chunks' launches beside it."""
    from raytracing_course_2024_tpu_torch.runtime.checkpoint import render_with_checkpoints

    if not torch.cuda.is_available():
        print("chip_smoke --resume: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    for case in CKPT:
        c = Chunked(runtime_renderer(case, dev))
        img = render_with_checkpoints(c, os.path.join(tmp, f"{case}-cut.npz"), CKPT[case],
                                      CKPT_CHUNK, seed=SEED)
        np.save(os.path.join(tmp, f"{case}-resumed.npy"), img)
        with open(os.path.join(tmp, f"{case}-resumed.json"), "w") as f:
            json.dump({"launches": c.launches, "rounds": c.rounds, "refills": c.refills,
                       "ms": c.ms}, f)
    return 0


def phase_checkpoint(dev, tmp: str, gpu: str) -> dict:
    """Each case rendered in 16-spp chunks without a break, then again with
    an exception in place of the chunk at half time, then resumed in a fresh
    process from the ``.npz`` alone: the resumed frame must equal the
    unbroken one bit for bit, and every chunk's launches must be exact. The
    Cornell checkpoint offered to the BVH renderer must raise."""
    from raytracing_course_2024_tpu_torch.runtime.checkpoint import render_with_checkpoints

    renderers, full = {}, {}
    for case, spp in CKPT.items():
        r = renderers[case] = runtime_renderer(case, dev)
        c = Chunked(r)
        full[case] = render_with_checkpoints(c, os.path.join(tmp, f"{case}-full.npz"), spp,
                                             CKPT_CHUNK, seed=SEED)
        check_chunks(case, c, spp // CKPT_CHUNK)
        stop = spp // CKPT_CHUNK // 2
        cut = Chunked(r, stop=stop)
        try:
            render_with_checkpoints(cut, os.path.join(tmp, f"{case}-cut.npz"), spp, CKPT_CHUNK,
                                    seed=SEED)
            raise SystemExit(f"checkpoint {case}: the interruption did not happen")
        except Interrupted:
            pass
        check_chunks(case, cut, stop)
        img = full[case]
        if img.shape != (FRAME[1], FRAME[0], 3) or not np.isfinite(img).all() or img.max() <= 0:
            raise SystemExit(f"checkpoint {case}: bad frame {img.shape}")
        size = os.path.getsize(os.path.join(tmp, f"{case}-full.npz"))
        say("runtime", checkpoint=case, engine=r.engine, backend=r.backend, spp=spp,
            chunk_spp=CKPT_CHUNK, chunk_ms=json.dumps([round(x, 3) for x in c.ms]).replace(
                " ", ""), ckpt_write_ms=json.dumps([round(x, 3) for x in c.between_ms + [
                    cut.between_ms[-1]]]).replace(" ", ""), ckpt_mb=round(size / 1e6, 2),
            launches_per_chunk=json.dumps(c.launches[0]).replace(" ", ""),
            rounds=json.dumps(c.rounds).replace(" ", ""), mean=round(float(img.mean()), 5),
            gpu=f'"{gpu}"')
    try:
        render_with_checkpoints(renderers["bvh"], os.path.join(tmp, "fused-full.npz"),
                                CKPT["fused"], CKPT_CHUNK, seed=SEED)
        raise SystemExit("the Cornell checkpoint resumed on the BVH renderer")
    except ValueError as e:
        say("runtime", checkpoint="cross-scene", raised=f'"{str(e)[:60]}"')

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--resume", tmp],
                          capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"the resume process failed ({proc.returncode}):\n{proc.stderr}")
    for case, spp in CKPT.items():
        img = np.load(os.path.join(tmp, f"{case}-resumed.npy"))
        with open(os.path.join(tmp, f"{case}-resumed.json")) as f:
            rec = json.load(f)
        chunks = spp // CKPT_CHUNK
        c = Chunked(renderers[case])
        c.launches, c.rounds, c.refills = rec["launches"], rec["rounds"], rec["refills"]
        check_chunks(case, c, chunks - chunks // 2)
        equal = bool(np.array_equal(img, full[case]))
        say("runtime", resume=case, fresh_process=True, chunks_resumed=len(rec["ms"]),
            bit_equal=equal, max_abs_diff=float(np.abs(img - full[case]).max()),
            process_seconds=round(secs, 2))
        if not equal:
            raise SystemExit(f"checkpoint {case}: the resumed frame differs")
    return renderers


def shard_pair(sr, single: np.ndarray, seed: int, spp: int, what: str, gpu: str) -> None:
    """One sharded frame against the single-device frame of the same seed:
    every pixel within rtol 1e-4 / atol 1e-5, launches = the sum over the
    shards (counters set to 0 just before the frame, read just after)."""
    from raytracing_course_2024_tpu_torch.ops import kernels as KN

    sr.render_radiance(seed=seed + 1, samples=spp)  # warm-up: allocator
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    img = sr.render_radiance(seed=seed, samples=spp)
    ms = (time.perf_counter() - t0) * 1e3
    got = dict(KN.LAUNCHES)
    want = expected_launches(sr, *shard_geometry(sr, spp), sr.rounds, refills_run())
    close = bool(np.allclose(img, single, rtol=SHARD_RTOL, atol=SHARD_ATOL))
    say("runtime", shard=what, mesh=f"{sr.mesh.shape['tile']}x{sr.mesh.shape['spp']}",
        engine=sr.engine, spp=spp, ms=round(ms, 3), allclose=close,
        max_abs_err=float(np.abs(img - single).max()),
        launches=json.dumps({k: v for k, v in got.items() if v}).replace(" ", ""),
        rounds=json.dumps(sr.rounds).replace(" ", ""), gpu=f'"{gpu}"')
    if not close:
        raise SystemExit(f"shard {what}: the sharded frame differs from the single-device one")
    if got != want:
        raise SystemExit(f"shard {what}: launches {got} != {want}")


def single_frame(r, seed: int, spp: int, what: str, gpu: str) -> np.ndarray:
    r.render_radiance(seed=seed + 1, samples=spp)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = r.render_radiance(seed=seed, samples=spp)
    say("runtime", shard=what, mesh="single", engine=r.engine, spp=spp,
        ms=round((time.perf_counter() - t0) * 1e3, 3), gpu=f'"{gpu}"')
    return img


def phase_shard(dev, gpu: str, bvh_single) -> None:
    """The Cornell frame at 16 spp on meshes (2,1), (1,2), (2,2) of one card
    repeated, on all three engines, and the BVH frame at 4 spp on (2, 2) on
    its default engine, each against the single-device frame: on one card the
    ms are the sharding's overhead, not a speed-up."""
    from raytracing_course_2024_tpu_torch.parallel import make_mesh
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer, ShardedRenderer
    from raytracing_course_2024_tpu_torch.scene import load_scene

    w, h, spp = FRAME
    desc = load_scene(CORNELL, w, h, spp)
    for engine in ("batch", "sticky", "wavefront"):
        single = single_frame(Renderer(desc, device=dev, engine=engine), SEED, spp,
                              f"cornell-{engine}", gpu)
        for shape in SHARD_MESHES:
            sr = ShardedRenderer(desc, mesh=make_mesh(*shape, devices=[dev] * 4), engine=engine)
            shard_pair(sr, single, SEED, spp, f"cornell-{engine}", gpu)
    bdesc = bvh_desc(w, h, SHARD_BVH_SPP)
    what = f"bvh81920-{BVH_DEFAULT_ENGINE}"
    single = single_frame(bvh_single, SEED, SHARD_BVH_SPP, what, gpu)
    sr = ShardedRenderer(bdesc, mesh=make_mesh(2, 2, devices=[dev] * 4))
    if sr.engine != BVH_DEFAULT_ENGINE or sr.backend != "bvh":
        raise SystemExit(f"the sharded BVH frame took {sr.backend}/{sr.engine}")
    shard_pair(sr, single, SEED, SHARD_BVH_SPP, what, gpu)


def phase_trace(dev, tmp: str) -> None:
    """``device_trace`` around one Cornell fused frame: the Chrome trace must
    name K2 (``primary_kernel``) 16 times and K1 (``bounce_kernel``) 80 times
    (64 + 16 final)."""
    from raytracing_course_2024_tpu_torch.runtime.profiling import device_trace
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer
    from raytracing_course_2024_tpu_torch.scene import load_scene

    w, h, spp = FRAME
    r = Renderer(load_scene(CORNELL, w, h, spp), device=dev)
    r.render_frame_device(seed=1)  # warm-up
    log_dir = os.path.join(tmp, "trace")
    with device_trace(log_dir) as prof:
        r.render_frame_device(seed=SEED)
    path = os.path.join(log_dir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    counts = {k: sum(k in e.get("name", "") for e in kern)
              for k in ("primary_kernel", "bounce_kernel")}
    device_ms = sum(e.get("dur", 0) for e in kern) / 1e3
    say("runtime", trace=os.path.basename(path), mb=round(os.path.getsize(path) / 1e6, 3),
        kernel_events=len(kern), named=json.dumps(counts).replace(" ", ""),
        device_ms=round(device_ms, 3), profiler_rows=len(prof.key_averages()))
    if counts != {"primary_kernel": spp, "bounce_kernel": spp * 5}:
        raise SystemExit(f"the trace names {counts}, not 16 K2 and 80 K1")


def phase_runtime(dev, gpu: str) -> None:
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        renderers = phase_checkpoint(dev, tmp, gpu)
        phase_shard(dev, gpu, renderers["bvh"])
        phase_trace(dev, tmp)
    say("runtime", seconds=round(time.perf_counter() - t0, 2))


MP_TIMEOUT = 300  # seconds for one [multiproc] world, its scenes' build included
MP_ENGINES = ("batch", "sticky", "wavefront")
LAUNCHER_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                 "MASTER_PORT", "GROUP_RANK", "TORCHELASTIC_USE_AGENT_STORE")


def mp_cases(mode: str) -> dict:
    """name -> (scene, engine, spp) of a [multiproc] world: the Cornell frame
    on the batch engine (``nccl``), or on the three engines and the BVH frame
    on its default engine (``gloo``, ``cards``)."""
    from raytracing_course_2024_tpu_torch.scene import load_scene

    w, h, spp = FRAME
    desc = load_scene(CORNELL, w, h, spp)
    cases = {f"cornell-{e}": (desc, e, spp) for e in MP_ENGINES}
    if mode == "nccl":
        return {"cornell-batch": cases["cornell-batch"]}
    cases[f"bvh81920-{BVH_DEFAULT_ENGINE}"] = (bvh_desc(w, h, SHARD_BVH_SPP), None,
                                               SHARD_BVH_SPP)
    return cases


def mp_worker(mode: str, tmp: str, store: str, world: int, rank: int) -> int:
    """``chip_smoke.py --mp-worker MODE DIR STORE WORLD RANK``: one process of
    a [multiproc] world over the file store STORE, on a (WORLD, 1) multihost
    mesh of ``local_cards()``. ``nccl``: a group of one over NCCL on card 0;
    ``gloo``: one of two processes on the one card, ``cards``: one process
    per card (``init_distributed`` picks gloo or NCCL from that layout, as a
    launcher's ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` give it). Each case renders
    once to warm up, then once timed with the launch counters set to 0 just
    before and read just after; ``combine_ms`` is the host time of the
    collectives that join the processes' tiles (``parallel/shard.py:_combine``,
    from a synchronised card: the copies of the tiles, the wait for the other
    process, the gather). Writes DIR/MODE-RANK.json and, on process 0, each
    frame to DIR/MODE-CASE.npy."""
    import torch.distributed as dist

    from raytracing_course_2024_tpu_torch.ops import kernels as KN
    from raytracing_course_2024_tpu_torch.parallel import init_distributed, make_multihost_mesh
    from raytracing_course_2024_tpu_torch.parallel import shard
    from raytracing_course_2024_tpu_torch.runtime.render import ShardedRenderer

    if not torch.cuda.is_available():
        print("chip_smoke --mp-worker: no CUDA device", file=sys.stderr)
        return 1
    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    if world == 1:  # init_distributed starts no group of one
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=store, world_size=world, rank=rank)
    elif not init_distributed(store, world, rank):
        raise SystemExit("init_distributed started no group")
    combine, combine_ms = shard._combine, []

    def timed_combine(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = combine(*args)
        combine_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    shard._combine = timed_combine
    mesh = make_multihost_mesh(world, 1)
    rec = {"backend": dist.get_backend(), "world": dist.get_world_size(),
           "mesh": [[str(d) for d in row] for row in mesh.devices], "ranks": mesh.ranks}
    for name, (desc, engine, spp) in mp_cases(mode).items():
        sr = ShardedRenderer(desc, mesh=mesh, engine=engine)
        sr.render_radiance(seed=SEED + 1, samples=spp)  # warm-up: allocator
        torch.cuda.synchronize()
        dist.barrier()
        combine_ms.clear()
        reset_counts()
        t0 = time.perf_counter()
        img, stats = sr.render_radiance(seed=SEED, samples=spp, with_stats=True)
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(KN.LAUNCHES)
        rec[name] = {"ms": ms, "combine_ms": sum(combine_ms),
                     "launches": launches, "refills": refills_run(),
                     "rounds": sr.rounds, "verts": stats.path_vertices, "engine": sr.engine,
                     "backend": sr.backend}
        if rank == 0:
            np.save(os.path.join(tmp, f"{mode}-{name}.npy"), img)
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"{mode}-{rank}.json"), "w") as f:
        json.dump(rec, f)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
    if leaked:
        raise SystemExit(f"the port imported {leaked}")
    return 0


def launcher_env() -> dict:
    """This environment without a launcher's variables, the repo importable."""
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_VARS}
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [ROOT, env.get("PYTHONPATH")]))
    return env


def wait_all(procs: list, logs: list, what: str) -> None:
    """Wait for every process (each in a session of its own) within
    ``MP_TIMEOUT``; at the first non-zero exit, or at the timeout, kill every
    session and fail with that process's output."""
    deadline = time.monotonic() + MP_TIMEOUT
    try:
        while True:
            codes = [p.poll() for p in procs]
            for i, code in enumerate(codes):
                if code not in (None, 0):
                    raise SystemExit(f"{what}: process {i} exited {code}:\n"
                                     + open(logs[i]).read()[-3000:])
            if None not in codes:
                return
            if time.monotonic() > deadline:
                i = codes.index(None)
                raise SystemExit(f"{what}: process {i} still ran after {MP_TIMEOUT} s:\n"
                                 + open(logs[i]).read()[-3000:])
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()


def run_world(mode: str, world: int, tmp: str) -> list:
    """The ``world`` processes of a [multiproc] world; their records by rank."""
    store = "file://" + os.path.join(tmp, f"{mode}.store")
    procs, logs = [], []
    for rank in range(world):
        logs.append(os.path.join(tmp, f"{mode}-{rank}.log"))
        with open(logs[-1], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mp-worker", mode, tmp, store,
                 str(world), str(rank)], stdout=f, stderr=subprocess.STDOUT, env=launcher_env(),
                start_new_session=True))
    wait_all(procs, logs, f"multiproc {mode}")
    recs = []
    for rank in range(world):
        with open(os.path.join(tmp, f"{mode}-{rank}.json")) as f:
            recs.append(json.load(f))
    return recs


def mp_check(dev, tmp: str, gpu: str, mode: str, recs: list, cells: list) -> None:
    """Each frame of a world against the single-process frame of the same
    mesh on ``cells`` (its devices by tile: bit for bit) and against the
    single-device frame on ``dev`` (rtol 1e-4 / atol 1e-5); the ranks'
    launches summed against the shards'."""
    from raytracing_course_2024_tpu_torch.parallel import make_mesh
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer, ShardedRenderer

    world, backend = recs[0]["world"], recs[0]["backend"]
    if backend != ("gloo" if mode == "gloo" else "nccl") or len(recs) != world:
        raise SystemExit(f"multiproc {mode}: {len(recs)} records, world {world}, {backend}")
    def timed(r, spp):
        r.render_radiance(seed=SEED + 1, samples=spp)  # warm-up, as in the workers
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = r.render_radiance(seed=SEED, samples=spp)
        return img, (time.perf_counter() - t0) * 1e3

    for name, (desc, engine, spp) in mp_cases(mode).items():
        single, single_ms = timed(Renderer(desc, device=dev, engine=engine), spp)
        sr = ShardedRenderer(desc, mesh=make_mesh(world, 1, devices=cells), engine=engine)
        ref, ref_ms = timed(sr, spp)
        img = np.load(os.path.join(tmp, f"{mode}-{name}.npy"))
        got = {k: sum(r[name]["launches"][k] for r in recs) for k in recs[0][name]["launches"]}
        rounds = recs[0][name]["rounds"]
        want = expected_launches(sr, *shard_geometry(sr, spp), rounds,
                                 sum(r[name]["refills"] for r in recs))
        bit = bool(np.array_equal(img, ref))
        close = bool(np.allclose(img, single, rtol=SHARD_RTOL, atol=SHARD_ATOL))
        say("multiproc", case=name, world=world, backend=backend, engine=recs[0][name]["engine"],
            scene_backend=recs[0][name]["backend"], spp=spp,
            ms=round(recs[0][name]["ms"], 3),
            ms_ranks=json.dumps([round(r[name]["ms"], 3) for r in recs]).replace(" ", ""),
            combine_ms=json.dumps([round(r[name]["combine_ms"], 3) for r in recs]).replace(
                " ", ""),
            one_process_ms=round(ref_ms, 3), one_device_ms=round(single_ms, 3),
            bit_equal=bit, allclose=close,
            max_abs_err=float(np.abs(img - single).max()),
            verts=recs[0][name]["verts"],
            launches=json.dumps({k: v for k, v in got.items() if v}).replace(" ", ""),
            rounds=json.dumps(rounds).replace(" ", ""), gpu=f'"{gpu}"')
        if not (bit and close):
            raise SystemExit(f"multiproc {mode} {name}: bit_equal={bit} allclose={close}")
        if recs[0][name]["backend"] != ("bvh" if name.startswith("bvh") else "dense"):
            raise SystemExit(f"multiproc {mode} {name}: {recs[0][name]['backend']} backend")
        if rounds != sr.rounds or any(r[name]["rounds"] != rounds for r in recs):
            raise SystemExit(f"multiproc {mode} {name}: rounds {rounds} != {sr.rounds}")
        if got != want:
            raise SystemExit(f"multiproc {mode} {name}: launches {got} != {want}")


def mp_cli(dev, tmp: str, gpu: str) -> None:
    """The CLI under ``python -m torch.distributed.run --standalone
    --nproc-per-node 2`` on the Cornell frame: one PPM (and its PNG and
    out.log), from process 0, equal to the single-process (2, 1) frame."""
    from raytracing_course_2024_tpu_torch.parallel import make_mesh
    from raytracing_course_2024_tpu_torch.runtime.image_io import read_png, read_ppm
    from raytracing_course_2024_tpu_torch.runtime.render import ShardedRenderer
    from raytracing_course_2024_tpu_torch.scene import load_scene

    w, h, spp = FRAME
    cwd = os.path.join(tmp, "cli")
    os.makedirs(cwd)
    log = os.path.join(tmp, "cli.log")
    t0 = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
             "2", "-m", "raytracing_course_2024_tpu_torch", CORNELL, str(w), str(h), str(spp),
             "out.ppm", "out"], cwd=cwd, stdout=f, stderr=subprocess.STDOUT,
            env=launcher_env(), start_new_session=True)
        wait_all([proc], [log], "multiproc cli")
    secs = time.perf_counter() - t0
    out = open(log).read()
    files = sorted(os.listdir(cwd))
    if files != ["out.log", "out.png", "out.ppm"]:
        raise SystemExit(f"multiproc cli wrote {files}")
    img = read_ppm(os.path.join(cwd, "out.ppm"))
    ref = ShardedRenderer(load_scene(CORNELL, w, h, spp),
                          mesh=make_mesh(2, 1, devices=[dev] * 2)).render_u8(0)
    equal = bool(np.array_equal(img, ref))
    backend = re.findall(r"Processes: 2, backend: (\w+)", out)
    took = re.findall(r"Rendering took ([\d.]+)s", out)
    say("multiproc", cli="torch.distributed.run", nproc=2, backend=",".join(backend),
        size=f"{w}x{h}",
        spp=spp, seconds=round(secs, 2), rendering_s=",".join(took), files=",".join(files),
        equal_to_one_process=equal, mean_u8=round(float(img.mean()), 3), gpu=f'"{gpu}"')
    if backend != ["gloo"] or len(took) != 1:
        raise SystemExit(f"multiproc cli: backend {backend}, render lines {took}:\n{out[-3000:]}")
    if not equal or not np.array_equal(img, read_png(os.path.join(cwd, "out.png"))):
        raise SystemExit("multiproc cli: the image is not the single-process (2, 1) frame")


def cards_main() -> int:
    """``chip_smoke.py --cards``: the multiproc phase across every card of
    the machine (two or more), one process per card over NCCL, against the
    one-process frame of the same cards (one thread per card) and the
    single-card frame. Prints every card's name and power limit."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"chip_smoke --cards: {n} CUDA devices, needs 2 or more", file=sys.stderr)
        return 1
    from raytracing_course_2024_tpu_torch.ops import kernels

    kernels.library()
    gpus = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mp_check(torch.device("cuda", 0), tmp, gpus[0], "cards", run_world("cards", n, tmp),
                 [torch.device("cuda", i) for i in range(n)])
    say("multiproc", cards=n, seconds=round(time.perf_counter() - t0, 2))
    for line in gpus:
        print(line, flush=True)
    return 0


def phase_multiproc(dev, gpu: str) -> None:
    """Rendering across processes on the one card: a group of one over NCCL
    (its init and collectives on the card), two processes over gloo (the
    tiles through host memory), and the CLI under ``torch.distributed.run``.
    On one card these measure the cost of the processes and check the
    frames; they are no speed-up."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()  # room for the workers
    with tempfile.TemporaryDirectory() as tmp:
        recs = {mode: run_world(mode, world, tmp) for mode, world in (("nccl", 1), ("gloo", 2))}
        mp_cli(dev, tmp, gpu)
        for mode, r in recs.items():
            mp_check(dev, tmp, gpu, mode, r, [dev] * len(r))
    say("multiproc", seconds=round(time.perf_counter() - t0, 2))


def phase_timing(dev, gpu: str, counts: dict, errs: dict, m: Modular, k5, bvh: dict,
                 n1: dict, lane: dict) -> list:
    from raytracing_course_2024_tpu_torch.ops import bounce as B
    from raytracing_course_2024_tpu_torch.ops.persistent import persistent_plain
    from raytracing_course_2024_tpu_torch.ops.dense_nearest import dense_nearest_plain
    from raytracing_course_2024_tpu_torch.ops.sampler import sampler_plain
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer
    from raytracing_course_2024_tpu_torch.scene import load_scene

    w, h, spp = FRAME
    desc = load_scene(CORNELL, w, h, spp)
    frame_times(Renderer(desc, device=dev), "fused-kernels", gpu)
    frame_times(Renderer(desc, device=dev, plain=True), "fused-plain", gpu, reps=1)
    frame_times(Renderer(desc, device=dev, russian_roulette=True), "modular-kernels-rr", gpu)
    frame_times(Renderer(desc, device=dev, engine="sticky"), "sticky-fused-kernels", gpu)
    frame_times(Renderer(desc, device=dev, engine="wavefront"), "wavefront-kernels", gpu)

    # the main path's shapes: one 921,600-lane batch of the Cornell frame
    r = Renderer(desc, device=dev)
    scene, cam, bg = r.scene, r.cam_row, r.bg
    n = w * h
    idx = torch.arange(n, device=dev, dtype=torch.int32)
    px, py = (idx % w).float(), (idx // w).float()
    # kernel vs plain at the main path's shapes, from the same inputs
    seed_t, off_t = route_pair(1, 0, dev)
    st0 = B.primary_bounce(scene, cam, px, py, idx, off_t, seed_t, bg, K, w, h)
    p0 = B.primary_plain(scene, cam, px, py, idx, 0, 1, bg, K, w, h)
    k1 = B.bounce(scene, p0.clone(), idx, off_t, seed_t, 1, bg, K)
    p1 = B.bounce_plain(scene, p0, idx, 0, 1, 1, bg, K)
    kf = B.bounce(scene, p1.clone(), idx, off_t, seed_t, 5, bg, K, final_only=True)
    pf = B.bounce_plain(scene, p1, idx, 0, 1, 5, bg, K, final_only=True)
    torch.cuda.synchronize()
    for k, a, b in (("primary", st0, p0), ("bounce", k1, p1), ("final", kf, pf)):
        errs[k] = max(errs.get(k, 0.0),
                      compare_states(a, b, f"cornell-{w}x{h}:{k}")["max_abs_err"])
    # K5's input: the Cornell frame's state after K5_CHAIN rounds at 16 spp,
    # the last state the kernel phase held K5 against
    tri = m.scene.tri_pack
    ins, st5, args5 = k5
    launch_ms, fresh_ms, modular = launch_times(scene, cam, bg, st0, idx, w, h, m, k5, gpu=gpu)
    separate_k1(dev, gpu, scene, bg, st0, idx)
    persistent_rounds(dev, gpu, desc)
    modular_levels(m, gpu, 20)
    plain_ms = {
        "primary": cuda_ms(lambda: B.primary_plain(
            scene, cam, px, py, idx, 0, 1, bg, K, w, h), 2),
        "bounce": cuda_ms(lambda: B.bounce_plain(scene, st0, idx, 0, 1, 1, bg, K), 2),
        "final": cuda_ms(lambda: B.bounce_plain(
            scene, st0, idx, 0, 1, 1, bg, K, final_only=True), 2),
        "nearest": cuda_ms(lambda: dense_nearest_plain(m.ro, m.rd, tri, live=m.alive), 2),
        "sampler": cuda_ms(lambda: sampler_plain(*m.sampler_args), 2),
        "persistent": cuda_ms(lambda: persistent_plain(*ins, st5, *args5), 2),
    }
    # least time for the same work: bytes (each input a lane needs read once,
    # each output written once) or fp32 operations; the fused kernels'
    # operations count the intersection loop only (sampler, shading and BRDF
    # left out). K1's, K1-final's and K5's bytes are those of the in-place
    # launch that ``ms`` times, lane case by lane case (``bounce_bytes``,
    # ``persistent_bytes``); ``ms_fresh_buffer`` has its own bound beside it.
    # K3 reads the 13 input rows and the work id only where ``need`` holds
    # (56 B), the need flag everywhere, and writes l, pdf and ok. K4 reads
    # the live flag and writes t and idx everywhere (9 B), and reads the ray
    # (24 B) and walks the triangles only where the flag holds.
    alive = float((st0[12] > 0.5).sum())
    need = float(m.need.sum())

    def nearest_bound(live):
        return bound(n * (1 + 8) + live * 24 + tri.numel() * 4, live * tri.shape[1] * OPS_TRI_K4)

    def sampler_bound(need_n, bounce_i):
        return bound(n * (1 + 16 + 1) + need_n * (52 + 4) + ltable, sampler_ops(m, bounce_i))

    n_geo = scene.geo.shape[1]
    # the scene as the function needs it: the (35, M) table, a spec word per
    # entry, the light table (the kernels' loop records repeat table columns)
    table = (scene.geo.numel() + n_geo + scene.lp.numel() + scene.lspec.numel()) * 4
    ltable = (m.scene.light_packed.numel() + m.scene.lspec.numel()) * 4
    kmax5 = ins[4]
    live5 = float(((st5[12] > 0.5) | (st5[13] < kmax5)).sum())  # alive after the restart
    fused_bytes = {"primary": n * (12 + 52) + table,
                   "bounce": bounce_bytes(n, alive, False, True) + table,
                   "final": bounce_bytes(n, alive, True, True) + table,
                   "persistent": persistent_bytes(st5, kmax5) + table}
    fused_live = {"primary": n, "bounce": alive, "final": alive, "persistent": live5}
    per_live = n_geo * OPS_TRI_FUSED + OPS_WINNER_NORMAL
    bounds = {k: bound(fused_bytes[k], fused_live[k] * per_live) for k in fused_bytes}
    fresh_bounds = {k: bound(bounce_bytes(n, alive, k == "final", False) + table,
                             alive * per_live) for k in ("bounce", "final")}
    bounds.update({"nearest": nearest_bound(float(n)), "sampler": sampler_bound(need, 0)})
    # the same two on the bounce-1 state: incoherent rays, fewer lanes at work
    k4_b1 = "nearest-bounce1-masked"
    bounce1 = {"nearest": (modular[k4_b1], nearest_bound(float(m.alive1.sum()))),
               "sampler": (modular["sampler-bounce1"], sampler_bound(float(m.need1.sum()), 1))}
    for k in fused_bytes:  # the bound as it was counted while the loop made every normal
        was = bound(fused_bytes[k], fused_live[k] * n_geo * OPS_TRI_FUSED_OLD)
        say("timing", kernel=k, bound_ms=round(bounds[k][0], 5), bound_by=bounds[k][1],
            bound_ms_normal_per_entry=round(was[0], 5), bound_by_then=was[1])
    inputs = {"primary": 1.0, "bounce": alive / n, "final": alive / n,
              "nearest": 1.0, "sampler": float(m.need.float().mean()),
              "persistent": live5 / n}
    # K6 on the BVH frame (phase_timing_bvh): the camera state as the main
    # path launches it, the bounce-1 state beside it
    cam6, b1 = bvh["k6"]["camera"], bvh["k6"]["bounce1"]
    launch_ms["bvh"], plain_ms["bvh"], bounds["bvh"] = cam6["ms"], bvh["plain_ms"], cam6["bound"]
    inputs["bvh"] = cam6["active_in"]
    bounce1["bvh"] = (b1, b1["bound"])
    # N1a and N1b on the BVH frame's states, as K6
    n1_ms = shade_times(n1, gpu)
    deep = {}  # N1a and N1b on the bounce-3 state too
    for k in ("shade", "finish"):
        cam_k, b1_k = n1_ms["camera"][k], n1_ms["bounce1"][k]
        launch_ms[k], plain_ms[k], bounds[k] = cam_k["ms"], cam_k["plain_ms"], cam_k["bound"]
        inputs[k] = cam_k["active_in"]
        bounce1[k] = (b1_k, b1_k["bound"])
        deep[k] = n1_ms[f"bounce{N1_DEEP}"][k]
    # N2a and N2b on the BVH lane engines' round-10 states (phase_kernels_round),
    # K3 above 32 lights on practice6_1's (phase_kernels_many)
    for k in ("refill", "restart", "sampler_many"):
        launch_ms[k], plain_ms[k] = lane[k]["ms"], lane[k]["plain_ms"]
        bounds[k], inputs[k] = lane[k]["bound"], lane[k]["active_in"]
    # N4 on the Cornell frame's 921,600 lanes
    cam_t = camera_times(dev)
    launch_ms["camera"], plain_ms["camera"], bounds["camera"] = (
        cam_t["ms"], cam_t["plain_ms"], cam_t["bound"])
    inputs["camera"] = 1.0
    # N5 alone on the lane engines' 1,048,576 lanes and on 262,144; its fused
    # tail on the Cornell lane frames' round-10 states
    loop_t = loop_times(dev)
    launch_ms["loop"], plain_ms["loop"], bounds["loop"] = (
        loop_t["ms"], loop_t["plain_ms"], loop_t["bound"])
    inputs["loop"] = loop_t["active_in"]
    tails = tail_times(dev, desc, gpu)
    loop_extra = {f"{k}{at}": v for at in ("", "_262144")
                  for k, v in (("ms_sticky", loop_t["ms_sticky" + at]),
                               ("plain_ms_sticky", loop_t["plain_ms_sticky" + at]),
                               ("bound_ms_sticky", loop_t["bound_sticky" + at][0]))}
    loop_extra.update(ms_262144=loop_t["ms_262144"], plain_ms_262144=loop_t["plain_ms_262144"],
                      bound_ms_262144=loop_t["bound_262144"][0])
    for name, t in tails.items():
        loop_extra.update({f"{key}_{name}": t[key] for key in ("ms", "plain_ms", "aten_ms")},
                          **{f"bound_ms_{name}": t["bound"][0]})
    k3_lane = lane["sampler-lane"]
    for k in KERNELS:
        # K5's input: the frame's state after K5_CHAIN rounds
        at = {"after_rounds": K5_CHAIN} if k == "persistent" else {}
        if k in fresh_ms:
            at["ms_fresh_buffer"] = round(fresh_ms[k], 4)
        if k in fresh_bounds:
            at["bound_ms_fresh_buffer"] = round(fresh_bounds[k][0], 5)
        if k in bounce1:
            case, (b_ms, b_by) = bounce1[k]
            at.update(ms_bounce1=round(case["ms"], 4), active_in_bounce1=round(
                case["active_in"], 4), bound_ms_bounce1=round(b_ms, 5), bound_by_bounce1=b_by)
        if k in deep:
            at.update(ms_bounce3=round(deep[k]["ms"], 4),
                      active_in_bounce3=round(deep[k]["active_in"], 4),
                      bound_ms_bounce3=round(deep[k]["bound"][0], 5))
        if k == "nearest":
            at["ms_no_mask"] = round(modular["nearest-camera"]["ms"], 4)
        if k == "sampler_many":
            at.update(many_geometry())
        if k == "loop":
            at.update(skipped_round_ms=round(loop_t["skipped_round_ms"], 5),
                      guarded_round_ms=round(loop_t["guarded_round_ms"], 5),
                      **{key: round(v, 5) for key, v in loop_extra.items()})
        say("timing", kernel=k, lanes=lane[k]["lanes"] if k in lane else (
            loop_t["lanes"] if k == "loop" else n), **at,
            active_in=round(inputs[k], 4),
            ms=round(launch_ms[k], 4), plain_ms=round(plain_ms[k], 3),
            bound_ms=round(bounds[k][0], 5), bound_by=bounds[k][1], gpu=f'"{gpu}"')
    tol = f"atol=rtol={ATOL} on >= {LANE_FRAC:.1%} of lanes"
    return [
        {"name": k, "route": "cuda", "source": KERNELS[k][1], "replaces": KERNELS[k][0],
         "launches": counts[k], "max_abs_err": errs[k], "ms": launch_ms[k],
         "plain_ms": plain_ms[k], "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
         "library_ms": None, "tolerance": tol, "lanes": n, "graphed": GRAPHED[k],
         **({"ms_fresh_buffer": fresh_ms[k]} if k in fresh_ms else {}),
         **({"bound_ms_fresh_buffer": fresh_bounds[k][0]} if k in fresh_bounds else {}),
         **({"ms_bounce1": bounce1[k][0]["ms"], "bound_ms_bounce1": bounce1[k][1][0],
             "active_in": inputs[k], "active_in_bounce1": bounce1[k][0]["active_in"]}
            if k in bounce1 else {}),
         **({"ms_bounce3": deep[k]["ms"], "bound_ms_bounce3": deep[k]["bound"][0],
             "active_in_bounce3": deep[k]["active_in"]} if k in deep else {}),
         **({"ms_lane_mode": k3_lane["ms"], "bound_ms_lane_mode": k3_lane["bound"][0],
             "max_abs_err_lane_mode": k3_lane["max_abs_err"],
             "max_rel_err_lane_mode": k3_lane["max_rel_err"],
             "bound_by_lane_mode": k3_lane["bound"][1], "launches_lane_mode": k3_lane["launches"],
             "active_in_lane_mode": k3_lane["active_in"]} if k == "sampler" else {}),
         **({"state": ROUND_TIMED, "tolerance": "bit for bit on every lane",
             "lanes": lane[k]["lanes"]} if k in ("refill", "restart") else {}),
         **({"state": ROUND_TIMED, "lanes": lane[k]["lanes"], **many_geometry(),
             "max_rel_err": lane[k]["max_rel_err"],
             "bound_note": "the walk of the lights' tree not counted (mixture_ops)"}
            if k == "sampler_many" else {}),
         **({"tolerance": "bit for bit on every lane and row"} if k == "camera" else {}),
         **({"tolerance": "bit for bit (counters, alive, depth and ray rows)",
             "lanes": loop_t["lanes"], **loop_extra} if k == "loop" else {})}
        for k in KERNELS
    ]


# the graphs phase: the modular route and the lane engines' rounds replayed
# from captured CUDA graphs against the same frames launched op by op
GRAPH_CASES = {  # case -> (scene, engine, roulette, lanes (None: the default), entries)
    "bvh-batch": ("bvh", "batch", False, None, 1),
    "cornell-modular-rr": ("cornell", "batch", True, None, 1),
    "bvh-wavefront": ("bvh", "wavefront", False, None, 1),  # its loop: refill, core, N5
    "bvh-sticky": ("bvh", "sticky", False, None, 1),
    "cornell-batch-fused": ("cornell", "batch", False, None, 1),
    "cornell-wavefront-fused": ("cornell", "wavefront", False, None, 1),
    # fewer lanes than pixels: the fused StickyBody (K1 in lane mode), not K5
    "cornell-sticky-fused-262144": ("cornell", "sticky", False, 262_144, 1),
    # the K5 loop, in guarded rounds
    "cornell-sticky-k5": ("cornell", "sticky", False, None, 1),
}
GRAPH_SAMP_BASE = 16  # the second samp_base of a case: the next 16 samples
PROFILED = ("bvh-batch", "cornell-batch-fused", "cornell-wavefront-fused")


GAP_US = 20.0  # a device gap shorter than this is a graph's node after node


def device_gaps(prof) -> dict:
    """The card's idle time inside a profiled window: the span from its
    first device event's start to its last one's end, and the gaps between
    device events in it (events merged where they overlap), split at
    ``GAP_US``: short gaps (a graph's nodes one after another, a launch
    queued behind the last) and long ones (the card waiting on the host).
    Counts and ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return {}
    first, end = spans[0][0], spans[0][1]
    gaps = {"short": [0, 0.0], "long": [0, 0.0]}
    for a, b in spans[1:]:
        if a > end:
            g = gaps["short" if a - end < GAP_US else "long"]
            g[0] += 1
            g[1] += (a - end) / 1e3
        end = max(end, b)
    return {"span_ms": (end - first) / 1e3, "short_gaps": gaps["short"][0],
            "short_gap_ms": gaps["short"][1], "long_gaps": gaps["long"][0],
            "long_gap_ms": gaps["long"][1]}


def profiled_frame(r, seed: int) -> dict:
    """One frame of ``r`` under torch.profiler (device events only): wall
    ms, summed device ms, busy share, device launches, path vertices, the
    rows (device ms, count, name), largest first, the card's idle time
    inside the frame (``device_gaps``), and ``image_sha``, the
    first 16 hex digits of the SHA-256 of the image's bytes (taken after the
    profiled window), which two trees' frames of one seed share when their
    images are equal bit for bit."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        outs, verts = r.render_frame_device(seed=seed)
        wall = (time.perf_counter() - t0) * 1e3
    img = torch.cat(list(outs), dim=1).cpu().numpy()
    rows = []
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
    return {"wall_ms": wall, "device_ms": busy, "busy_share": busy / wall,
            "launches": sum(n for _, n, _ in rows), "path_vertices": verts, "rows": rows,
            "gaps": device_gaps(prof),
            "image_sha": hashlib.sha256(img.tobytes()).hexdigest()[:16]}


def graph_frame(r, seed: int, samp_base: int = 0) -> dict:
    """One frame of ``r`` with the launch counters set to 0 just before and
    read just after: (3, pixels) image on the host, path vertices, rounds,
    launches, host ms (ending in a device sync). ``samp_base`` > 0 renders
    samples ``samp_base ..`` through the integrators with the renderer's
    graph cache, as a shard or a chunk does."""
    from raytracing_course_2024_tpu_torch.integrator.path import render_batches
    from raytracing_course_2024_tpu_torch.integrator.wavefront import (
        render_wavefront, render_wavefront_sticky)
    from raytracing_course_2024_tpu_torch.ops import kernels as KN

    s = r.settings
    w, h, spp = s.width, s.height, s.samples
    seed32 = (seed * 2654435761) & 0xFFFFFFFF
    torch.cuda.synchronize()
    KN.reset_launches()
    t0 = time.perf_counter()
    rounds = 0
    if samp_base == 0:
        outs, verts = r.render_frame_device(seed=seed)
        rounds = r.rounds
    elif r.engine == "batch":
        outs, verts = render_batches(r.scene, seed32, r.cam_row, r.cfg, w, h, spp, r.batch_size,
                                     samp_base=samp_base, graphs=r.graphs)
        verts = float(verts)
    else:
        render = render_wavefront_sticky if r.engine == "sticky" else render_wavefront
        img, verts, rounds = render(seed32, 0, samp_base, r.cam, r.scene, r.cfg, w, h, w * h,
                                    spp, min(r.batch_size, w * h * spp), graphs=r.graphs)
        outs = [img]
    img = torch.cat(outs, dim=1)[:, :w * h].cpu()
    ms = (time.perf_counter() - t0) * 1e3
    return {"img": img, "verts": verts, "rounds": rounds, "launches": dict(KN.LAUNCHES),
            "ms": ms}


def same_frame(a: dict, b: dict) -> bool:
    return (torch.equal(a["img"], b["img"]) and a["verts"] == b["verts"]
            and a["rounds"] == b["rounds"] and a["launches"] == b["launches"])


# ATen ops one sample of the modular route may dispatch beside its kernels:
# the path-vertex sums per level, the live mask, the accumulation (12 on the
# BVH frame's 4 levels, 16 on Cornell's 6 with N4 in place, on an H100;
# PERF.md), and a small margin. The camera stage's hashing and rays were ~115
# more before N4, and before N1 the shade and finish work alone was ~430
# per level on the Cornell scene (PERF.md).
SAMPLE_OPS_MAX = 20


def aten_ops(fn) -> dict:
    """ATen ops one call of ``fn`` dispatches, by name: every op that computes
    on the device, views and allocations left out (what a CUDA graph of the
    call replays beside the kernels of ``ops/kernels.py``, which are not
    ATen ops)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    counts: dict = {}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            view = any(r.alias_info is not None and not r.alias_info.is_write
                       for r in func._schema.returns)
            name = str(func)
            if not view and not name.startswith("aten.empty"):
                counts[name] = counts.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return counts


def sample_ops(r) -> dict:
    """``aten_ops`` of one sample of ``r``'s modular batch route, its
    ``SampleBody`` called once without a graph on the frame's first batch."""
    from raytracing_course_2024_tpu_torch.integrator import path as P

    s = r.settings
    n = min(r.batch_size, s.width * s.height)
    wid = torch.arange(n, device=r.device, dtype=torch.int32)
    body, run = P.sample_body(r.scene, r.cam_row, r.cfg, s.width, s.height, n)
    body.load(1, wid, (wid % s.width).float(), (wid // s.width).float())
    body.at(0)
    run()  # warm-up: the kernel library, the allocator
    ops = aten_ops(run)
    torch.cuda.synchronize()
    return ops


# ATen ops one round of a lane engine on a ModularScene may dispatch beside
# its kernels, the refill or the restart included (the round's bookkeeping:
# the depth step, the live count, the core's masks); before N2a, N2b and K3
# in lane mode a round was ~1,750 (PERF.md)
ROUND_OPS_MAX = 40
# the fused lane rounds (K1 in lane mode): refill or restart, K1 and N5, whose
# tail does the final-depth cap, the park and the depth step; no ATen op
FUSED_ROUND_CASES = ("cornell-wavefront-fused", "cornell-sticky-fused-262144")


def round_ops(r) -> dict:
    """``aten_ops`` of one round of ``r``'s lane engine (``r.engine``), its
    loop made without a graph on the frame's lanes after one round of
    warm-up: the counter wavefront's refill, bounce and round tail and
    test, or one sticky round (restart, bounce, round tail and test), as a
    capture records them (the guards' bodies, not their host reads)."""
    from raytracing_course_2024_tpu_torch.integrator import wavefront as W

    s = r.settings
    w, h, spp = s.width, s.height, s.samples
    n_pix = w * h
    lanes = min(r.batch_size, n_pix * spp)
    if r.engine == "wavefront":
        loop, _ = W.wavefront_loop(r.cfg, r.scene, r.cam, w, h, n_pix, spp, lanes)

        def run():
            loop.refill()
            loop.core()
            loop.test()
    else:
        loop = W.StickyLoop(r.cfg, r.scene, r.cam, w, h, n_pix, spp, lanes)
        run = loop.round
    loop.reset(1, 0, 0)
    run()  # warm-up: the kernel library, the allocator
    ops = aten_ops(run)
    torch.cuda.synchronize()
    return ops


def phase_graphs(dev, gpu: str) -> None:
    """Each case at 1280x720 x 16 spp on a graphed ``Renderer`` and an
    ``eager=True`` one: the first graphed frame (it captures) equal to the
    eager frame bit for bit (image, path vertices, rounds, launches); a
    second seed and a second ``samp_base`` add no cache entry and equal the
    eager frames; the cache holds the entries the case expects (the
    lane loops: one each, their refill or restart inside); the cache's capture ms,
    pool MB and launches per replay of each entry beside the eager frame's
    peak memory; eager and graphed frame ms in turns (eager, graphed,
    graphed, eager, eager, graphed: median of 3 each); the busy share under
    torch.profiler, graphed and eager, of the BVH batch frame and of the
    Cornell fused batch and counter wavefront frames. No frame may call the
    plain modular stages (``_fold_in_planes``, ``surface_detail``,
    ``_finish_bounce``; the XLA sampler ``sampler_plain`` and
    ``sample_mixture``; ``refill_plain``, ``restart_plain``): N1a, N1b, K3,
    N2a and N2b do that work; a modular batch sample dispatches at most
    ``SAMPLE_OPS_MAX`` ATen ops, a modular lane round ``ROUND_OPS_MAX``, a
    fused lane round (``FUSED_ROUND_CASES``) none."""
    from raytracing_course_2024_tpu_torch.integrator import path as P
    from raytracing_course_2024_tpu_torch.ops import refill as RF
    from raytracing_course_2024_tpu_torch.ops import sampler as S
    from raytracing_course_2024_tpu_torch.ops import shade as SH
    from raytracing_course_2024_tpu_torch.ops import traverse as TR
    from raytracing_course_2024_tpu_torch.scene import load_scene

    t_phase = time.perf_counter()
    w, h, spp = FRAME
    descs = {"bvh": bvh_desc(w, h, spp), "cornell": load_scene(CORNELL, w, h, spp)}
    # the plain versions' stages, counted where they are looked up (the fold
    # in ops/traverse.py:fold_hit; the XLA sampler in integrator/path.py:
    # sample_bounce and ops/sampler.py): the kernels' frames call none of
    # them (no case here takes faithful acceptance, which has no kernel)
    stages = {"_fold_in_planes": TR, "surface_detail": SH, "_finish_bounce": SH,
              "sampler_plain": P, "sample_mixture": S, "refill_plain": RF,
              "restart_plain": RF, "camera_state_plain": P}
    plain_calls = dict.fromkeys(stages, 0)

    def counted(name, f):
        def call(*a, **kw):
            plain_calls[name] += 1
            return f(*a, **kw)
        return call

    originals = {k: getattr(mod, k) for k, mod in stages.items()}
    for k, f in originals.items():
        setattr(stages[k], k, counted(k, f))
    try:
        graph_cases(descs, dev, gpu, plain_calls)
    finally:
        for k, f in originals.items():
            setattr(stages[k], k, f)
    say("graphs", seconds=round(time.perf_counter() - t_phase, 2))


def graph_cases(descs: dict, dev, gpu: str, plain_calls: dict) -> None:
    """The cases of ``phase_graphs``; ``plain_calls`` counts the calls of
    the plain modular stages, which must stay 0. A modular batch case also
    prints the ATen ops of one sample (``sample_ops``): at most
    ``SAMPLE_OPS_MAX``, with the camera stage in N4 and the shade and
    finish work in N1a and N1b; a
    modular lane case those of one round (``round_ops``): at most
    ``ROUND_OPS_MAX``, with the sampler, the refill and the restart in K3,
    N2a and N2b."""
    from raytracing_course_2024_tpu_torch.runtime.render import Renderer

    w, h, spp = FRAME
    for case, (scene, engine, rr, lanes, n_entries) in GRAPH_CASES.items():
        for k in plain_calls:
            plain_calls[k] = 0
        kw = dict(device=dev, engine=engine, russian_roulette=rr, batch_size=lanes)
        eager, graphed = Renderer(descs[scene], eager=True, **kw), Renderer(descs[scene], **kw)
        if graphed.graphs is None or eager.graphs is not None:
            raise SystemExit(f"[graphs] {case}: the graphed renderer has no graph cache")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        e1 = graph_frame(eager, 1)
        eager_peak = frame_mem_mb(base)
        g1 = graph_frame(graphed, 1)  # captures
        entries = len(graphed.graphs.entries)
        stats = graphed.graphs.stats()
        checks = {"seed1": same_frame(e1, g1)}
        checks["seed2"] = same_frame(graph_frame(eager, 2), graph_frame(graphed, 2))
        checks["samp_base"] = same_frame(graph_frame(eager, 2, GRAPH_SAMP_BASE),
                                         graph_frame(graphed, 2, GRAPH_SAMP_BASE))
        checks["one_capture"] = (len(graphed.graphs.entries) == entries == n_entries
                                 and graphed.graphs.stats()["capture_ms"] == stats["capture_ms"])
        times = {"eager": [], "graphed": []}
        for turn, mode in enumerate(("eager", "graphed", "graphed", "eager", "eager",
                                     "graphed")):
            times[mode].append(graph_frame(eager if mode == "eager" else graphed,
                                           3 + turn)["ms"])
        e_ms, g_ms = statistics.median(times["eager"]), statistics.median(times["graphed"])
        # a lane loop's launches per run of each guarded body, a sample's per replay
        per_entry = {k[0]: getattr(e.body, "sections", None) or e.launches
                     for k, e in graphed.graphs.entries.items()}
        say("graphs", case=case, size=f"{w}x{h}", spp=spp, engine=engine,
            route="fused" if graphed.fused else "modular", lanes=lanes or "default",
            **{f"bit_equal_{k}" if k != "one_capture" else k: v for k, v in checks.items()},
            entries=entries, capture_ms=round(stats["capture_ms"], 3),
            pool_mb=round(stats["pool_mb"], 1), eager_peak_mb=eager_peak,
            launches_per_replay=json.dumps(per_entry).replace(" ", ""),
            replays=stats["replays"], path_vertices=int(g1["verts"]),
            **({} if engine == "batch" else {"rounds": g1["rounds"]}),
            launches=json.dumps({k: v for k, v in g1["launches"].items() if v})
            .replace(" ", ""),
            eager_ms=round(e_ms, 3), graphed_ms=round(g_ms, 3),
            speedup=round(e_ms / g_ms, 3),
            frames_ms=json.dumps({k: [round(t, 3) for t in v] for k, v in times.items()})
            .replace(" ", ""), gpu=f'"{gpu}"')
        if not all(checks.values()):
            raise SystemExit(f"[graphs] {case}: graphed frames differ from eager: {checks}")
        if any(plain_calls.values()):
            raise SystemExit(f"[graphs] {case}: the kernels' frames ran plain stages "
                             f"{plain_calls}")
        if engine == "batch" and not graphed.fused:
            ops = sample_ops(eager)
            n_ops = sum(ops.values())
            say("graphs", case=case, aten_ops_per_sample=n_ops, levels=eager.settings.ray_depth,
                top=json.dumps(sorted(ops.items(), key=lambda kv: -kv[1])[:6]).replace(" ", ""),
                plain_stage_calls=json.dumps(plain_calls).replace(" ", ""))
            if n_ops > SAMPLE_OPS_MAX:
                raise SystemExit(f"[graphs] {case}: {n_ops} ATen ops in one sample "
                                 f"(> {SAMPLE_OPS_MAX}): the modular sample is not in N4, "
                                 "N1a and N1b")
        if engine != "batch" and not graphed.fused:
            ops = round_ops(eager)
            n_ops = sum(ops.values())
            say("graphs", case=case, aten_ops_per_round=n_ops,
                top=json.dumps(sorted(ops.items(), key=lambda kv: -kv[1])[:6]).replace(" ", ""),
                plain_stage_calls=json.dumps(plain_calls).replace(" ", ""))
            if n_ops > ROUND_OPS_MAX:
                raise SystemExit(f"[graphs] {case}: {n_ops} ATen ops in one round "
                                 f"(> {ROUND_OPS_MAX}): the round is not in its kernels")
        if case in FUSED_ROUND_CASES:
            ops = round_ops(eager)
            say("graphs", case=case, aten_ops_per_round=sum(ops.values()),
                ops=json.dumps(ops).replace(" ", ""))
            if ops:
                raise SystemExit(f"[graphs] {case}: ATen ops {ops} in a fused lane round beside "
                                 "its kernels (N2a or N2b, K1, N5)")
        if case in PROFILED:
            for mode, r in (("graphed", graphed), ("eager", eager)):
                p = profiled_frame(r, 9)
                say("graphs", case=case, profiled=mode, wall_ms=round(p["wall_ms"], 3),
                    device_ms=round(p["device_ms"], 3), busy_share=round(p["busy_share"], 4),
                    device_launches=p["launches"], top=json.dumps(
                        [[round(ms, 3), n, k[:40]] for ms, n, k in p["rows"][:4]])
                    .replace(" ", ""), gpu=f'"{gpu}"')
        del eager, graphed


def graphs_main() -> int:
    """``--graphs``: the build and the graphs phase alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    from raytracing_course_2024_tpu_torch.ops import kernels

    kernels.library()
    say("build", seconds=round(kernels.BUILD_INFO["seconds"], 2))
    gpu = gpu_line()
    phase_graphs(torch.device("cuda", 0), gpu)
    print(gpu, flush=True)
    return 0


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    # torch's own binding of IF nodes, which the lane loops do not need
    # (runtime/graphs.py:_if_node binds them through csrc/loop.cu)
    torch_if_nodes = hasattr(torch.cuda.CUDAGraph, "begin_capture_to_if_node")
    say("device", name=f'"{torch.cuda.get_device_name(0)}"', count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda, driver=gpu_line("driver_version"),
        torch_if_nodes=torch_if_nodes, clocks=f'"{clocks_line()}"')

    # 2. build (the package is imported only now: a lone chip_smoke.py fails here)
    from raytracing_course_2024_tpu_torch.ops import kernels

    kernels.library()
    info = kernels.BUILD_INFO
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if re.search(r"registers|spill|Compiling entry", ln)]
    say("build", seconds=round(info["seconds"], 2), lib=os.path.basename(info["path"]))
    for ln in ptxas:
        print(f"[build] {ln}", flush=True)
    geom = kernels.launch_geometry()
    say("build", sms=geom["sms"], threads_per_block=geom["block"], lanes_per_tile=geom["tile"],
        resident_blocks_per_sm=json.dumps(geom["resident_blocks"]).replace(" ", ""))

    phase_kernels(dev)
    errs, cornell = phase_kernels_modular(dev)
    lane_errs, k5_state = phase_kernels_lanes(dev)
    phase_kernels_tiles(dev, k5_state)
    errs["bvh"] = phase_kernels_bvh(dev)
    n1_errs, n1 = phase_kernels_shade(dev)
    errs.update(n1_errs)
    round_errs, lane = phase_kernels_round(dev, gpu)
    # K3's lane mode keeps its own error: its pdfs reach 1e14 on near-mirror lanes
    lane["sampler-lane"]["max_abs_err"] = round_errs.pop("sampler")
    errs.update(round_errs)
    errs["sampler_many"], lane["sampler_many"] = phase_kernels_many(dev, gpu)
    errs["camera"] = phase_kernels_camera(dev)
    errs["loop"] = phase_kernels_loop(dev)
    with tempfile.TemporaryDirectory() as tmp:
        runs = {path: phase_main(dev, tmp, path) for path in MAIN}
    # each kernel's launches on the main path: the batch path's run for its
    # kernels (K1 also runs in lane mode in the wavefront run), K4/K3/N1a/N1b
    # from the modular run, K5 from the sticky run, K6 from the BVH run, N2a
    # and N2b from the BVH lane runs (K3 in lane mode there: "launches_lane")
    counts = dict(runs["fused"])
    counts.update({k: runs["modular"][k] for k in MODULAR})
    counts["persistent"] = runs["sticky"]["persistent"]
    counts["bvh"] = runs["bvh"]["bvh"]
    counts["refill"] = runs["bvh-wavefront"]["refill"]
    counts["restart"] = runs["bvh-sticky"]["restart"]
    counts["loop"] = runs["bvh"]["loop"]  # the BVH default engine's loop
    counts["sampler_many"] = lane["sampler_many"]["launches"]  # practice6_1's frame
    lane["sampler-lane"]["launches"] = sum(runs[p]["sampler"]
                                           for p in ("bvh-wavefront", "bvh-sticky"))
    idle = [k for k in KERNELS if counts[k] < 1]
    if idle:
        raise SystemExit(f"kernels not launched on the main path: {idle}")
    phase_render(dev)
    phase_render_bvh(dev)
    errs.update(lane_errs)  # K1's row also holds its lane-mode error
    bvh = phase_timing_bvh(dev, gpu)
    errs["bvh"] = max(errs["bvh"], bvh["max_abs_err"])
    record = phase_timing(dev, gpu, counts, errs, cornell, k5_state, bvh, n1, lane)
    del n1
    phase_graphs(dev, gpu)
    phase_loop(dev, gpu)
    phase_runtime(dev, gpu)
    phase_multiproc(dev, gpu)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
    if leaked:
        raise SystemExit(f"the port imported {leaked}")
    print(gpu, flush=True)
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--resume"]:
        sys.exit(resume_main(sys.argv[2]))
    if sys.argv[1:2] == ["--cards"]:
        sys.exit(cards_main())
    if sys.argv[1:2] == ["--graphs"]:
        sys.exit(graphs_main())
    if sys.argv[1:2] == ["--many"]:
        sys.exit(many_main())
    if sys.argv[1:2] == ["--traced"]:
        sys.exit(traced_main())
    if sys.argv[1:2] == ["--mp-worker"]:
        mode, tmp, store, world, rank = sys.argv[2:7]
        sys.exit(mp_worker(mode, tmp, store, int(world), int(rank)))
    sys.exit(main())
