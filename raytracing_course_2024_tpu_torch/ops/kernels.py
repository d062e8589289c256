"""Build and bind the hand-written CUDA kernels of ``csrc/``.

The sources are compiled by ``nvcc`` on first use into
``raytracing_course_2024_tpu_torch/build/`` (git-ignored), one shared
library per hash of every file under ``csrc/`` and the flags, and loaded
with ctypes. Each ``.cu`` file compiles to an object in its own ``nvcc``
process, all started together, then one link makes the library. The build
targets ``sm_90a`` (Hopper) with a plain C interface, so no PyTorch header
is compiled. ``-Xptxas -v`` writes each kernel's registers, shared memory
and spills into the build log next to the library.

Importing this module builds nothing; ``library()`` builds on first call,
under a lock of its own (shards render from threads), and each build names
its objects by process and thread.
Each ``launch_*`` function makes its tensors' device current for the launch
and launches on that device's current stream, so shards on several cards,
or on threads, each launch where their data lies. ``LAUNCHES`` counts the
launches of each kernel (the wrappers of ``ops/bounce.py``,
``ops/dense_nearest.py``, ``ops/sampler.py``, ``ops/persistent.py``,
``ops/traverse.py``, ``ops/shade.py``, ``ops/refill.py`` and
``ops/camera.py`` call these functions); it and the tile tickets are
changed under a lock. ``check`` validates a tensor before its pointer goes
to a kernel.

Inside a CUDA graph capture (``runtime/graphs.py``) a wrapper's launch is
recorded, not run: under ``recording()`` the counts of the calling thread
go to the recorder's dict instead of ``LAUNCHES``, and each replay adds
them with ``add_launches``. A stream's tickets are made before its capture
(``prepare_stream``); the kernels leave them at zero, so every replay finds
them so.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from ..runtime.profiling import span

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("bounce.cu", "bvh_traverse.cu", "camera.cu", "dense_nearest.cu", "loop.cu",
           "persistent.cu", "refill.cu", "sampler.cu", "shade.cu")
# --fmad=false: no FMA contraction, so the kernels round op by op like the
# plain versions (PyTorch runs one op per kernel). With contraction, grazing
# hits and accept decisions flipped on ~0.1 % of the MIXED scene's lanes per
# bounce (H100 run); without it the two agree on >= 99.99 %. No fast math:
# the kernels need IEEE inf and exact division.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)


_LIB = None
_LIB_LOCK = threading.Lock()  # the first load: one build however many threads ask
BUILD_INFO: dict = {}  # path, seconds (0.0 when cached), log of the last build

# kernel launches per wrapper: the fused K2 / K1 (batch and lane mode) /
# K1-final, the modular path's K4 and K3 (batch and lane mode; above 32
# lights its walk of the lights' tree, "sampler_many"), the sticky
# engine's K5, the BVH backend's K6, the modular bounce's shade (N1a) and
# finish (N1b), the lane engines' refill (N2a) and restart (N2b), the modular
# route's camera stage (N4), the lane round's tail and loop test (N5)
LAUNCHES = {"primary": 0, "bounce": 0, "final": 0, "nearest": 0, "sampler": 0,
            "persistent": 0, "bvh": 0, "shade": 0, "finish": 0, "refill": 0, "restart": 0,
            "camera": 0, "loop": 0, "sampler_many": 0}
_LOCK = threading.Lock()  # guards LAUNCHES and _TICKETS: shards launch from threads
# .counts: the calling thread's capture recorder, if any; .tickets: the stream
# whose tile tickets every launch of the thread's capture takes
_RECORD = threading.local()


def reset_launches() -> None:
    with _LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str) -> None:
    rec = getattr(_RECORD, "counts", None)
    if rec is not None:
        rec[name] = rec.get(name, 0) + 1
        return
    with _LOCK:
        LAUNCHES[name] += 1


@contextlib.contextmanager
def recording():
    """While active, this thread's launches are counted into the yielded
    dict and not into ``LAUNCHES``: what a graph capture records runs only
    when the graph is replayed."""
    counts: dict = {}
    prev = getattr(_RECORD, "counts", None)
    _RECORD.counts = counts
    try:
        yield counts
    finally:
        _RECORD.counts = prev


def add_launches(counts: dict) -> None:
    """Adds a replayed graph's launches to ``LAUNCHES``."""
    with _LOCK:
        for k, n in counts.items():
            LAUNCHES[k] += n


def check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _build() -> Path:
    files = sorted(p for p in CSRC.iterdir() if p.is_file())
    flags = NVCC_FLAGS
    h = hashlib.sha256(" ".join(flags).encode())
    for f in files:  # headers too: an edited header must not reuse a stale .so
        h.update(f.name.encode())
        h.update(f.read_bytes())
    tag = h.hexdigest()[:16]
    lib = BUILD_DIR / f"rt_kernels_{tag}.so"
    log = BUILD_DIR / f"rt_kernels_{tag}.log"
    if lib.exists():
        BUILD_INFO.update(path=str(lib), seconds=0.0, log=log.read_text()
                          if log.exists() else "")
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    me = f"{os.getpid()}.{threading.get_ident()}"
    stem = f"rt_kernels_{tag}.{me}"
    objs = [BUILD_DIR / f"{stem}.{Path(s).stem}.o" for s in SOURCES]
    t0 = time.perf_counter()
    jobs = []
    for src, obj in zip(SOURCES, objs):
        cmd = [nvcc, *flags, "-c", "-o", str(obj), str(CSRC / src)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    text, failed = "", False
    for cmd, proc in jobs:
        out, _ = proc.communicate()
        text += f"$ {' '.join(cmd)}\n{out}"
        failed |= proc.returncode != 0
    tmp = lib.with_suffix(f".{me}.tmp")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        text += f"$ {' '.join(cmd)}\n{res.stdout}{res.stderr}"
        failed = res.returncode != 0
    secs = time.perf_counter() - t0
    log.write_text(text)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed:\n{text}")
    os.replace(tmp, lib)
    BUILD_INFO.update(path=str(lib), seconds=secs, log=text)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use (span
    ``rt.setup.library``: nvcc or the cached load)."""
    if _LIB is None:
        with _LIB_LOCK:
            if _LIB is None:
                with span("rt.setup.library"):
                    _load()
    return _LIB


def _load() -> None:
    """Loads the library (``_build``) and declares every entry point."""
    global _LIB
    lib = ctypes.CDLL(str(_build()))
    p, i, u, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                      ctypes.c_float, ctypes.c_longlong)
    ctr = [u, u, u, u]  # Ctr: base, cand, row, diel
    scene = [p, p, i, p, p, i, i, f, f, f, i]  # tables, lights, bg, max_tries
    lib.rt_launch_bounce.argtypes = [
        p, p, ll, p, p, *ctr, p, u, *scene, i, p, p, p,
    ]
    lib.rt_launch_bounce.restype = i
    lib.rt_launch_primary.argtypes = [
        p, p, p, i, i, p, ll, p, p, *ctr, *scene, p,
    ]
    lib.rt_launch_primary.restype = i
    lib.rt_launch_dense_nearest.argtypes = [p, p, i, ll, f, p, p, p, p]
    lib.rt_launch_dense_nearest.restype = i
    lib.rt_launch_bvh_nearest.argtypes = [p, p, i, i, p, i, ll, f, p, p, p, p, p]
    lib.rt_launch_bvh_nearest.restype = i
    lib.rt_launch_sampler.argtypes = [
        p, p, p, p, *ctr, p, u, p, p, i, i, i, ll, p, p, p,
    ]
    lib.rt_launch_sampler.restype = i
    lib.rt_launch_sampler_many.argtypes = [
        p, p, p, p, *ctr, p, u, p, p, i, p, i, i, i, ll, p, p, p, p,
    ]
    lib.rt_launch_sampler_many.restype = i
    lib.rt_launch_persistent.argtypes = [
        p, p, ll, p, p, p, p, i, i, p, u, *ctr, u, i, *scene, p, p, p, p, p,
    ]
    lib.rt_launch_persistent.restype = i
    lib.rt_launch_shade.argtypes = [p, ll, p, p, p, i, p, p, i, i, i, p, i, f, f, f, i, p, p, p,
                                    p, p]
    lib.rt_launch_shade.restype = i
    lib.rt_launch_finish.argtypes = [p, ll, p, p, p, p, p, p, u, u, u, u, p, i, i, i, i, p, p]
    lib.rt_launch_finish.restype = i
    lib.rt_launch_refill.argtypes = [p, ll, p, p, p, ll, p, p, p, p, p, ll, ll, i, i, p, ll,
                                     p]
    lib.rt_launch_refill.restype = i
    lib.rt_launch_restart.argtypes = [p, ll, p, p, p, p, ll, p, p, p, ll, ll, i, i, p]
    lib.rt_launch_restart.restype = i
    lib.rt_launch_camera.argtypes = [p, p, p, p, p, i, i, p, ll, p]
    lib.rt_launch_camera.restype = i
    lib.rt_launch_round_tail.argtypes = [i, i, p, p, p, p, p, ll, ll, ll, i, p, ll, ll, p, p,
                                         p, p]
    lib.rt_launch_round_tail.restype = i
    lib.rt_if_begin.argtypes = [p, p, p]
    lib.rt_if_begin.restype = i
    lib.rt_if_end.argtypes = [p]
    lib.rt_if_end.restype = i
    lib.rt_stream_create.argtypes = []
    lib.rt_stream_create.restype = p
    lib.rt_bounce_geometry.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.rt_bounce_geometry.restype = None
    lib.rt_persistent_resident_blocks.argtypes = []
    lib.rt_persistent_resident_blocks.restype = i
    lib.rt_dense_nearest_geometry.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.rt_dense_nearest_geometry.restype = None
    lib.rt_bvh_nearest_geometry.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.rt_bvh_nearest_geometry.restype = None
    lib.rt_sampler_many_geometry.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.rt_sampler_many_geometry.restype = None
    lib.rt_sampler_resident_blocks.argtypes = []
    lib.rt_sampler_resident_blocks.restype = i
    lib.rt_restart_whole_lanes.argtypes = []
    lib.rt_restart_whole_lanes.restype = ll
    _LIB = lib


def _raise_on(rc: int, name: str, *tickets: torch.Tensor) -> None:
    """Raises on a launcher's CUDA error. A launch that took ``tickets`` and
    did not run to its end may have left them counted up: they are zeroed,
    so that the next launch on that stream does not skip tiles."""
    if rc != 0:
        for t in tickets:
            t.zero_()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _u32(x: int) -> int:
    return int(x) & 0xFFFFFFFF


def _ctr(ctr) -> tuple:
    """An ops.rng.Ctr with an int base as the kernels' four u32 arguments."""
    return _u32(ctr.base), _u32(ctr.cand), _u32(ctr.row), _u32(ctr.diel)


def _scene(scene, bg, max_tries) -> tuple:
    """A BounceScene and the launch constants as the kernels' scene arguments."""
    return (scene.geo.data_ptr(), scene.rec.data_ptr(), scene.geo.shape[1],
            scene.lp.data_ptr(), scene.lspec.data_ptr(), scene.lp.shape[1],
            scene.statics.num_lights, float(bg[0]), float(bg[1]), float(bg[2]),
            int(max_tries))


_TICKETS: dict = {}


def _tickets(device, stream: int) -> torch.Tensor:
    """The two int32 with which K1 and K5 hand out their tiles
    (``csrc/lane_queue.cuh:walk_tiles``) and K6 and K3 above 32 lights their
    warps' chunks (``csrc/bvh_traverse.cu``, ``csrc/light_tree.cuh``): zero
    between launches, one pair
    per device and stream, since launches on one stream run in order. A
    stream under graph capture must have its pair already
    (``prepare_stream``): made inside the capture, it would live in the
    graph's pool and be zeroed only by the capture."""
    device = torch.device(device)
    key = (device, getattr(_RECORD, "tickets", None) or stream)
    with _LOCK:
        if key not in _TICKETS:
            if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError("tile tickets of a capturing stream must be made before "
                                   "the capture (ops/kernels.py:prepare_stream)")
            _TICKETS[key] = torch.zeros((2,), dtype=torch.int32, device=device)
        return _TICKETS[key]


def prepare_stream(device, stream: torch.cuda.Stream) -> None:
    """Makes ``stream``'s tile tickets on ``device`` before a graph is
    captured on it."""
    _tickets(device, stream.cuda_stream)


@contextlib.contextmanager
def capture_tickets(stream: torch.cuda.Stream):
    """While active, every launch of this thread takes ``stream``'s tile
    tickets, whatever stream it launches on: the bodies of a graph's IF
    nodes are captured on streams of their own, but every node of a graph
    runs one after the other, so one pair serves them all."""
    prev = getattr(_RECORD, "tickets", None)
    _RECORD.tickets = stream.cuda_stream
    try:
        yield
    finally:
        _RECORD.tickets = prev


@contextlib.contextmanager
def _on(device: torch.device):
    """Makes ``device`` current for a launch and yields its current stream:
    the launchers size their grids from the current device's SMs
    (``csrc/lane_queue.cuh:grid_for``) and ``<<<>>>`` launches on it."""
    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream


def launch_geometry() -> dict:
    """How the kernels are launched on the current device: its SMs, threads
    per block, lanes per tile, K4's rays per thread and tiles per chunk, K6's
    stack (entries in all and in shared memory per thread), its top of the
    tree staged in shared memory (wide nodes), its shared and local bytes per
    block and thread and its registers, and each kernel's resident blocks per
    SM (the grid of K1, K2, K5, K6 and K3 above 32 lights is SMs x resident
    blocks, or fewer when the batch needs fewer; K3 and K4 launch one block
    per chunk), K3's above 32 lights as K6's (``sampler_many_*``), and the
    lanes above which N2b writes its rows in whole sectors."""
    lib = library()
    out = (ctypes.c_int * 6)()
    lib.rt_bounce_geometry(out)
    k4 = (ctypes.c_int * 3)()
    lib.rt_dense_nearest_geometry(k4)
    k6 = (ctypes.c_int * 7)()
    lib.rt_bvh_nearest_geometry(k6)
    k3 = (ctypes.c_int * 7)()
    lib.rt_sampler_many_geometry(k3)
    return {"sms": out[0], "block": out[1], "tile": out[2], "nearest_rays_per_thread": k4[0],
            "nearest_tiles_per_chunk": k4[1], "bvh_stack": k6[0], "bvh_shared_stack": k6[1],
            "bvh_top_nodes": k6[2], "bvh_shared_bytes": k6[3], "bvh_local_bytes": k6[4],
            "bvh_registers": k6[5], "sampler_many_stack": k3[0], "sampler_many_shared_stack": k3[1],
            "sampler_many_top_nodes": k3[2], "sampler_many_shared_bytes": k3[3],
            "sampler_many_local_bytes": k3[4], "sampler_many_registers": k3[5],
            "resident_blocks": {"bounce": out[3], "final": out[4], "primary": out[5],
                                "persistent": lib.rt_persistent_resident_blocks(),
                                "nearest": k4[2],
                                "sampler": lib.rt_sampler_resident_blocks(), "bvh": k6[6],
                                "sampler_many": k3[6]},
            "restart_whole_above_lanes": lib.rt_restart_whole_lanes()}


def launch_bounce(scene, state, out, wid, seed_off, ctr, depth, ctr_stride, bg,
                  max_tries, final_only, count=None) -> None:
    """K1; ``seed_off`` is the (2,) int64 device tensor (seed, work-id
    offset) the kernel reads."""
    lib = library()
    with _on(state.device) as stream:
        tickets = _tickets(state.device, stream)
        rc = lib.rt_launch_bounce(
            state.data_ptr(), out.data_ptr(), state.shape[1], wid.data_ptr(),
            seed_off.data_ptr(), *_ctr(ctr),
            None if depth is None else depth.data_ptr(), _u32(ctr_stride),
            *_scene(scene, bg, max_tries), int(bool(final_only)),
            None if count is None else count.data_ptr(), tickets.data_ptr(), stream,
        )
        _raise_on(rc, "rt_launch_bounce", tickets)
    _count("final" if final_only else "bounce")


def launch_primary(scene, cam_row, px, py, out, wid, seed_off, ctr, bg,
                   max_tries, width, height) -> None:
    """K2; ``seed_off`` as ``launch_bounce`` takes it."""
    lib = library()
    with _on(px.device) as stream:
        rc = lib.rt_launch_primary(
            px.data_ptr(), py.data_ptr(), cam_row.data_ptr(), int(width),
            int(height), out.data_ptr(), px.shape[0], wid.data_ptr(),
            seed_off.data_ptr(), *_ctr(ctr), *_scene(scene, bg, max_tries), stream,
        )
    _raise_on(rc, "rt_launch_primary")
    _count("primary")


def launch_persistent(scene, state, out, px, py, kmax, cam_row, width, height, sb,
                      frame_pix, ctr, ctr_stride, ray_depth, bg, max_tries, loop, preds,
                      scratch) -> None:
    """K5; ``sb`` the (3,) int64 device tensor (seed, pix_base, samp_base);
    ``loop``, ``preds``, ``scratch`` a ``ops/loop.py:LoopState``'s, which
    the kernel's last block updates with the round's counts."""
    lib = library()
    with _on(state.device) as stream:
        tickets = _tickets(state.device, stream)
        rc = lib.rt_launch_persistent(
            state.data_ptr(), out.data_ptr(), state.shape[1], px.data_ptr(), py.data_ptr(),
            kmax.data_ptr(), cam_row.data_ptr(), int(width), int(height), sb.data_ptr(),
            _u32(frame_pix), *_ctr(ctr), _u32(ctr_stride), int(ray_depth),
            *_scene(scene, bg, max_tries), loop.data_ptr(), preds.data_ptr(),
            scratch.data_ptr(), tickets.data_ptr(), stream,
        )
        _raise_on(rc, "rt_launch_persistent", tickets, scratch)
    _count("persistent")


def _ptrs(tensors) -> ctypes.Array:
    """Host array of device pointers (the kernels take one per SoA row)."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def launch_dense_nearest(rays, records, tmin, live, t_out, i_out) -> None:
    lib = library()
    with _on(t_out.device) as stream:
        rc = lib.rt_launch_dense_nearest(
            _ptrs(rays), records.data_ptr(), records.shape[0], t_out.shape[0], float(tmin),
            None if live is None else live.data_ptr(), t_out.data_ptr(), i_out.data_ptr(),
            stream,
        )
    _raise_on(rc, "rt_launch_dense_nearest")
    _count("nearest")


def launch_bvh_nearest(rays, nodes, stack, records, tmin, live, t_out, i_out) -> None:
    lib = library()
    with _on(t_out.device) as stream:
        tickets = _tickets(t_out.device, stream)
        rc = lib.rt_launch_bvh_nearest(
            _ptrs(rays), nodes.data_ptr(), nodes.shape[0], int(stack), records.data_ptr(),
            records.shape[0], t_out.shape[0], float(tmin),
            None if live is None else live.data_ptr(), t_out.data_ptr(), i_out.data_ptr(),
            tickets.data_ptr(), stream,
        )
        _raise_on(rc, "rt_launch_bvh_nearest", tickets)
    _count("bvh")


def launch_sampler(ins, need, wid, seed_off, ctr, depth, ctr_stride, lp, lspec,
                   num_lights, max_tries, out, ok) -> None:
    """K3; ``seed_off`` is the (2,) int64 device tensor (seed, work-id
    offset) the kernel reads; ``depth`` (lane mode) or None."""
    lib = library()
    with _on(out.device) as stream:
        rc = lib.rt_launch_sampler(
            _ptrs(ins), need.data_ptr(), wid.data_ptr(), seed_off.data_ptr(),
            *_ctr(ctr), None if depth is None else depth.data_ptr(), _u32(ctr_stride),
            lp.data_ptr(), lspec.data_ptr(), lp.shape[1],
            int(num_lights), int(max_tries), out.shape[1], out.data_ptr(),
            ok.data_ptr(), stream,
        )
    _raise_on(rc, "rt_launch_sampler")
    _count("sampler")


def launch_sampler_many(ins, need, wid, seed_off, ctr, depth, ctr_stride, rec, leaf, nodes,
                        stack, max_tries, out, ok) -> None:
    """K3 above 32 lights: ``rec`` and ``leaf`` the light records in light
    order and in the tree's order, ``nodes`` the lights' 4-wide tree and
    ``stack`` its walk's bound (``ops/bvh.py:build_light_tree``); the rest
    as ``launch_sampler``'s. Counted as ``"sampler_many"``."""
    lib = library()
    with _on(out.device) as stream:
        tickets = _tickets(out.device, stream)
        rc = lib.rt_launch_sampler_many(
            _ptrs(ins), need.data_ptr(), wid.data_ptr(), seed_off.data_ptr(),
            *_ctr(ctr), None if depth is None else depth.data_ptr(), _u32(ctr_stride),
            rec.data_ptr(), leaf.data_ptr(), rec.shape[0], nodes.data_ptr(), nodes.shape[0],
            int(stack), int(max_tries), out.shape[1], out.data_ptr(), ok.data_ptr(),
            tickets.data_ptr(), stream,
        )
        _raise_on(rc, "rt_launch_sampler_many", tickets)
    _count("sampler_many")


def launch_shade(state, t, idx, prim_rec, plane, pl_mask, n_planes, any_rotation, any_nontri,
                 depth, last, bg, final_only, surf, need, count=None) -> None:
    """N1a; ``prim_rec`` the (N, 40) primitive records, ``n_planes`` 0
    leaves the plane fold out. ``surf`` (rows, rec) and ``need`` are None
    with ``final_only``. ``count`` (a 0-dim int64 tensor) or None: the
    kernel adds the lanes alive on its entry."""
    lib = library()
    rows, rec = (None, None) if surf is None else (surf[0].data_ptr(), surf[1].data_ptr())
    with _on(state.device) as stream:
        rc = lib.rt_launch_shade(
            state.data_ptr(), state.shape[1], t.data_ptr(), idx.data_ptr(), prim_rec.data_ptr(),
            prim_rec.shape[0], plane.data_ptr(), pl_mask.data_ptr(), int(n_planes),
            int(bool(any_rotation)), int(bool(any_nontri)),
            None if depth is None else depth.data_ptr(), int(last), float(bg[0]), float(bg[1]),
            float(bg[2]), int(bool(final_only)), rows, rec,
            None if need is None else need.data_ptr(),
            None if count is None else count.data_ptr(), stream,
        )
    _raise_on(rc, "rt_launch_shade")
    _count("shade")


def launch_finish(state, surf, lpdf, ok, wid, seed_off, base, stride, diel, rr_off, depth,
                  level, rr, rr_start, faithful, live) -> None:
    """N1b; ``surf`` N1a's (rows, rec), ``lpdf`` the sampler's four (b,)
    rows l.x, l.y, l.z, pdf, ``seed_off`` the (2,) int64 device tensor
    (seed, work-id offset) the kernel reads; draws at ``base + stride *
    (depth or level)`` plus ``diel`` or ``rr_off``."""
    lib = library()
    with _on(state.device) as stream:
        rc = lib.rt_launch_finish(
            state.data_ptr(), state.shape[1], surf[0].data_ptr(), surf[1].data_ptr(),
            _ptrs(lpdf), ok.data_ptr(), wid.data_ptr(), seed_off.data_ptr(), _u32(base),
            _u32(stride), _u32(diel), _u32(rr_off), None if depth is None else depth.data_ptr(), int(level),
            int(bool(rr)), int(rr_start), int(bool(faithful)), live.data_ptr(), stream,
        )
    _raise_on(rc, "rt_launch_finish")
    _count("finish")


def launch_refill(state, work, counter, done, depth, wid, seed_off, cam_row, bases, n_pix,
                  samples, width, height, scan) -> None:
    """N2a; ``scan`` the (1 + tiles,) int64 scratch, zero before its first
    launch (a launch leaves it ready for the next)."""
    lib = library()
    with _on(state.device) as stream:
        rc = lib.rt_launch_refill(
            state.data_ptr(), state.shape[1], work.data_ptr(), counter.data_ptr(),
            done.data_ptr(), done.shape[1], depth.data_ptr(), wid.data_ptr(),
            seed_off.data_ptr(), cam_row.data_ptr(), bases.data_ptr(), int(n_pix), int(samples),
            int(width), int(height), scan.data_ptr(), scan.shape[0], stream,
        )
        _raise_on(rc, "rt_launch_refill", scan)
    _count("refill")


def launch_restart(state, k, depth, wid, acc, seed_off, cam_row, bases, n_pix, samples, width,
                   height) -> None:
    """N2b (each lane's kmax computed from its index)."""
    lib = library()
    with _on(state.device) as stream:
        rc = lib.rt_launch_restart(
            state.data_ptr(), state.shape[1], k.data_ptr(), depth.data_ptr(), wid.data_ptr(),
            acc.data_ptr(), acc.shape[1], seed_off.data_ptr(), cam_row.data_ptr(),
            bases.data_ptr(), int(n_pix), int(samples), int(width), int(height), stream,
        )
    _raise_on(rc, "rt_launch_restart")
    _count("restart")


def launch_camera(px, py, wid, seed_off, cam_row, width, height, out) -> None:
    """N4; ``seed_off`` the (2,) int64 device tensor (seed, work-id offset)
    the kernel reads; ``out`` the (13, b) state it writes."""
    lib = library()
    with _on(out.device) as stream:
        rc = lib.rt_launch_camera(
            px.data_ptr(), py.data_ptr(), wid.data_ptr(), seed_off.data_ptr(),
            cam_row.data_ptr(), int(width), int(height), out.data_ptr(), out.shape[1], stream,
        )
    _raise_on(rc, "rt_launch_camera")
    _count("camera")


def launch_round_tail(mode, tail, state, alive, depth, k, kmax, b, n_pix, samples, last,
                      counter, total, thresh, loop, preds, scratch) -> None:
    """N5; ``state`` the (13, b) state (the fused tail) and ``alive`` its row
    12, or ``state`` None and ``alive`` a (b,) row; ``kmax`` None: the kernel
    computes each lane's from its index, ``n_pix`` and ``samples``; the
    tensors a mode or a tail does not read are None; ``scratch`` a
    ``ops/loop.py:LoopState``'s, whose word 2 the launch takes."""
    lib = library()

    def ptr(t):
        return None if t is None else t.data_ptr()

    with _on(loop.device) as stream:
        rc = lib.rt_launch_round_tail(
            int(mode), int(tail), ptr(state), ptr(alive), ptr(depth), ptr(k), ptr(kmax), int(b),
            int(n_pix), int(samples), int(last), ptr(counter), int(total), int(thresh),
            loop.data_ptr(), preds.data_ptr(), scratch.data_ptr(), stream,
        )
        _raise_on(rc, "rt_launch_round_tail", scratch)
    _count("loop")


def if_begin(parent: torch.cuda.Stream, pred: torch.Tensor, child: torch.cuda.Stream) -> None:
    """Opens an IF node on ``parent`` (under capture) on the 0-dim bool
    ``pred``; ``child`` captures its body until ``if_end``."""
    rc = library().rt_if_begin(parent.cuda_stream, pred.data_ptr(), child.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rt_if_begin failed: CUDA error {rc}")


def if_end(child: torch.cuda.Stream) -> None:
    rc = library().rt_if_end(child.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rt_if_end failed: CUDA error {rc}")


def new_stream(device: torch.device) -> torch.cuda.ExternalStream:
    """A CUDA stream of its own on ``device`` (not one of PyTorch's pool)."""
    with torch.cuda.device(device):
        ptr = library().rt_stream_create()
    if not ptr:
        raise RuntimeError("rt_stream_create failed")
    return torch.cuda.ExternalStream(ptr, device=device)
