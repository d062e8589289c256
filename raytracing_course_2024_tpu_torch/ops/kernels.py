"""Build and bind the hand-written CUDA kernels of ``csrc/``.

The sources are compiled by ``nvcc`` on first use into
``raytracing_course_2024_tpu_torch/build/`` (git-ignored), one shared
library per hash of the sources and flags, and loaded with ctypes. The
build targets ``sm_90a`` (Hopper) with a plain C interface, so no PyTorch
header is compiled. ``-Xptxas -v`` writes each kernel's registers, shared
memory and spills into the build log next to the library.

Importing this module builds nothing; ``library()`` builds on first call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("bounce.cu",)
# --fmad=false: no FMA contraction, so the kernels round op by op like the
# plain versions (PyTorch runs one op per kernel). With contraction, grazing
# hits and accept decisions flipped on ~0.1 % of the MIXED scene's lanes per
# bounce (H100 run); without it the two agree on >= 99.99 %. No fast math:
# the kernels need IEEE inf and exact division.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "-lineinfo",
)

_LIB = None
BUILD_INFO: dict = {}  # path, seconds (0.0 when cached), log of the last build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _build() -> Path:
    srcs = [CSRC / s for s in SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.read_bytes())
    tag = h.hexdigest()[:16]
    lib = BUILD_DIR / f"rt_kernels_{tag}.so"
    log = BUILD_DIR / f"rt_kernels_{tag}.log"
    if lib.exists():
        BUILD_INFO.update(path=str(lib), seconds=0.0, log=log.read_text()
                          if log.exists() else "")
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    text = f"$ {' '.join(cmd)}\n{res.stdout}{res.stderr}"
    log.write_text(text)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{text}")
    os.replace(tmp, lib)
    BUILD_INFO.update(path=str(lib), seconds=secs, log=text)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_build()))
        p, i, u, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                          ctypes.c_float, ctypes.c_longlong)
        lib.rt_launch_bounce.argtypes = [
            p, p, ll, p, u, u, u, p, p, i, p, p, i, i, f, f, f, i, i, p,
        ]
        lib.rt_launch_bounce.restype = i
        lib.rt_launch_primary.argtypes = [
            p, p, p, i, i, p, ll, p, u, u, u, p, p, i, p, p, i, i, f, f, f, i, p,
        ]
        lib.rt_launch_primary.restype = i
        _LIB = lib
    return _LIB


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _u32(x: int) -> int:
    return int(x) & 0xFFFFFFFF


def launch_bounce(scene, state, out, wid, wid_off, seed, bounce_i, bg,
                  max_tries, draws, final_only) -> None:
    lib = library()
    stream = torch.cuda.current_stream(state.device).cuda_stream
    rc = lib.rt_launch_bounce(
        state.data_ptr(), out.data_ptr(), state.shape[1], wid.data_ptr(),
        _u32(wid_off), _u32(seed), _u32(bounce_i * draws),
        scene.geo.data_ptr(), scene.spec.data_ptr(), scene.geo.shape[1],
        scene.lp.data_ptr(), scene.lspec.data_ptr(), scene.lp.shape[1],
        scene.statics.num_lights, float(bg[0]), float(bg[1]), float(bg[2]),
        int(max_tries), int(bool(final_only)), stream,
    )
    _raise_on(rc, "rt_launch_bounce")


def launch_primary(scene, cam_row, px, py, out, wid, wid_off, seed, bg,
                   max_tries, width, height) -> None:
    lib = library()
    stream = torch.cuda.current_stream(px.device).cuda_stream
    rc = lib.rt_launch_primary(
        px.data_ptr(), py.data_ptr(), cam_row.data_ptr(), int(width),
        int(height), out.data_ptr(), px.shape[0], wid.data_ptr(),
        _u32(wid_off), _u32(seed), 0, scene.geo.data_ptr(),
        scene.spec.data_ptr(), scene.geo.shape[1], scene.lp.data_ptr(),
        scene.lspec.data_ptr(), scene.lp.shape[1], scene.statics.num_lights,
        float(bg[0]), float(bg[1]), float(bg[2]), int(max_tries), stream,
    )
    _raise_on(rc, "rt_launch_primary")
