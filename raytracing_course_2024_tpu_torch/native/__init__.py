"""Native (C++) host BVH builder, loaded through ctypes.

A copy of the JAX package's ``native/__init__.py`` loader for the port's
own ``bvh_builder.cpp``: the binned-SAH build over 100k+ primitives in C++
(the reference's equivalent is its Rust build, src/bvh.rs:26-144). The
shared library is compiled on first use with g++ (plain C ABI + ctypes) into
the port's git-ignored ``build/native/`` directory. A freshly built library
first runs in a throwaway subprocess, so that a binary the host cannot run
kills that process and not the caller. ``ops/bvh.py`` falls back to its
numpy builder, which is also the tests' oracle, when this one fails: both
build the host tree, neither touches the device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "bvh_builder.cpp"
_BUILD = _HERE.parent / "build" / "native"
_lock = threading.Lock()
_lib_cache = None


def _so_path() -> Path:
    """Cache path keyed by (source hash, host): the binary is built with
    -march=native, so it is never shared across CPU types."""
    src_hash = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    tag = f"{src_hash}-{platform.machine()}-{platform.node()}"
    return _BUILD / f"librt_native-{tag}.so"


def _compile(so: Path) -> None:
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-o", str(tmp), str(_SRC)]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, so)


def _selftest(so: Path) -> bool:
    """Runs rt_build_bvh once in a throwaway subprocess: an incompatible
    binary dies there (SIGILL and the like) instead of in the caller."""
    code = (
        "import ctypes,numpy as np;"
        f"lib=ctypes.CDLL({str(so)!r});"
        "n=2;f64=ctypes.POINTER(ctypes.c_double);f32=ctypes.POINTER(ctypes.c_float);"
        "i32=ctypes.POINTER(ctypes.c_int32);u8=ctypes.POINTER(ctypes.c_uint8);"
        "lib.rt_build_bvh.restype=ctypes.c_int64;"
        "amin=np.zeros((n,3));amax=np.ones((n,3));"
        "po=np.empty(n,np.int32);nm=np.empty((4,3),np.float32);nx=np.empty((4,3),np.float32);"
        "nl=np.empty(4,np.int32);nr=np.empty(4,np.int32);lf=np.empty(4,np.uint8);"
        "c=lib.rt_build_bvh(amin.ctypes.data_as(f64),amax.ctypes.data_as(f64),"
        "ctypes.c_int64(n),4,16,po.ctypes.data_as(i32),nm.ctypes.data_as(f32),"
        "nx.ctypes.data_as(f32),nl.ctypes.data_as(i32),nr.ctypes.data_as(i32),"
        "lf.ctypes.data_as(u8),ctypes.c_int64(4));"
        "assert c>0"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, timeout=60)
    return r.returncode == 0


def load_native() -> ctypes.CDLL:
    """The builder's library, compiled and self-tested on first use."""
    global _lib_cache
    with _lock:
        if _lib_cache is not None:
            return _lib_cache
        so = _so_path()
        if not so.exists():
            _compile(so)
            if not _selftest(so):
                so.unlink(missing_ok=True)
                raise RuntimeError(f"native self-test failed for {so}")
        lib = ctypes.CDLL(str(so))
        lib.rt_build_bvh.restype = ctypes.c_int64
        lib.rt_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_double),  # amin
            ctypes.POINTER(ctypes.c_double),  # amax
            ctypes.c_int64,  # n
            ctypes.c_int32,  # leaf_size
            ctypes.c_int32,  # num_bins
            ctypes.POINTER(ctypes.c_int32),  # prim_order
            ctypes.POINTER(ctypes.c_float),  # node_min
            ctypes.POINTER(ctypes.c_float),  # node_max
            ctypes.POINTER(ctypes.c_int32),  # node_left
            ctypes.POINTER(ctypes.c_int32),  # node_right
            ctypes.POINTER(ctypes.c_uint8),  # node_is_leaf
            ctypes.c_int64,  # max_nodes
        ]
        _lib_cache = lib
        return lib


def native_build_bvh(amin: np.ndarray, amax: np.ndarray, leaf_size: int, num_bins: int):
    """C++ binned-SAH build; returns the same ``_HostBvh`` as
    ``ops.bvh.build_bvh``."""
    from ..ops.bvh import _HostBvh

    lib = load_native()
    n = amin.shape[0]
    amin = np.ascontiguousarray(amin, np.float64)
    amax = np.ascontiguousarray(amax, np.float64)
    max_nodes = max(2 * n, 2)
    prim_order = np.empty(n, np.int32)
    node_min = np.empty((max_nodes, 3), np.float32)
    node_max = np.empty((max_nodes, 3), np.float32)
    node_left = np.empty(max_nodes, np.int32)
    node_right = np.empty(max_nodes, np.int32)
    node_is_leaf = np.empty(max_nodes, np.uint8)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    count = lib.rt_build_bvh(
        p(amin, ctypes.c_double), p(amax, ctypes.c_double), n, leaf_size, num_bins,
        p(prim_order, ctypes.c_int32), p(node_min, ctypes.c_float),
        p(node_max, ctypes.c_float), p(node_left, ctypes.c_int32),
        p(node_right, ctypes.c_int32), p(node_is_leaf, ctypes.c_uint8), max_nodes,
    )
    if count <= 0:
        raise RuntimeError(f"rt_build_bvh failed: {count}")
    return _HostBvh(
        node_min=node_min[:count],
        node_max=node_max[:count],
        node_left=node_left[:count],
        node_right=node_right[:count],
        node_is_leaf=node_is_leaf[:count].astype(bool),
        prim_order=prim_order,
    )


__all__ = ["load_native", "native_build_bvh"]
