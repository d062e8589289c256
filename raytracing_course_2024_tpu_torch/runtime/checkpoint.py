"""Sample-accumulation checkpoint and resume (the JAX package's
``runtime/checkpoint.py``).

A long frame (1024 spp) renders in spp chunks. After each chunk the whole
render state, the f64 radiance sum, the samples done and the next chunk's
index, is written to an ``.npz`` (to a temporary file, then moved into place
with ``os.replace``, so a crash leaves the last complete checkpoint). A
restarted job resumes from the last completed chunk. Chunk ``c`` renders
with seed ``seed * 1_000_003 + c`` and every draw is keyed by (seed,
sample, pixel), so a resumed frame equals the uninterrupted one bit for bit
on every engine. Any renderer with ``.settings``, ``.engine``, ``.backend``,
``.arrays`` and ``render_radiance(seed=, samples=)`` will do: ``Renderer``
and ``ShardedRenderer``.

In a process group (``parallel.init_distributed``), every process calls
``render_with_checkpoints`` and every process renders each chunk (a
``ShardedRenderer`` across processes returns the same frame on each).
Process 0 alone reads and writes the ``.npz``; on resume it broadcasts the
samples done, the next chunk and the f64 sum to the others, so every
process ends with the same frame. Whatever process 0 raises while it reads
or writes (a refused resume, an unreadable file, a failed write) is
broadcast too and raises on every process, so that none is left waiting
in the next collective.
"""

from __future__ import annotations

import hashlib
import logging
import os

import numpy as np
import torch.distributed as dist

log = logging.getLogger("rt_torch")


def _leaves(tree):
    """The arrays of a NamedTuple of arrays (nested tuples walked, None
    skipped), in field order."""
    for leaf in tree:
        if leaf is None:
            continue
        if isinstance(leaf, tuple):
            yield from _leaves(leaf)
        else:
            yield leaf


def scene_fingerprint(renderer) -> str:
    """Hex digest of the scene and the engine configuration: width, height,
    depth, background, engine, backend, the camera and every array of
    ``renderer.arrays`` (the BVH's too). Guards resume against blending two
    renders of different scenes at the same size and seed. It is the port's
    own digest, not the JAX package's."""
    h = hashlib.sha256()
    s = renderer.settings
    h.update(repr((
        s.width, s.height, s.ray_depth, tuple(float(c) for c in s.bg_color),
        renderer.engine, renderer.backend,
    )).encode())
    cam = s.camera
    h.update(np.asarray([
        *cam.position, *cam.right, *cam.up, *cam.forward, cam.fov_x,
    ], np.float64).tobytes())
    for leaf in _leaves(renderer.arrays):
        h.update(np.ascontiguousarray(leaf).tobytes())
    return h.hexdigest()[:32]


def render_with_checkpoints(renderer, ckpt_path: str, total_spp: int | None = None,
                            chunk_spp: int = 32, seed: int = 0) -> np.ndarray:
    """Mean radiance (H, W, 3) f32, checkpointing after every spp chunk.

    Resumes from ``ckpt_path`` when it exists: a checkpoint of another
    scene or engine raises ``ValueError``; one of another shape, seed or
    chunk size is ignored with a warning and the frame starts over."""
    s = renderer.settings
    total_spp = total_spp or s.samples
    shape = (s.height, s.width, 3)

    fprint = scene_fingerprint(renderer)
    group = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if group else 0
    state = _on_rank0(rank, group, _read, ckpt_path, fprint, shape, seed, chunk_spp,
                      total_spp)
    acc, done_spp, next_chunk = state or (np.zeros(shape, np.float64), 0, 0)

    while done_spp < total_spp:
        this_chunk = min(chunk_spp, total_spp - done_spp)
        # the chunk index is folded into the seed: the sample stream is the
        # same whether or not the job was interrupted
        rad = renderer.render_radiance(seed=seed * 1_000_003 + next_chunk, samples=this_chunk)
        acc += rad.astype(np.float64) * this_chunk
        done_spp += this_chunk
        next_chunk += 1
        _on_rank0(rank, group, _write, ckpt_path, acc, done_spp, next_chunk, shape, seed,
                  chunk_spp, fprint)
        if rank == 0:
            log.info("checkpoint: %d/%d spp", done_spp, total_spp)

    return (acc / done_spp).astype(np.float32)


def _on_rank0(rank: int, group: bool, fn, *args):
    """``fn(*args)`` on process 0; in a group its result, or what it raised,
    is broadcast to every process. Process 0 raises its own exception; the
    others raise a ``ValueError`` (for a refused resume) or a
    ``RuntimeError`` with its type and message."""
    out, err = None, None
    if rank == 0:
        try:
            out = fn(*args)
        except Exception as e:  # re-raised below, on every process
            if not group:
                raise
            err = e
    if not group:
        return out
    box = [(out, None if err is None
            else (isinstance(err, ValueError), f"{type(err).__name__}: {err}"))]
    dist.broadcast_object_list(box, src=0)
    out, failed = box[0]
    if err is not None:
        raise err
    if failed is not None:
        refused, msg = failed
        raise (ValueError if refused else RuntimeError)(f"process 0: {msg}")
    return out


def _write(ckpt_path: str, acc: np.ndarray, done_spp: int, next_chunk: int, shape: tuple,
           seed: int, chunk_spp: int, fprint: str) -> None:
    tmp = ckpt_path + ".tmp.npz"
    np.savez(tmp, sum=acc, done_spp=done_spp, next_chunk=next_chunk, shape=np.array(shape),
             seed=seed, chunk_spp=chunk_spp, scene=fprint)
    os.replace(tmp, ckpt_path)


def _read(ckpt_path: str, fprint: str, shape: tuple, seed: int, chunk_spp: int,
          total_spp: int):
    """(f64 sum, samples done, next chunk) of a checkpoint this frame can
    resume, else None. Raises ``ValueError`` for another scene or engine."""
    if not os.path.exists(ckpt_path):
        return None
    with np.load(ckpt_path) as ck:
        ck_fp = str(ck["scene"]) if "scene" in ck.files else None
        if ck_fp is not None and ck_fp != fprint:
            raise ValueError(
                f"checkpoint {ckpt_path} was written for a different scene/engine "
                f"(fingerprint {ck_fp} != {fprint}); refusing to blend two renders "
                "-- delete it to restart")
        if (tuple(ck["shape"]) == shape and int(ck["seed"]) == seed
                and int(ck["chunk_spp"]) == chunk_spp):
            done_spp = int(ck["done_spp"])
            log.info("resuming from %s: %d/%d spp", ckpt_path, done_spp, total_spp)
            return ck["sum"], done_spp, int(ck["next_chunk"])
    log.warning("checkpoint %s incompatible; starting over", ckpt_path)
    return None
