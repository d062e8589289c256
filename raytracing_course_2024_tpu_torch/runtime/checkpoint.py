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
"""

from __future__ import annotations

import hashlib
import logging
import os

import numpy as np

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
    acc = np.zeros(shape, np.float64)
    done_spp = 0
    next_chunk = 0
    if os.path.exists(ckpt_path):
        with np.load(ckpt_path) as ck:
            ck_fp = str(ck["scene"]) if "scene" in ck.files else None
            if ck_fp is not None and ck_fp != fprint:
                raise ValueError(
                    f"checkpoint {ckpt_path} was written for a different scene/engine "
                    f"(fingerprint {ck_fp} != {fprint}); refusing to blend two renders "
                    "-- delete it to restart")
            if (tuple(ck["shape"]) == shape and int(ck["seed"]) == seed
                    and int(ck["chunk_spp"]) == chunk_spp):
                acc = ck["sum"]
                done_spp = int(ck["done_spp"])
                next_chunk = int(ck["next_chunk"])
                log.info("resuming from %s: %d/%d spp", ckpt_path, done_spp, total_spp)
            else:
                log.warning("checkpoint %s incompatible; starting over", ckpt_path)

    while done_spp < total_spp:
        this_chunk = min(chunk_spp, total_spp - done_spp)
        # the chunk index is folded into the seed: the sample stream is the
        # same whether or not the job was interrupted
        rad = renderer.render_radiance(seed=seed * 1_000_003 + next_chunk, samples=this_chunk)
        acc += rad.astype(np.float64) * this_chunk
        done_spp += this_chunk
        next_chunk += 1
        tmp = ckpt_path + ".tmp.npz"
        np.savez(tmp, sum=acc, done_spp=done_spp, next_chunk=next_chunk,
                 shape=np.array(shape), seed=seed, chunk_spp=chunk_spp, scene=fprint)
        os.replace(tmp, ckpt_path)
        log.info("checkpoint: %d/%d spp", done_spp, total_spp)

    return (acc / done_spp).astype(np.float32)
