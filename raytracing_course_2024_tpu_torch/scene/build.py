"""Flatten a parsed ``SceneDesc`` into ``SceneArrays`` (numpy SoA).

Host-side numpy code, identical in output to the JAX package's
``scene/build.py`` (the tests compare the two builds field by field).

Replaces the reference's AoS ``Vec<Primitive>`` + boxed shapes
(src/scene.rs:14-39) with flat f32 arrays. The light list duplicates indices
of emissive finite primitives, mirroring the reference's duplicated
``bvh_light_sources`` tree (src/gltf_to_scene.rs:239-242, src/scene.rs:38)
but by index instead of by copy.

Per-light ``inv_area`` is the constant surface-density factor of the
reference's area-sampling pdf (src/distributions.rs:70-81 ``get_local_pdf``):
  box:       1 / (8 (sx sy + sy sz + sz sx))
  triangle:  1 / (|cross(b-a, c-a)| / 2)
  ellipsoid: 1 / (4 pi)  -- the radii-dependent part of the uniform-sphere
             pullback pdf is evaluated per sample point in ops.sampling.
"""

from __future__ import annotations

import numpy as np

from .types import (
    BOX,
    DIELECTRIC,
    ELLIPSOID,
    MIRROR,
    TRI,
    LightCol,
    PlaneCol,
    PrimCol,
    SceneArrays,
    SceneDesc,
    SceneStatics,
)

# geo-table capacity of the fused-bounce kernels (the JAX package keeps it
# in ops/pallas_intersect.py, which imports jax; the value must match)
MAX_PRIMS = 128


def prepare_tri_pack(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
    """(N,3) verts -> (9, N) [a, e1, e2] dense-triangle pack (host side)."""
    a = np.asarray(p0, np.float32)
    e1 = np.asarray(p1, np.float32) - a
    e2 = np.asarray(p2, np.float32) - a
    return np.ascontiguousarray(
        np.stack([a[:, 0], a[:, 1], a[:, 2],
                  e1[:, 0], e1[:, 1], e1[:, 2],
                  e2[:, 0], e2[:, 1], e2[:, 2]])
    )


def build_packs(arr: SceneArrays) -> SceneArrays:
    """Build the transposed attribute packs from the canonical per-field
    arrays: (C, N) f32 tables whose rows are scalar attribute columns."""

    def cols3(a):
        a = np.asarray(a, np.float32)
        return [a[:, 0], a[:, 1], a[:, 2]]

    def cols4(a):
        a = np.asarray(a, np.float32)
        return [a[:, 0], a[:, 1], a[:, 2], a[:, 3]]

    def col(a):
        return [np.asarray(a, np.float32)]

    prim_rows = (
        col(arr.ptype)
        + cols3(arr.p0) + cols3(arr.p1) + cols3(arr.p2)
        + cols3(arr.sn0) + cols3(arr.sn1) + cols3(arr.sn2)
        + cols3(arr.position) + cols4(arr.rotation)
        + cols3(arr.color) + col(arr.metallic) + col(arr.roughness)
        + cols3(arr.emission) + col(arr.ior) + col(arr.mkind)
    )
    packed = np.stack(prim_rows)
    assert packed.shape[0] == PrimCol.COUNT

    li = np.asarray(arr.light_idx)
    light_rows = (
        col(np.asarray(arr.ptype)[li])
        + cols3(np.asarray(arr.p0)[li])
        + cols3(np.asarray(arr.p1)[li])
        + cols3(np.asarray(arr.p2)[li])
        + cols3(np.asarray(arr.position)[li])
        + cols4(np.asarray(arr.rotation)[li])
        + col(arr.light_inv_area)
    )
    light_packed = np.stack(light_rows)
    assert light_packed.shape[0] == LightCol.COUNT

    plane_rows = (
        cols3(arr.pl_normal) + cols3(arr.pl_position) + cols4(arr.pl_rotation)
        + cols3(arr.pl_color) + col(arr.pl_metallic) + col(arr.pl_roughness)
        + cols3(arr.pl_emission) + col(arr.pl_ior) + col(arr.pl_mkind)
    )
    plane_packed = np.stack(plane_rows)
    assert plane_packed.shape[0] == PlaneCol.COUNT

    tri_pack = None
    ptype = np.asarray(arr.ptype)
    if ptype.size and (ptype == TRI).all():
        if ptype.size <= MAX_PRIMS:
            tri_pack = prepare_tri_pack(arr.p0, arr.p1, arr.p2)

    return arr._replace(
        packed=packed,
        light_packed=light_packed,
        plane_packed=plane_packed,
        tri_pack=tri_pack,
    )


def _rot_many(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate rows of v (M,3) by quaternions q (M,4), xyzw convention."""
    qv = q[:, :3]
    w = q[:, 3:4]
    t = 2.0 * np.cross(qv, v)
    return v + w * t + np.cross(qv, t)


def _light_inv_area(ptype: int, p0, p1, p2) -> float:
    if ptype == BOX:
        s = p0
        area = 8.0 * (s[0] * s[1] + s[1] * s[2] + s[2] * s[0])
        return 1.0 / max(area, 1e-30)
    if ptype == TRI:
        area = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0))
        return 1.0 / max(area, 1e-30)
    if ptype == ELLIPSOID:
        return 1.0 / (4.0 * np.pi)
    return 0.0


def build_scene_arrays(desc: SceneDesc, dtype=np.float32):
    """Returns (SceneArrays-of-numpy, SceneStatics)."""
    prims = desc.primitives
    n = len(prims)

    def stack3(attr):
        if n == 0:
            return np.zeros((1, 3), dtype)
        return np.stack([getattr(p, attr) for p in prims]).astype(dtype)

    def stack1(attr, dt=dtype):
        if n == 0:
            return np.zeros((1,), dt)
        return np.array([getattr(p, attr) for p in prims], dtype=dt)

    def stack4(attr):
        if n == 0:
            return np.tile(np.array([0, 0, 0, 1], dtype), (1, 1))
        return np.stack([getattr(p, attr) for p in prims]).astype(dtype)

    ptype = stack1("ptype", np.int32)
    rotation = stack4("rotation")
    position = stack3("position")
    p0, p1, p2 = stack3("p0"), stack3("p1"), stack3("p2")
    sn0, sn1, sn2 = stack3("sn0"), stack3("sn1"), stack3("sn2")

    # Bake triangle transforms into world-space vertices (the reference
    # instead rotates every ray into the local frame, src/geometry.rs:196-223;
    # for triangles both are exact, and baking frees the hot loop entirely).
    tri_rows = np.nonzero(ptype == TRI)[0]
    if tri_rows.size:
        q = rotation[tri_rows].astype(np.float64)
        t = position[tri_rows].astype(np.float64)
        for verts in (p0, p1, p2):
            verts[tri_rows] = (_rot_many(q, verts[tri_rows].astype(np.float64)) + t).astype(dtype)
        for norms in (sn0, sn1, sn2):
            norms[tri_rows] = _rot_many(q, norms[tri_rows].astype(np.float64)).astype(dtype)
        position[tri_rows] = 0.0
        rotation[tri_rows] = np.array([0, 0, 0, 1], dtype)

    any_rotation = bool(
        n > 0
        and np.any(np.abs(rotation - np.array([0, 0, 0, 1], dtype)).max(axis=1) > 1e-7)
    )
    any_nontri = bool(n > 0 and np.any(ptype != TRI))

    # light table
    light_ids = [i for i, p in enumerate(prims) if p.is_emissive]
    num_lights = len(light_ids)
    lpad = max(num_lights, 1)
    light_idx = np.zeros((lpad,), np.int32)
    light_mask = np.zeros((lpad,), bool)
    light_inv_area = np.zeros((lpad,), dtype)
    for j, i in enumerate(light_ids):
        p = prims[i]
        light_idx[j] = i
        light_mask[j] = True
        light_inv_area[j] = _light_inv_area(p.ptype, p.p0, p.p1, p.p2)

    # plane table (padded to >= 1 with a never-hit sentinel)
    planes = desc.planes
    num_planes = len(planes)
    ppad = max(num_planes, 1)

    def pstack3(attr, default):
        out = np.tile(np.asarray(default, dtype), (ppad, 1))
        for j, p in enumerate(planes):
            out[j] = getattr(p, attr)
        return out.astype(dtype)

    def pstack1(attr, default, dt=dtype):
        out = np.full((ppad,), default, dt)
        for j, p in enumerate(planes):
            out[j] = getattr(p, attr)
        return out

    arrays = SceneArrays(
        ptype=ptype,
        p0=p0,
        p1=p1,
        p2=p2,
        sn0=sn0,
        sn1=sn1,
        sn2=sn2,
        position=position,
        rotation=rotation,
        color=stack3("color"),
        metallic=stack1("metallic"),
        roughness=stack1("roughness"),
        emission=stack3("emission"),
        ior=stack1("ior"),
        mkind=stack1("mkind", np.int32),
        pl_normal=pstack3("p0", [0.0, 1.0, 0.0]),
        pl_position=pstack3("position", [0.0, 0.0, 0.0]),
        pl_rotation=(
            np.stack([p.rotation for p in planes]).astype(dtype)
            if num_planes
            else np.tile(np.array([0, 0, 0, 1], dtype), (1, 1))
        ),
        pl_color=pstack3("color", [0.0, 0.0, 0.0]),
        pl_metallic=pstack1("metallic", 0.0),
        pl_roughness=pstack1("roughness", 1.0),
        pl_emission=pstack3("emission", [0.0, 0.0, 0.0]),
        pl_ior=pstack1("ior", 1.5),
        pl_mkind=pstack1("mkind", 0, np.int32),
        pl_mask=(np.arange(ppad) < num_planes),
        light_idx=light_idx,
        light_mask=light_mask,
        light_inv_area=light_inv_area,
        bvh=None,
    )
    ident = np.array([0, 0, 0, 1], dtype)
    statics = SceneStatics(
        num_prims=n,
        num_planes=num_planes,
        num_lights=num_lights,
        any_rotation=any_rotation,
        any_nontri=any_nontri,
        light_types=tuple(int(ptype[i]) for i in light_ids),
        light_rotated=tuple(
            bool(np.abs(rotation[i] - ident).max() > 1e-7) for i in light_ids
        ),
        any_delta=bool(
            np.isin(arrays.mkind, (MIRROR, DIELECTRIC)).any()
            or (num_planes and np.isin(
                arrays.pl_mkind[:num_planes], (MIRROR, DIELECTRIC)).any())
        ),
        mega_spec=_mega_spec(arrays, n, num_planes, rotation, ident),
    )
    return build_packs(arrays), statics


def _mega_spec(arrays, n, num_planes, rotation, ident) -> tuple:
    """Per-entry (kind, rotated, mkind) spec of the unified geo table the
    fused-bounce kernels loop over (ops/bounce.py): finite primitives first,
    then real planes (kind 3). Empty for big scenes."""
    if n + num_planes > MAX_PRIMS:
        return ()
    spec = []
    ptype = np.asarray(arrays.ptype)
    mkind = np.asarray(arrays.mkind)
    for i in range(n):
        rotated = bool(np.abs(rotation[i] - ident).max() > 1e-7)
        spec.append((int(ptype[i]), rotated, int(mkind[i])))
    pl_rot = np.asarray(arrays.pl_rotation)
    pl_mk = np.asarray(arrays.pl_mkind)
    for p in range(num_planes):
        rotated = bool(np.abs(pl_rot[p] - ident).max() > 1e-7)
        spec.append((3, rotated, int(pl_mk[p])))
    return tuple(spec)
