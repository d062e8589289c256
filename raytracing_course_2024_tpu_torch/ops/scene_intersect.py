"""Scene-level nearest hit and surface shading data of the modular dense
path (the JAX package's ``ops/scene_intersect.py``).

Two phases: a t-only nearest-hit query over the finite table
(``ops/traverse.py:nearest_hit``: the hand-written triangle kernel K4 when
the scene is at most 128 triangles, the BVH walk K6 when it carries a BVH,
otherwise the chunked sweep of this module; infinite planes fold in
afterwards), then a *detail* pass that re-intersects only the winning
primitive per ray for normals and material. The sweep and the plane fold
are plain PyTorch ops on the device, as they are XLA outside any Pallas
kernel in the JAX package. The sweep is K6's plain version too;
``surface_detail`` reads the row K6 returns as it reads the sweep's.

The sweep's (B, K) t matrix is cut in lanes as well as in primitives, so
its temporaries stay near ``SWEEP_ELEMS`` elements each whatever the batch
(the JAX package cuts primitives only); both cuts compute the same
nearest hit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..scene.types import (
    BOX,
    ELLIPSOID,
    PlaneCol as PL,
    PrimCol as PC,
    SceneArrays,
    SceneStatics,
)
from .bvh import build_bvh4_nodes, build_bvh_records, build_light_tree, light_records
from .dense_nearest import build_tri_records
from .gather import take_packed
from .intersect import (
    INF,
    box_normal,
    ellipsoid_normal,
    normal_to_world,
    ray_box_interval,
    ray_ellipsoid_interval,
    ray_plane_t,
    ray_triangle,
    to_local,
)
from .vec import Quat, Vec3, where3

DENSE_CHUNK = 1024  # primitives per step of the dense sweep
SWEEP_ELEMS = 1 << 26  # lanes x primitives per sweep step (256 MB per f32 temp)

# The row-major primitive record N1a gathers its winner from
# (csrc/shade.cu): the PrimCol row of each field, -1 for padding. What a
# triangle lane reads (type, vertices, shading normals, material) fills the
# first 32 floats, one 128-byte line; position and rotation, which only
# boxes and ellipsoids read, follow in the last 8. 160 bytes a primitive.
PREC_COLS = (*range(PC.PTYPE, PC.POS), *range(PC.COLOR, PC.COUNT), -1, -1, -1,
             *range(PC.POS, PC.COLOR), -1)
PREC_WIDTH = len(PREC_COLS)  # 40


def build_prim_records(packed: np.ndarray) -> np.ndarray:
    """(N, PREC_WIDTH) f32 records of the (PrimCol.COUNT, N) pack, one row
    per primitive, zero in the padding."""
    rec = np.zeros((packed.shape[1], PREC_WIDTH), np.float32)
    for k, c in enumerate(PREC_COLS):
        if c >= 0:
            rec[:, k] = packed[c]
    return rec


class ModularScene(NamedTuple):
    """What the modular path reads, on one device: the transposed
    attribute packs of ``SceneArrays``, the same primitives as N1a's
    row-major records (``build_prim_records``), the (9, N) triangle pack of
    K4 and the (N, 12) records its loop reads (both None unless the scene is at
    most 128 triangles), the light spec K3 reads, ``lp_np``, the host
    copy of the light pack the plain sampler takes its per-light constants
    from, and on the BVH backend the tree K6 walks: its (W, 32) 4-wide
    nodes, the (N, 12) primitive records in table order and the stack
    entries its walk can need (all None on the dense backend). Above 32
    lights, on either backend, the tables K3 reads there instead of
    ``light_packed``: one record per light in light order (its pick), the
    same records in the order of the lights' own tree, and that tree's
    nodes and stack bound (``ops/bvh.py:build_light_tree``; None at 32
    lights or fewer)."""

    statics: SceneStatics
    packed: torch.Tensor  # (PrimCol.COUNT, N) f32
    prim_rec: torch.Tensor  # (N, PREC_WIDTH) f32: build_prim_records(packed)
    plane_packed: torch.Tensor  # (PlaneCol.COUNT, P) f32
    pl_mask: torch.Tensor  # (P,) bool: False for padding
    light_packed: torch.Tensor  # (LightCol.COUNT, L) f32
    lspec: torch.Tensor  # (L,) i32: light ptype | rotated << 2
    tri_pack: torch.Tensor | None  # (9, N) f32
    tri_rec: torch.Tensor | None  # (N, 12) f32: build_tri_records(tri_pack)
    lp_np: np.ndarray
    bvh_nodes: torch.Tensor | None = None  # (W, 32) f32: ops/bvh.py:build_bvh4_nodes
    bvh_rec: torch.Tensor | None = None  # (N, 12) f32: ops/bvh.py:build_bvh_records
    bvh_stack: int | None = None  # ops/bvh.py:Bvh4.stack
    light_rec: torch.Tensor | None = None  # (L, LIGHT_REC) f32: ops/bvh.py:light_records
    light_leaf: torch.Tensor | None = None  # (L, LIGHT_REC) f32: light_rec in tree order
    light_nodes: torch.Tensor | None = None  # (W, 32) f32: the lights' 4-wide tree
    light_stack: int | None = None  # ops/bvh.py:LightTree.stack


def modular_scene(scn: SceneArrays, statics: SceneStatics,
                  device) -> ModularScene:
    """The device scene of the modular path; with ``scn.bvh`` set (the
    arrays of ``ops/bvh.py:attach_bvh``) also the tree K6 walks."""

    def dev(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    wide = None if scn.bvh is None else build_bvh4_nodes(scn.bvh)

    lp_np = np.ascontiguousarray(scn.light_packed, dtype=np.float32)
    lspec = [t | (int(r) << 2)
             for t, r in zip(statics.light_types, statics.light_rotated)]
    lspec += [0] * (lp_np.shape[1] - len(lspec))
    tree = build_light_tree(lp_np, statics)
    rec = None if tree is None else light_records(lp_np, lspec)
    return ModularScene(
        statics=statics,
        packed=dev(scn.packed),
        prim_rec=dev(build_prim_records(scn.packed)),
        plane_packed=dev(scn.plane_packed),
        pl_mask=dev(scn.pl_mask, torch.bool),
        light_packed=dev(lp_np),
        lspec=torch.tensor(lspec, dtype=torch.int32, device=device),
        tri_pack=None if scn.tri_pack is None else dev(scn.tri_pack),
        tri_rec=None if scn.tri_pack is None else dev(build_tri_records(scn.tri_pack)),
        lp_np=lp_np,
        bvh_nodes=None if wide is None else dev(wide.nodes),
        bvh_rec=None if scn.bvh is None else dev(build_bvh_records(scn, statics)),
        bvh_stack=None if wide is None else wide.stack,
        light_rec=None if tree is None else dev(rec),
        light_leaf=None if tree is None else dev(rec[tree.order]),
        light_nodes=None if tree is None else dev(tree.nodes),
        light_stack=None if tree is None else tree.stack,
    )


class SceneHit(NamedTuple):
    t: torch.Tensor  # (B,) f32, +inf on a miss
    idx: torch.Tensor  # (B,) i32 into the finite table (or the plane table)
    is_plane: torch.Tensor  # (B,) bool
    valid: torch.Tensor  # (B,) bool


class Surface(NamedTuple):
    """Shading data at a hit point (world space)."""

    t: torch.Tensor
    point: Vec3  # EPS-backed-off hit point
    n_geom: Vec3  # geometric normal, flipped to face the ray
    n_shade: Vec3  # shading normal, flipped to face the ray
    is_outer: torch.Tensor  # bool: the ray entered from outside
    color: Vec3
    metallic: torch.Tensor
    roughness: torch.Tensor
    emission: Vec3
    ior: torch.Tensor
    mkind: torch.Tensor  # material kind (float32, exact)


def _v3(g: torch.Tensor, base: int) -> Vec3:
    return Vec3(g[base], g[base + 1], g[base + 2])


def _q4(g: torch.Tensor, base: int) -> Quat:
    return Quat(g[base], g[base + 1], g[base + 2], g[base + 3])


def _expand(v: Vec3) -> Vec3:
    """(B,) components -> (B, 1), to broadcast against (K,) table rows."""
    return Vec3(v.x[:, None], v.y[:, None], v.z[:, None])


class PrimRef(NamedTuple):
    """Geometry of a batch of primitives, SoA components of shape (K,)."""

    ptype: torch.Tensor
    p0: Vec3
    p1: Vec3
    p2: Vec3
    pos: Vec3
    rot: Quat


def prim_ref_from_table(packed: torch.Tensor, sl=slice(None)) -> PrimRef:
    g = packed[:, sl]
    return PrimRef(ptype=g[PC.PTYPE], p0=_v3(g, PC.P0), p1=_v3(g, PC.P1),
                   p2=_v3(g, PC.P2), pos=_v3(g, PC.POS), rot=_q4(g, PC.ROT))


def _prim_ts(ro_b: Vec3, rd_b: Vec3, prim: PrimRef, statics: SceneStatics,
             tmin) -> torch.Tensor:
    """t matrix (B, K) for a batch of primitives; inf = miss. Picks the
    nearest root strictly above tmin."""
    ro, rd = ro_b, rd_b
    if statics.any_rotation:
        ro, rd = to_local(ro, rd, prim.pos, prim.rot, True)
    elif statics.any_nontri:
        ro = ro - prim.pos

    t_tri, _, _, v_tri = ray_triangle(ro_b, rd_b, prim.p0, prim.p1, prim.p2)
    t = torch.where(v_tri & (t_tri > tmin), t_tri, INF)

    if statics.any_nontri:
        ib = ray_box_interval(ro, rd, prim.p0)
        ie = ray_ellipsoid_interval(ro, rd, prim.p0)

        def nearest_pos(iv):
            t1 = torch.where(iv.valid & (iv.t1 > tmin), iv.t1, INF)
            t2 = torch.where(iv.valid & (iv.t2 > tmin), iv.t2, INF)
            return torch.minimum(t1, t2)

        t = torch.where(prim.ptype == BOX, nearest_pos(ib), t)
        t = torch.where(prim.ptype == ELLIPSOID, nearest_pos(ie), t)
    return t


def _sweep(ro: Vec3, rd: Vec3, packed: torch.Tensor, statics: SceneStatics,
           tmin):
    """Nearest (t, idx) over the whole finite table, DENSE_CHUNK primitives
    at a time; the first index wins a tie, as ``argmin`` does."""
    ro_b, rd_b = _expand(ro), _expand(rd)
    n = packed.shape[1]
    best_t = best_idx = None
    for c0 in range(0, n, DENSE_CHUNK):
        t_mat = _prim_ts(ro_b, rd_b, prim_ref_from_table(packed, slice(c0, c0 + DENSE_CHUNK)),
                         statics, tmin)
        loc = torch.argmin(t_mat, dim=1).to(torch.int32) + c0
        tloc = torch.amin(t_mat, dim=1)
        if best_t is None:
            best_t, best_idx = tloc, loc
            continue
        best_idx = torch.where(tloc < best_t, loc, best_idx)
        best_t = torch.minimum(best_t, tloc)
    return best_t, best_idx


def sweep_nearest(ro: Vec3, rd: Vec3, packed: torch.Tensor, statics: SceneStatics, tmin):
    """Nearest (t, row) over the whole finite table by the chunked sweep,
    ``SWEEP_ELEMS`` lanes x primitives at a time; (inf, 0) on a miss."""
    b = ro.x.shape[0]
    lanes = max(1, SWEEP_ELEMS // min(packed.shape[1], DENSE_CHUNK))
    parts = [
        _sweep(Vec3(*(c[s:s + lanes] for c in ro)), Vec3(*(c[s:s + lanes] for c in rd)),
               packed, statics, tmin)
        for s in range(0, b, lanes)
    ]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _fold_in_planes(ro: Vec3, rd: Vec3, scene: ModularScene, hit: SceneHit,
                    tmin) -> SceneHit:
    """Linear scan over the infinite planes, keeping the closer hit."""
    gp = scene.plane_packed
    o, d = to_local(_expand(ro), _expand(rd), _v3(gp, PL.POS), _q4(gp, PL.ROT), True)
    t, v = ray_plane_t(o, d, _v3(gp, PL.NORMAL))
    t = torch.where(v & (t > tmin) & scene.pl_mask, t, INF)  # (B, P)
    pidx = torch.argmin(t, dim=1).to(torch.int32)
    pt = torch.amin(t, dim=1)
    closer = pt < hit.t
    return SceneHit(
        torch.minimum(hit.t, pt),
        torch.where(closer, pidx, hit.idx),
        closer | hit.is_plane,
        hit.valid | torch.isfinite(pt),
    )


def surface_detail(ro: Vec3, rd: Vec3, hit: SceneHit, scene: ModularScene,
                   tmin=0.0, eps_backoff: float = 1e-4) -> Surface:
    """Re-intersect the winning primitive per ray for normals + material;
    normals face the incoming ray. Every per-ray attribute comes from one
    packed-table gather."""
    statics = scene.statics
    n_tab = scene.packed.shape[1]
    g = take_packed(scene.packed, torch.clamp(hit.idx, 0, n_tab - 1))

    p0 = _v3(g, PC.P0)
    rot = _q4(g, PC.ROT)
    pos = _v3(g, PC.POS)
    o, d = to_local(ro, rd, pos, rot, statics.any_rotation)

    # --- triangle branch
    a, b, c = p0, _v3(g, PC.P1), _v3(g, PC.P2)
    t_tri, u, v, _ = ray_triangle(ro, rd, a, b, c)
    flat_n = (b - a).cross(c - a).normalize()
    tri_front = flat_n.dot(rd) < 0.0
    sn0, sn1, sn2 = _v3(g, PC.SN0), _v3(g, PC.SN1), _v3(g, PC.SN2)
    ns = (sn0 + (sn1 - sn0) * u + (sn2 - sn0) * v).normalize()
    sign_tri = torch.where(tri_front, 1.0, -1.0)
    tri_ng = flat_n * sign_tri
    tri_ns = ns * sign_tri
    n_geom, n_shade, is_outer, t_best = tri_ng, tri_ns, tri_front, t_tri

    if statics.any_nontri:
        ptype = g[PC.PTYPE]
        # --- box
        ib = ray_box_interval(o, d, p0)
        box_outer = ib.valid & (ib.t1 > tmin)
        t_box = torch.where(box_outer, ib.t1, ib.t2)
        bn = box_normal(o + d * t_box, p0)
        bn = where3(box_outer, bn, -bn)
        bn = normal_to_world(bn, rot, statics.any_rotation)
        # --- ellipsoid
        ie = ray_ellipsoid_interval(o, d, p0)
        ell_outer = ie.valid & (ie.t1 > tmin)
        t_ell = torch.where(ell_outer, ie.t1, ie.t2)
        en = ellipsoid_normal(o + d * t_ell, p0)
        en = where3(ell_outer, en, -en)
        en = normal_to_world(en, rot, statics.any_rotation)

        is_box = ptype == BOX
        is_ell = ptype == ELLIPSOID
        t_best = torch.where(is_box, t_box, torch.where(is_ell, t_ell, t_tri))
        n_geom = where3(is_box, bn, where3(is_ell, en, tri_ng))
        n_shade = where3(is_box, bn, where3(is_ell, en, tri_ns))
        is_outer = torch.where(is_box, box_outer,
                               torch.where(is_ell, ell_outer, tri_front))

    color = _v3(g, PC.COLOR)
    metallic = g[PC.METALLIC]
    roughness = g[PC.ROUGHNESS]
    emission = _v3(g, PC.EMISSION)
    ior = g[PC.IOR]
    mkind = g[PC.MKIND]

    if statics.num_planes > 0:
        n_pl = scene.plane_packed.shape[1]
        gp = take_packed(scene.plane_packed, torch.clamp(hit.idx, 0, n_pl - 1))
        prot = _q4(gp, PL.ROT)
        po, pd = to_local(ro, rd, _v3(gp, PL.POS), prot, True)
        pn_local = _v3(gp, PL.NORMAL)
        pt, _ = ray_plane_t(po, pd, pn_local)
        pn_world = normal_to_world(pn_local.normalize(), prot, True)
        p_front = pn_world.dot(rd) < 0.0
        pn = pn_world * torch.where(p_front, 1.0, -1.0)

        ip = hit.is_plane
        t_best = torch.where(ip, pt, t_best)
        n_geom = where3(ip, pn, n_geom)
        n_shade = where3(ip, pn, n_shade)
        is_outer = torch.where(ip, p_front, is_outer)
        color = where3(ip, _v3(gp, PL.COLOR), color)
        metallic = torch.where(ip, gp[PL.METALLIC], metallic)
        roughness = torch.where(ip, gp[PL.ROUGHNESS], roughness)
        emission = where3(ip, _v3(gp, PL.EMISSION), emission)
        ior = torch.where(ip, gp[PL.IOR], ior)
        mkind = torch.where(ip, gp[PL.MKIND], mkind)

    # miss lanes carry t = inf; clamp so the masked math never sees inf
    t_final = torch.where(hit.valid, hit.t, 1.0)
    point = ro + rd * (t_final - eps_backoff)
    return Surface(t=t_final, point=point, n_geom=n_geom, n_shade=n_shade,
                   is_outer=is_outer, color=color, metallic=metallic,
                   roughness=roughness, emission=emission, ior=ior, mkind=mkind)
