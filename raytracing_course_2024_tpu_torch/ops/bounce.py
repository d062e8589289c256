"""The fused path-tracing bounce: hand-written CUDA kernels and their plain
PyTorch versions.

One bounce runs, per lane, the whole body of the integrator: nearest hit
over the unified geo table (triangle / box / ellipsoid / plane, rotated
entries in their local frame), the winner's attributes, emission and
background, MIS mixture sampling (``ops/mixture.py``), the BRDF weight and
the MIRROR / DIELECTRIC continuation rules. Entry points:

* ``primary_bounce``: camera jitter + bounce 0 of a fresh path (replaces
  the JAX package's ``ops/pallas_bounce.py:_primary_kernel``, K2);
* ``bounce``: one later bounce (``ops/pallas_bounce.py:_kernel``, K1); with
  ``depth`` (lane mode) each lane draws at its own depth in the lane
  engines' layout (``integrator/wavefront.py``);
* ``bounce(..., final_only=True)``: the last depth level, intersect and
  emission only (K1 with sections 4-5 compiled out).

Path state is one (13, B) float32 tensor, channel-major like the JAX
package's 13 SoA lanes: rows ro3, rd3, thr3, rad3, alive (1.0 / 0.0).

Each wrapper runs the plain version only for tensors on the CPU. On a CUDA
tensor it launches the kernel of ``csrc/bounce.cu`` (built on first use by
``ops/kernels.py``) or raises, and counts the launch in
``ops/kernels.py:LAUNCHES``. The kernels walk the scene's entries through
the entry-major records of ``build_loop_records`` and read the (35, M)
table of ``build_geo_rows`` for the winning entry only; the plain versions
read the table alone.

Uniforms come from the counter RNG (``ops/rng.py``): lane ``i`` draws from
``work_key(seed, wid[i] + wid_off)``, in batch mode at counter
``bounce_i * draws_per_bounce(max_tries) + d`` (``batch_ctr``), in lane mode
at the lane engines' counters for depth ``depth[i]`` (``lane_ctr``).

``seed`` and ``wid_off`` are ints or 0-dim int64 tensors on the lanes'
device, on every entry point and its plain version. K1 and K2 read them
from a (2,) int64 device tensor (``ops/rng.py:seed_off``), so a CUDA graph
that captured a launch replays it for any seed and sample offset; the
routes pass two consecutive elements of a pair they own, which reaches the
kernel as it is, with no launch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..scene.types import (
    DIELECTRIC,
    MIRROR,
    TRI,
    BOX,
    ELLIPSOID,
    LightCol,
    SceneArrays,
    SceneStatics,
)
from ..scene.build import MAX_PRIMS
from .brdf import eval_brdf
from .camera import camera_from_row, generate_rays_u
from .intersect import DIR_BIAS, EPS
from .kernels import check, launch_bounce, launch_primary
from .mixture import mixture_body
from .rng import (CTR_JITTER, WF_STRIDE, Ctr, batch_ctr, draws_per_bounce, lane_ctr,
                  offset_ids, seed_off, uniform_ctr, work_key)
from .sampling import UNROLL_MAX_LIGHTS
from .vec import Quat, Vec3, reflect, true_div, where3

EPS_BACKOFF = 1e-4
N_STATE = 13

# unified geo+attr table rows (C_GEO, M): finite prims then real planes
_A = 0  # 0-2: tri vert a | box half-extents | ellipsoid radii | plane normal
_E1 = 3  # 3-5 tri edge 1 (p1 - p0)
_E2 = 6  # 6-8 tri edge 2 (p2 - p0)
_POS = 9  # 9-11
_ROT = 12  # 12-15 quaternion xyzw
_SN0 = 16  # 16-24 shading normals (triangles)
_SN1 = 19
_SN2 = 22
_COLOR = 25
_METAL = 28
_ROUGH = 29
_EMIT = 30  # 30-32
_IOR = 33
_MKIND = 34
C_GEO = 35

def build_geo_rows(scn: SceneArrays, statics: SceneStatics) -> np.ndarray:
    """(C_GEO, M) f32 unified geometry+attribute table: finite primitives
    followed by the real (unpadded) planes, matching statics.mega_spec."""

    def cols3(a):
        return [a[:, 0], a[:, 1], a[:, 2]]

    def cols4(a):
        return [a[:, 0], a[:, 1], a[:, 2], a[:, 3]]

    e1 = scn.p1 - scn.p0  # tri edges; unused junk for box/ellipsoid rows
    e2 = scn.p2 - scn.p0
    rows = (
        cols3(scn.p0) + cols3(e1) + cols3(e2)
        + cols3(scn.position) + cols4(scn.rotation)
        + cols3(scn.sn0) + cols3(scn.sn1) + cols3(scn.sn2)
        + cols3(scn.color) + [scn.metallic, scn.roughness]
        + cols3(scn.emission) + [scn.ior, scn.mkind.astype(np.float32)]
    )
    # the host build pads prim arrays to >= 1 row when num_prims == 0;
    # mega_spec has no entry for that padding, so slice to the real count
    geo = np.stack(rows).astype(np.float32)[:, : statics.num_prims]
    n_pl = statics.num_planes
    if n_pl:
        z = np.zeros((n_pl,), np.float32)
        prows = (
            cols3(scn.pl_normal[:n_pl]) + [z] * 6
            + cols3(scn.pl_position[:n_pl]) + cols4(scn.pl_rotation[:n_pl])
            + [z] * 9
            + cols3(scn.pl_color[:n_pl])
            + [scn.pl_metallic[:n_pl], scn.pl_roughness[:n_pl]]
            + cols3(scn.pl_emission[:n_pl])
            + [scn.pl_ior[:n_pl], scn.pl_mkind[:n_pl].astype(np.float32)]
        )
        geo = np.concatenate([geo, np.stack(prows).astype(np.float32)], axis=1)
    assert geo.shape[0] == C_GEO
    return np.ascontiguousarray(geo)


REC_FLOATS = 12  # one loop record: three float4


def loop_records(codes: np.ndarray, a, e1, e2, pos, rot) -> np.ndarray:
    """(M, 12) f32 records of the kernels' intersection loops, entry-major
    (``csrc/common.cuh:test_entry`` reads them), from per-entry (M, 3) or
    (M, 4) arrays. One record is three float4:

    * a triangle (``codes & 3 == TRI``): ``(a, code) (e1, 0) (e2, 0)``;
    * a box, ellipsoid or plane: ``(half-extents | radii | normal, code)
      (pos, 0) (rot xyzw)``.

    ``codes`` are int32 (kind in bits 0-1, rotated in bit 2), stored bit for
    bit in the float slot (the kernel reads them back as ints)."""
    codes = np.asarray(codes, np.int32)
    tri = (codes & 3) == TRI
    rec = np.zeros((codes.shape[0], 3, 4), np.float32)
    rec[:, 0, :3] = a
    rec[:, 0, 3] = codes.view(np.float32)
    rec[tri, 1, :3] = np.asarray(e1, np.float32)[tri]
    rec[tri, 2, :3] = np.asarray(e2, np.float32)[tri]
    rec[~tri, 1, :3] = np.asarray(pos, np.float32)[~tri]
    rec[~tri, 2, :] = np.asarray(rot, np.float32)[~tri]
    return np.ascontiguousarray(rec.reshape(-1, REC_FLOATS))


def build_loop_records(geo: np.ndarray, spec) -> np.ndarray:
    """The fused kernels' ``loop_records`` from the ``build_geo_rows`` table
    and the scene's ``mega_spec`` (``(kind, rotated, mkind)`` per entry):
    ``code = kind | rotated << 2 | mkind << 3``."""
    m = geo.shape[1]
    if len(spec) != m:
        raise ValueError(f"{len(spec)} spec entries for {m} table columns")
    codes = np.array([k | (int(r) << 2) | (mk << 3) for k, r, mk in spec], np.int32)
    return loop_records(codes, geo[_A:_A + 3].T, geo[_E1:_E1 + 3].T, geo[_E2:_E2 + 3].T,
                        geo[_POS:_POS + 3].T, geo[_ROT:_ROT + 4].T)


def gate_reason(statics: SceneStatics) -> str | None:
    """Why a scene cannot take the fused-bounce path (it then takes the
    modular dense path, ``ops/scene_intersect.py``), or None if it can: the
    JAX package's ``megakernel_eligible``."""
    if not statics.mega_spec or len(statics.mega_spec) > MAX_PRIMS:
        return f"more than {MAX_PRIMS} primitives + planes"
    if statics.num_lights > UNROLL_MAX_LIGHTS:
        return f"more than {UNROLL_MAX_LIGHTS} lights"
    return None


class BounceScene(NamedTuple):
    """What the bounce kernels read, on one device. ``geo_np``/``lp_np`` are
    the host copies the plain versions take their scalar constants from."""

    statics: SceneStatics
    geo: torch.Tensor  # (C_GEO, M) f32
    rec: torch.Tensor  # (M, 12) f32: the kernels' loop records
    lp: torch.Tensor  # (LightCol.COUNT, L) f32
    lspec: torch.Tensor  # (L,) i32: light ptype | rotated << 2
    geo_np: np.ndarray
    lp_np: np.ndarray


def bounce_scene(scn: SceneArrays, statics: SceneStatics,
                 device) -> BounceScene:
    reason = gate_reason(statics)
    if reason:
        raise NotImplementedError(reason)
    geo_np = build_geo_rows(scn, statics)
    lp_np = np.ascontiguousarray(scn.light_packed, dtype=np.float32)
    lspec = [t | (int(r) << 2)
             for t, r in zip(statics.light_types, statics.light_rotated)]
    lspec += [0] * (lp_np.shape[1] - len(lspec))
    return BounceScene(
        statics=statics,
        geo=torch.from_numpy(geo_np).to(device),
        rec=torch.from_numpy(build_loop_records(geo_np, statics.mega_spec)).to(device),
        lp=torch.from_numpy(lp_np).to(device),
        lspec=torch.tensor(lspec, dtype=torch.int32, device=device),
        geo_np=geo_np,
        lp_np=lp_np,
    )


# ---------------------------------------------------------------------------
# plain PyTorch versions (line-for-line ports of ops/pallas_bounce.py)
# ---------------------------------------------------------------------------


def _intersect_all(spec: tuple, geo: np.ndarray, ro: Vec3, rd: Vec3):
    """Nearest hit over the geo table, one entry at a time.

    Returns (best_t, best_i, best_u, best_v, n_geom, is_outer, is_tri):
    ``n_geom`` is the winner's geometric normal flipped to face the ray
    (normalized), ``is_outer`` the entry-side flag per shape."""
    zero = ro.x * 0.0
    best_t = zero + float("inf")
    best_i = torch.zeros_like(zero, dtype=torch.int64)
    best_u = zero
    best_v = zero
    bnx, bny, bnz = zero, zero, zero + 1.0
    best_outer = zero > -1.0  # True
    best_tri = zero

    for i, (kind, rotated, _mk) in enumerate(spec):
        if kind == TRI:
            e1x, e1y, e1z = geo[_E1, i], geo[_E1 + 1, i], geo[_E1 + 2, i]
            e2x, e2y, e2z = geo[_E2, i], geo[_E2 + 1, i], geo[_E2 + 2, i]
            pvx = rd.y * e2z - rd.z * e2y
            pvy = rd.z * e2x - rd.x * e2z
            pvz = rd.x * e2y - rd.y * e2x
            det = e1x * pvx + e1y * pvy + e1z * pvz
            det_ok = torch.abs(det) > 1e-30
            inv_det = 1.0 / torch.where(det_ok, det, 1e-30)
            tvx = ro.x - geo[_A, i]
            tvy = ro.y - geo[_A + 1, i]
            tvz = ro.z - geo[_A + 2, i]
            u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
            qvx = tvy * e1z - tvz * e1y
            qvy = tvz * e1x - tvx * e1z
            qvz = tvx * e1y - tvy * e1x
            v = (rd.x * qvx + rd.y * qvy + rd.z * qvz) * inv_det
            t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
            ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & det_ok & (t > 0.0)
            fnx = e1y * e2z - e1z * e2y
            fny = e1z * e2x - e1x * e2z
            fnz = e1x * e2y - e1y * e2x
            front = (fnx * rd.x + fny * rd.y + fnz * rd.z) < 0.0
            sgn = torch.where(front, 1.0, -1.0)
            cnx, cny, cnz = fnx * sgn, fny * sgn, fnz * sgn
            outer = front
            istri = 1.0
        else:
            px, py, pz = geo[_POS, i], geo[_POS + 1, i], geo[_POS + 2, i]
            o = Vec3(ro.x - px, ro.y - py, ro.z - pz)
            d = rd
            if rotated:
                q = Quat(*(geo[_ROT + c, i] for c in range(4)))
                o, d = q.inverse_rotate(o), q.inverse_rotate(rd)
            ax_, ay_, az_ = geo[_A, i], geo[_A + 1, i], geo[_A + 2, i]

            if kind == BOX:
                ivx = 1.0 / (d.x + DIR_BIAS)
                ivy = 1.0 / (d.y + DIR_BIAS)
                ivz = 1.0 / (d.z + DIR_BIAS)
                lox, hix = (-ax_ - o.x) * ivx, (ax_ - o.x) * ivx
                loy, hiy = (-ay_ - o.y) * ivy, (ay_ - o.y) * ivy
                loz, hiz = (-az_ - o.z) * ivz, (az_ - o.z) * ivz
                t1 = torch.maximum(
                    torch.minimum(lox, hix),
                    torch.maximum(torch.minimum(loy, hiy), torch.minimum(loz, hiz)),
                )
                t2 = torch.minimum(
                    torch.maximum(lox, hix),
                    torch.minimum(torch.maximum(loy, hiy), torch.maximum(loz, hiz)),
                )
                valid = t1 <= t2
                outer = valid & (t1 > 0.0)
                t = torch.where(outer, t1, t2)
                ok = valid & (t > 0.0)
                hx = o.x + d.x * t
                hy = o.y + d.y * t
                hz = o.z + d.z * t
                on_x = (ax_ - torch.abs(hx)) < EPS
                on_y = (ay_ - torch.abs(hy)) < EPS
                cnx = torch.where(on_x, torch.sign(hx), 0.0)
                cny = torch.where(~on_x & on_y, torch.sign(hy), 0.0)
                cnz = torch.where(~on_x & ~on_y, torch.sign(hz), 0.0)
                flip = torch.where(outer, 1.0, -1.0)
                cn = Vec3(cnx * flip, cny * flip, cnz * flip)
            elif kind == ELLIPSOID:
                iox, ioy, ioz = true_div(o.x, ax_), true_div(o.y, ay_), true_div(o.z, az_)
                idx_, idy, idz = true_div(d.x, ax_), true_div(d.y, ay_), true_div(d.z, az_)
                a_q = idx_ * idx_ + idy * idy + idz * idz
                b_q = iox * idx_ + ioy * idy + ioz * idz
                c_q = iox * iox + ioy * ioy + ioz * ioz - 1.0
                disc = b_q * b_q - a_q * c_q
                valid = disc >= 0.0
                sq = torch.sqrt(torch.clamp(disc, min=0.0))
                inv_a = 1.0 / torch.clamp(a_q, min=1e-30)
                t1 = (-b_q - sq) * inv_a
                t2 = (-b_q + sq) * inv_a
                outer = valid & (t1 > 0.0)
                t = torch.where(outer, t1, t2)
                ok = valid & (t > 0.0)
                hx = o.x + d.x * t
                hy = o.y + d.y * t
                hz = o.z + d.z * t
                flip = torch.where(outer, 1.0, -1.0)
                cn = Vec3(
                    true_div(hx, ax_ * ax_) * flip,
                    true_div(hy, ay_ * ay_) * flip,
                    true_div(hz, az_ * az_) * flip,
                )
            else:  # infinite plane (mega_spec kind 3)
                denom = ax_ * d.x + ay_ * d.y + az_ * d.z
                num = ax_ * o.x + ay_ * o.y + az_ * o.z
                den_ok = torch.abs(denom) > 1e-30
                t = -num / torch.where(den_ok, denom, 1e-30)
                ok = den_ok & (t > 0.0)
                outer = denom < 0.0  # front-facing: normal opposes the ray
                flip = torch.where(outer, 1.0, -1.0)
                cn = Vec3(ax_ * flip, ay_ * flip, az_ * flip)

            if rotated:
                cn = q.rotate(cn)
            cnx, cny, cnz = cn.x, cn.y, cn.z
            u = zero
            v = zero
            istri = 0.0

        take = ok & (t < best_t)
        best_t = torch.where(take, t, best_t)
        best_i = torch.where(take, i, best_i)
        best_u = torch.where(take, u, best_u)
        best_v = torch.where(take, v, best_v)
        bnx = torch.where(take, cnx, bnx)
        bny = torch.where(take, cny, bny)
        bnz = torch.where(take, cnz, bnz)
        best_outer = torch.where(take, outer, best_outer)
        best_tri = torch.where(take, istri, best_tri)

    n_geom = Vec3(bnx, bny, bnz).normalize()
    return best_t, best_i, best_u, best_v, n_geom, best_outer, best_tri


def _bounce_math(scene: BounceScene, k_tries: int, bg: tuple, draw, ctr: Ctr,
                 ro: Vec3, rd: Vec3, thr: Vec3, rad: Vec3, alive,
                 final_only: bool = False):
    """Intersect -> detail -> emission -> sampling -> continuation. Returns
    (next origin, next direction, thr', rad', alive'); ``final_only`` stops
    after emission and passes ro/rd/thr through as (point, rd, thr).
    ``draw(c)`` is the lane's uniform at counter ``c``; ``ctr`` says where
    this bounce's draws sit."""
    statics, geo_np = scene.statics, scene.geo_np
    spec = statics.mega_spec
    zero = ro.x * 0.0
    zero3 = Vec3(zero, zero, zero)

    # --- 1. nearest hit -----------------------------------------------------
    best_t, best_i, best_u, best_v, n_geom, is_outer, is_tri = (
        _intersect_all(spec, geo_np, ro, rd)
    )
    hit = torch.isfinite(best_t)

    # --- 2. winner attributes by index --------------------------------------
    geo = scene.geo

    def gather_row(row):
        return geo[row][best_i]

    def a3(base):
        return Vec3(gather_row(base), gather_row(base + 1), gather_row(base + 2))

    if any(k == TRI for k, _, _ in spec):
        sgn = torch.where(is_outer, 1.0, -1.0)
        sn0, sn1, sn2 = a3(_SN0), a3(_SN1), a3(_SN2)
        ns = (sn0 + (sn1 - sn0) * best_u + (sn2 - sn0) * best_v).normalize() * sgn
        n_shade = where3(is_tri > 0.5, ns, n_geom)
    else:
        n_shade = n_geom
    t_safe = torch.where(hit, best_t, 1.0)
    point = ro + rd * (t_safe - EPS_BACKOFF)
    emission = a3(_EMIT)

    # --- 3. emission / background -------------------------------------------
    bgv = Vec3(zero + bg[0], zero + bg[1], zero + bg[2])
    miss = alive & ~hit
    on_hit = alive & hit
    rad = rad + where3(miss, thr.mul(bgv), where3(on_hit, thr.mul(emission), zero3))
    alive = on_hit
    if final_only:
        return point, rd, thr, rad, alive

    color = a3(_COLOR)
    metallic = gather_row(_METAL)
    roughness = gather_row(_ROUGH)
    mkind = gather_row(_MKIND).to(torch.int32)

    # --- 4. mixture sampling ------------------------------------------------
    v_dir = rd * -1.0
    l, pdf, ok = mixture_body(
        draw, ctr, point, n_geom, n_shade, v_dir, roughness, scene.lp_np, statics,
        k_tries,
    )

    # --- 5. continuation: BRDF weight + delta rules -------------------------
    f = eval_brdf(l, n_geom, v_dir, color, metallic, roughness, mkind)
    cos_l = torch.clamp(l.dot(n_geom), min=0.0)
    w = f * (cos_l / torch.clamp(pdf, min=1e-20))

    any_mirror = any(m == MIRROR for _, _, m in spec)
    any_diel = any(m == DIELECTRIC for _, _, m in spec)
    next_origin = point
    if any_mirror or any_diel:
        l_mirror = reflect(v_dir, n_geom)
        is_mirror = mkind == MIRROR
        is_diel = mkind == DIELECTRIC
        is_delta = is_mirror | is_diel
        if any_mirror:
            l = where3(is_mirror, l_mirror, l)
            w = where3(is_mirror, color, w)
        if any_diel:
            ior = gather_row(_IOR)
            u_diel = draw(ctr.base + ctr.diel)
            cos_i = torch.clamp(v_dir.dot(n_geom), 0.0, 1.0)
            eta = torch.where(is_outer, 1.0 / ior, ior)
            sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
            tir = sin2_t > 1.0
            cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
            r0 = torch.square((eta - 1.0) / (eta + 1.0))
            refl_p = r0 + (1.0 - r0) * torch.pow(1.0 - cos_i, 5.0)
            do_reflect = tir | (u_diel < refl_p)
            l_refr = (rd * eta + n_geom * (eta * cos_i - cos_t)).normalize(eps=1e-20)
            l_diel = where3(do_reflect, l_mirror, l_refr)
            one = zero + 1.0
            w_diel = where3(do_reflect | ~is_outer, Vec3(one, one, one), color)
            l = where3(is_diel, l_diel, l)
            w = where3(is_diel, w_diel, w)
            # transmitted rays continue from just PAST the surface
            transmitted = is_diel & ~do_reflect
            point_back = ro + rd * (t_safe + 1e-4)
            next_origin = where3(transmitted, point_back, point)
        new_alive = alive & (is_delta | ok)
    else:
        new_alive = alive & ok

    thr = thr.mul(where3(new_alive, w, zero3))
    return next_origin, l, thr, rad, new_alive


def lane_draws(seed, wid: torch.Tensor, wid_off):
    """``draw(c)``: each lane's uniform at counter ``c`` of its work key.
    ``seed`` and ``wid_off`` are ints or 0-dim int64 tensors on ``wid``'s
    device, read there (``ops/rng.py:offset_ids``, ``work_key``)."""
    key = work_key(seed, offset_ids(wid, wid_off))
    return lambda c: uniform_ctr(key, c)


def _ctr(bounce_i: int, max_tries: int, depth) -> Ctr:
    if depth is None:
        return batch_ctr(bounce_i * draws_per_bounce(max_tries), max_tries)
    return lane_ctr(depth, max_tries)


def _pack(ro: Vec3, rd: Vec3, thr: Vec3, rad: Vec3, alive) -> torch.Tensor:
    return torch.stack([*ro, *rd, *thr, *rad, alive.to(torch.float32)])


def bounce_plain(scene: BounceScene, state: torch.Tensor, wid: torch.Tensor,
                 wid_off, seed, bounce_i: int, bg: tuple,
                 max_tries: int = 4, final_only: bool = False,
                 depth: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of ``bounce``; returns a new (13, B) state."""
    s = state
    out = _bounce_math(
        scene, max_tries, bg, lane_draws(seed, wid, wid_off),
        _ctr(bounce_i, max_tries, depth), Vec3(s[0], s[1], s[2]), Vec3(s[3], s[4], s[5]),
        Vec3(s[6], s[7], s[8]), Vec3(s[9], s[10], s[11]), s[12] > 0.5,
        final_only=final_only,
    )
    return _pack(*out)


def primary_plain(scene: BounceScene, cam_row: torch.Tensor, px: torch.Tensor,
                  py: torch.Tensor, wid: torch.Tensor, wid_off, seed,
                  bg: tuple, max_tries: int, width: int,
                  height: int) -> torch.Tensor:
    """Plain version of ``primary_bounce``: jitter draws 0 and 1, the camera
    ray (``generate_rays_u``), then bounce 0 of a fresh path."""
    draw = lane_draws(seed, wid, wid_off)
    ro, rd = generate_rays_u(camera_from_row(cam_row), px, py, width, height,
                             draw(CTR_JITTER), draw(CTR_JITTER + 1))
    zero = px * 0.0
    one = zero + 1.0
    out = _bounce_math(
        scene, max_tries, bg, draw, _ctr(0, max_tries, None), ro, rd, Vec3(one, one, one),
        Vec3(zero, zero, zero), zero < 1.0,
    )
    return _pack(*out)


# ---------------------------------------------------------------------------
# wrappers: plain version on the CPU, the CUDA kernel on a CUDA tensor
# ---------------------------------------------------------------------------


def check_scene(scene: BounceScene, device) -> None:
    m = scene.geo.shape[1]
    nl = scene.lp.shape[1]
    if m > MAX_PRIMS or nl > UNROLL_MAX_LIGHTS:
        raise ValueError(f"geo table M={m} > {MAX_PRIMS} or lights {nl} > "
                         f"{UNROLL_MAX_LIGHTS}")
    check("geo", scene.geo, torch.float32, (C_GEO, m), device)
    check("lp", scene.lp, torch.float32, (LightCol.COUNT, nl), device)
    check("rec", scene.rec, torch.float32, (m, REC_FLOATS), device)
    check("lspec", scene.lspec, torch.int32, (nl,), device)


def bounce(scene: BounceScene, state: torch.Tensor, wid: torch.Tensor,
           wid_off, seed, bounce_i: int, bg: tuple,
           max_tries: int = 4, final_only: bool = False,
           out: torch.Tensor | None = None,
           depth: torch.Tensor | None = None,
           count: torch.Tensor | None = None) -> torch.Tensor:
    """One fused bounce of the (13, B) path state.

    ``depth`` (int32 (B,)) selects lane mode: lane ``i`` draws at depth
    ``depth[i]`` of the lane engines' layout and ``bounce_i`` is unused.
    ``count`` (a 0-dim int64 tensor) gets the lanes alive on entry added:
    the path vertices of this level, counted by the kernel itself.
    On CUDA, ``out`` may be ``state`` itself: one thread reads a lane and
    then writes it, so the update runs in place (the JAX kernel wrote
    fresh buffers; in place saves 13 x 4 B per lane of device memory)."""
    if state.device.type == "cpu":
        if count is not None:
            count += (state[12] > 0.5).sum()
        res = bounce_plain(scene, state, wid, wid_off, seed, bounce_i, bg,
                           max_tries, final_only, depth)
        if out is None:
            return res
        out.copy_(res)
        return out
    if state.device.type != "cuda":
        raise ValueError(f"no bounce kernel for device {state.device}")
    b = state.shape[1]
    check("state", state, torch.float32, (N_STATE, b), state.device)
    check("wid", wid, torch.int32, (b,), state.device)
    if depth is not None:
        check("depth", depth, torch.int32, (b,), state.device)
    if count is not None:
        check("count", count, torch.int64, (), state.device)
    check_scene(scene, state.device)
    if out is None:
        out = torch.empty_like(state)
    check("out", out, torch.float32, (N_STATE, b), state.device)
    pair = seed_off(seed, wid_off, state.device)
    check("seed_off", pair, torch.int64, (2,), state.device)
    # lane mode: the kernel adds WF_STRIDE * depth[i] to the depth-0 layout
    ctr = _ctr(bounce_i, max_tries, None if depth is None else 0)
    launch_bounce(scene, state, out, wid, pair, ctr, depth, WF_STRIDE, bg, max_tries,
                  final_only, count)
    return out


def primary_bounce(scene: BounceScene, cam_row: torch.Tensor,
                   px: torch.Tensor, py: torch.Tensor, wid: torch.Tensor,
                   wid_off, seed, bg: tuple, max_tries: int,
                   width: int, height: int,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """Camera jitter + bounce 0 for a fresh path per lane through pixel
    (px, py); returns the (13, B) state after the bounce."""
    if px.device.type == "cpu":
        res = primary_plain(scene, cam_row, px, py, wid, wid_off, seed, bg,
                            max_tries, width, height)
        if out is None:
            return res
        out.copy_(res)
        return out
    if px.device.type != "cuda":
        raise ValueError(f"no bounce kernel for device {px.device}")
    b = px.shape[0]
    dev = px.device
    check("px", px, torch.float32, (b,), dev)
    check("py", py, torch.float32, (b,), dev)
    check("wid", wid, torch.int32, (b,), dev)
    check("cam_row", cam_row, torch.float32, (128,), dev)
    check_scene(scene, dev)
    if out is None:
        out = torch.empty((N_STATE, b), dtype=torch.float32, device=dev)
    check("out", out, torch.float32, (N_STATE, b), dev)
    pair = seed_off(seed, wid_off, dev)
    check("seed_off", pair, torch.int64, (2,), dev)
    launch_primary(scene, cam_row, px, py, out, wid, pair, _ctr(0, max_tries, None), bg,
                   max_tries, width, height)
    return out
