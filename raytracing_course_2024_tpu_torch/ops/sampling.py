"""Importance-sampling distributions and the one-sample MIS mixture.

Port of the JAX package's ``ops/sampling.py`` (the reference's
src/distributions.rs): cosine-weighted hemisphere, GGX visible-NDF and
light-surface sampling from caller-supplied uniforms, their pdfs, and the
light pdf summed over every light-primitive hit along the sampled ray.

The light table ``lp`` is the (LightCol.COUNT, L) pack as a host numpy
float32 array: per-light entries enter the lane math as scalar constants,
like the JAX package's statically unrolled light loop. Above
``UNROLL_MAX_LIGHTS`` lights the pdf is one vectorized (B, L) sweep over
the whole table (``_pdf_lights_vectorized``), as in the JAX package; the
modular dense path takes it, the fused kernels never see such scenes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..scene.types import BOX, ELLIPSOID, TRI, LightCol as LC, SceneStatics
from .intersect import (
    box_normal,
    ellipsoid_normal,
    normal_to_world,
    ray_box_interval,
    ray_ellipsoid_interval,
    ray_triangle,
    to_local,
)
from .vec import Quat, Vec3, reflect, true_div, where3

PI = math.pi
_SAFE = 1e-9
UNROLL_MAX_LIGHTS = 32

# the reference's fixed tangent-frame seed vector, pre-normalized
_T_NORM = math.sqrt(0.234**2 + 0.1234**2 + 0.97686**2)
_T_SEED = (0.234 / _T_NORM, 0.1234 / _T_NORM, 0.97686 / _T_NORM)


def tangent_frame(n: Vec3):
    """(t1, t2): t1 = normalize(n x seed), t2 = normalize(n x t1)."""
    seed = Vec3(
        torch.full_like(n.x, _T_SEED[0]),
        torch.full_like(n.x, _T_SEED[1]),
        torch.full_like(n.x, _T_SEED[2]),
    )
    t1 = n.cross(seed).normalize()
    t2 = n.cross(t1).normalize()
    return t1, t2


def to_frame_local(t1: Vec3, t2: Vec3, n: Vec3, v: Vec3) -> Vec3:
    return Vec3(v.dot(t1), v.dot(t2), v.dot(n))


def from_frame_local(t1: Vec3, t2: Vec3, n: Vec3, v: Vec3) -> Vec3:
    return t1 * v.x + t2 * v.y + n * v.z


def unit_sphere_from_uniforms(u1: torch.Tensor, u2: torch.Tensor) -> Vec3:
    """Uniform point on the unit sphere, (z, phi) parameterization."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = (2.0 * PI) * u2
    return Vec3(r * torch.cos(phi), r * torch.sin(phi), z)


def sample_cosine_u(u1, u2, n: Vec3) -> Vec3:
    sph = unit_sphere_from_uniforms(u1, u2)
    return (sph + n).normalize(eps=1e-12)


def pdf_cosine(n: Vec3, l: Vec3) -> torch.Tensor:
    return true_div(torch.clamp(l.dot(n), min=0.0), PI)


def _sample_ggx_vndf_local(u0, u1, v_local: Vec3, alpha) -> Vec3:
    vh = Vec3(alpha * v_local.x, alpha * v_local.y, v_local.z).normalize(eps=1e-20)
    lensq = vh.x * vh.x + vh.y * vh.y
    inv_len = torch.rsqrt(torch.clamp(lensq, min=1e-20))
    has_xy = lensq > 1e-20
    zero = torch.zeros_like(vh.x)
    t1 = where3(
        has_xy,
        Vec3(-vh.y * inv_len, vh.x * inv_len, zero),
        Vec3(torch.ones_like(vh.x), zero, zero),
    )
    t2 = vh.cross(t1)
    r = torch.sqrt(u0)
    phi = 2.0 * PI * u1
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh.z)
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    nh = t1 * p1 + t2 * p2 + vh * torch.sqrt(
        torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0)
    )
    return Vec3(alpha * nh.x, alpha * nh.y, torch.clamp(nh.z, min=0.0)).normalize(
        eps=1e-20
    )


def sample_vndf_u(u0, u1, n: Vec3, v: Vec3, roughness) -> Vec3:
    alpha = roughness * roughness
    t1, t2 = tangent_frame(n)
    v_local = to_frame_local(t1, t2, n, v)
    ne_local = _sample_ggx_vndf_local(u0, u1, v_local, alpha)
    ne = from_frame_local(t1, t2, n, ne_local)
    return reflect(v, ne)


def _ggx_d_local(m: Vec3, alpha) -> torch.Tensor:
    a2 = alpha * alpha
    q = (m.x * m.x + m.y * m.y) / torch.clamp(a2, min=1e-20) + m.z * m.z
    return 1.0 / torch.clamp(PI * a2 * q * q, min=1e-20)


def _g1_local(v: Vec3, alpha) -> torch.Tensor:
    z2 = torch.clamp(v.z * v.z, min=1e-20)
    under = 1.0 + alpha * alpha * (v.x * v.x + v.y * v.y) / z2
    lam = 0.5 * (torch.sqrt(under) - 1.0)
    return 1.0 / (1.0 + lam)


def _nonzero(x: torch.Tensor, floor: float) -> torch.Tensor:
    return torch.where(torch.abs(x) > floor, x, floor)


def pdf_vndf(n: Vec3, l: Vec3, v: Vec3, roughness) -> torch.Tensor:
    """D_v(h) / (4 v.h) in the tangent frame; zero for below-horizon h."""
    alpha = roughness * roughness
    t1, t2 = tangent_frame(n)
    vl = to_frame_local(t1, t2, n, v)
    ll = to_frame_local(t1, t2, n, l)
    h = (vl + ll).normalize(eps=1e-20)
    dv = (
        _g1_local(vl, alpha)
        * torch.clamp(vl.dot(h), min=0.0)
        * _ggx_d_local(h, alpha)
        / _nonzero(vl.z, _SAFE)
    )
    denom = 4.0 * vl.dot(h)
    pdf = dv / _nonzero(denom, _SAFE)
    return torch.where((vl.z > 0.0) & (denom > 0.0) & (h.z > 0.0), pdf, 0.0)


def _light_row(lp: np.ndarray, li: torch.Tensor, k: int,
               lp_dev: torch.Tensor | None = None) -> torch.Tensor:
    if lp_dev is not None:
        return lp_dev[k][li]
    col = torch.from_numpy(np.ascontiguousarray(lp[k])).to(li.device)
    return col[li]


def sample_light_dir_u(u: list, point: Vec3, lp: np.ndarray,
                       statics: SceneStatics, lp_dev: torch.Tensor | None = None) -> Vec3:
    """Uniformly pick one emissive primitive, area-sample a surface point and
    return the unit direction from ``point`` toward it. ``u`` = six U(0,1)
    rows: five shape-sampling draws then the light pick. ``lp_dev``, the
    same light pack on the lanes' device, saves a host-to-device copy of
    each row (and lets the call run inside a CUDA graph capture)."""
    li = torch.clamp(
        (u[5] * statics.num_lights).to(torch.int32), max=statics.num_lights - 1
    ).long()

    def v3r(base):
        return Vec3(*(_light_row(lp, li, base + c, lp_dev) for c in range(3)))

    ptype = _light_row(lp, li, LC.PTYPE, lp_dev)
    p0, p1, p2, pos = v3r(LC.P0), v3r(LC.P1), v3r(LC.P2), v3r(LC.POS)
    rot = Quat(*(_light_row(lp, li, LC.ROT + c, lp_dev) for c in range(4)))

    # box face sampling
    s = p0
    wx = 4.0 * s.y * s.z
    wy = 4.0 * s.x * s.z
    wz = 4.0 * s.x * s.y
    w = wx + wy + wz
    x = u[0] * w
    sign = torch.where(u[1] < 0.5, 1.0, -1.0)
    cu = u[2] * 2.0 - 1.0
    cv = u[3] * 2.0 - 1.0
    on_x = x < wx
    on_y = (~on_x) & (x < wx + wy)
    box_pt = where3(
        on_x,
        Vec3(s.x * sign, cu * s.y, cv * s.z),
        where3(
            on_y,
            Vec3(cu * s.x, s.y * sign, cv * s.z),
            Vec3(cu * s.x, cv * s.y, s.z * sign),
        ),
    )

    # triangle sampling with uv folding
    tu, tv = u[0], u[1]
    fold = tu + tv >= 1.0
    tu = torch.where(fold, 1.0 - tu, tu)
    tv = torch.where(fold, 1.0 - tv, tv)
    tri_pt = p0 + (p1 - p0) * tu + (p2 - p0) * tv

    # ellipsoid: uniform unit sphere scaled by radii
    sph = unit_sphere_from_uniforms(u[2], u[4])
    ell_pt = Vec3(sph.x * s.x, sph.y * s.y, sph.z * s.z)

    local = where3(
        ptype == BOX, box_pt, where3(ptype == ELLIPSOID, ell_pt, tri_pt)
    )
    world = rot.rotate(local) + pos
    return (world - point).normalize(eps=1e-20)


def _ellipsoid_jac(p_loc: Vec3, s: Vec3) -> torch.Tensor:
    usph = p_loc.div(s)
    return torch.sqrt(
        torch.clamp(
            (usph.x * s.y * s.z) ** 2
            + (s.x * usph.y * s.z) ** 2
            + (s.x * s.y * usph.z) ** 2,
            min=1e-20,
        )
    )


def pdf_lights_lp(point: Vec3, l: Vec3, lp: np.ndarray,
                  statics: SceneStatics, lp_dev: torch.Tensor | None = None) -> torch.Tensor:
    """Mixture-light pdf: for the ray (point, l), the area->solid-angle pdf
    summed over EVERY light-primitive intersection, divided by the light
    count. One pass per light, each with its own shape's math; above
    ``UNROLL_MAX_LIGHTS`` lights one (B, L) sweep instead, which reads the
    table from ``lp_dev`` when given."""
    if len(statics.light_types) > UNROLL_MAX_LIGHTS:
        return _pdf_lights_vectorized(point, l, lp, statics, lp_dev)
    total = point.x * 0.0

    def contrib(t, n_dot_l, local_pdf, valid):
        denom = torch.clamp(torch.abs(n_dot_l), min=_SAFE)
        return torch.where(valid & (t > 0.0), local_pdf * t * t / denom, 0.0)

    for j, ptype in enumerate(statics.light_types):
        def c(k, j=j):
            return lp[k, j]

        def cv3(k, j=j):
            return Vec3(lp[k, j], lp[k + 1, j], lp[k + 2, j])

        inv_area = c(LC.INV_AREA)
        if ptype == TRI:
            p0, p1, p2 = cv3(LC.P0), cv3(LC.P1), cv3(LC.P2)
            t_tri, _, _, v_tri = ray_triangle(point, l, p0, p1, p2)
            tri_n = _normalize_scalar((p1 - p0).cross(p2 - p0), 1e-20)
            total = total + contrib(t_tri, tri_n.dot(l), inv_area, v_tri)
            continue

        pos = cv3(LC.POS)
        rot = Quat(c(LC.ROT), c(LC.ROT + 1), c(LC.ROT + 2), c(LC.ROT + 3))
        rotated = statics.light_rotated[j]
        o, d = to_local(point, l, pos, rot, rotated)
        s = cv3(LC.P0)
        if ptype == BOX:
            ib = ray_box_interval(o, d, s)
            for t_root in (ib.t1, ib.t2):
                p_loc = o + d * t_root
                n_w = normal_to_world(box_normal(p_loc, s), rot, rotated)
                total = total + contrib(t_root, n_w.dot(l), inv_area, ib.valid)
        else:  # ELLIPSOID: pullback pdf 1/(4 pi |J|)
            ie = ray_ellipsoid_interval(o, d, s)
            for t_root in (ie.t1, ie.t2):
                p_loc = o + d * t_root
                n_w = normal_to_world(ellipsoid_normal(p_loc, s), rot, rotated)
                jac = _ellipsoid_jac(p_loc, s)
                total = total + contrib(
                    t_root, n_w.dot(l), inv_area / jac, ie.valid
                )

    return true_div(total, max(statics.num_lights, 1))


def _pdf_lights_vectorized(point: Vec3, l: Vec3, lp: np.ndarray,
                           statics: SceneStatics,
                           lp_dev: torch.Tensor | None = None) -> torch.Tensor:
    """(B, L) masked sweep over the whole light table (the JAX package's
    ``_pdf_lights_vectorized``): every shape's math on every light, the
    light's own type selected, summed over lights."""
    n_l = lp.shape[1]
    tab = (torch.from_numpy(np.ascontiguousarray(lp)).to(point.x.device)
           if lp_dev is None else lp_dev)

    def row(k):
        return tab[k][None, :]  # (1, L)

    def rv3(k):
        return Vec3(row(k), row(k + 1), row(k + 2))

    ptype = row(LC.PTYPE)
    inv_area = row(LC.INV_AREA)
    p0, p1, p2 = rv3(LC.P0), rv3(LC.P1), rv3(LC.P2)
    pos = rv3(LC.POS)
    rot = Quat(row(LC.ROT), row(LC.ROT + 1), row(LC.ROT + 2), row(LC.ROT + 3))
    real = (torch.arange(n_l, device=tab.device) < statics.num_lights)[None, :]

    pt = Vec3(point.x[:, None], point.y[:, None], point.z[:, None])
    lb = Vec3(l.x[:, None], l.y[:, None], l.z[:, None])
    any_rot = any(statics.light_rotated)

    def contrib(t, n_dot_l, local_pdf, valid):
        denom = torch.clamp(torch.abs(n_dot_l), min=_SAFE)
        return torch.where(valid & real & (t > 0.0), local_pdf * t * t / denom, 0.0)

    # triangles: world-space vertices (the host build bakes transforms in)
    t_tri, _, _, v_tri = ray_triangle(pt, lb, p0, p1, p2)
    tri_n = (p1 - p0).cross(p2 - p0).normalize(eps=1e-20)
    total = torch.where(ptype == TRI, contrib(t_tri, tri_n.dot(lb), inv_area, v_tri), 0.0)

    # boxes and ellipsoids: local frame, both roots
    o, d = to_local(pt, lb, pos, rot, any_rot)
    s = p0
    ib = ray_box_interval(o, d, s)
    ie = ray_ellipsoid_interval(o, d, s)
    box_sum = torch.zeros_like(total)
    ell_sum = torch.zeros_like(total)
    for t_root in (ib.t1, ib.t2):
        p_loc = o + d * t_root
        n_w = normal_to_world(box_normal(p_loc, s), rot, any_rot)
        box_sum = box_sum + contrib(t_root, n_w.dot(lb), inv_area, ib.valid)
    for t_root in (ie.t1, ie.t2):
        p_loc = o + d * t_root
        n_w = normal_to_world(ellipsoid_normal(p_loc, s), rot, any_rot)
        ell_sum = ell_sum + contrib(t_root, n_w.dot(lb), inv_area / _ellipsoid_jac(p_loc, s),
                                    ie.valid)
    total = torch.where(ptype == BOX, box_sum, total)
    total = torch.where(ptype == ELLIPSOID, ell_sum, total)
    return true_div(torch.sum(total, dim=1), max(statics.num_lights, 1))


def _normalize_scalar(v: Vec3, eps: float) -> Vec3:
    """``Vec3.normalize`` for a per-light constant (numpy float32 parts)."""
    n2 = np.float32(v.x * v.x + v.y * v.y + v.z * v.z)
    inv = np.float32(1.0) / np.sqrt(np.maximum(n2, np.float32(eps)))
    return Vec3(v.x * inv, v.y * inv, v.z * inv)


def sample_mixture(uniforms: list, point: Vec3, n_geom: Vec3, n_shade: Vec3,
                   v: Vec3, roughness, lp: np.ndarray, statics: SceneStatics,
                   max_tries: int = 4, need: torch.Tensor | None = None,
                   faithful: bool = False, lp_dev: torch.Tensor | None = None):
    """The JAX package's ``sample_mixture`` fed explicit uniforms:
    ``uniforms`` = 7 rows of (K*B,), candidate-major. Returns (l, pdf, ok);
    lanes with no accepted candidate get l = 0 and ok False, and ``ok`` is
    masked with ``need`` when given.

    ``faithful=False`` accepts a candidate on l.n_shade > 0 and
    l.n_geom > 0 and evaluates the mixture pdf for the chosen one only;
    ``faithful=True`` is the reference's acceptance: the full mixture pdf of
    every candidate, accepted on l.n_shade > 0 and pdf > 0. ``lp_dev`` is
    ``lp`` on the lanes' device (``ModularScene.light_packed``): with it
    the sampler makes no host-to-device copy and may be captured in a CUDA
    graph."""
    n_comp = 3 if statics.num_lights > 0 else 2
    b = point.x.shape[0]
    k = max_tries

    def tile(x):
        return x.unsqueeze(0).expand(k, b).reshape(k * b)

    def tile3(vec: Vec3) -> Vec3:
        return Vec3(tile(vec.x), tile(vec.y), tile(vec.z))

    point_t, n_t, v_t, rough_t = tile3(point), tile3(n_geom), tile3(v), tile(roughness)
    u = uniforms
    which = torch.clamp((u[0] * n_comp).to(torch.int32), max=n_comp - 1)
    cand = sample_cosine_u(u[1], u[2], n_t)
    cand = where3(which == 1, sample_vndf_u(u[1], u[2], n_t, v_t, rough_t), cand)
    if statics.num_lights > 0:
        cand = where3(which == 2, sample_light_dir_u(u[1:7], point_t, lp, statics, lp_dev),
                      cand)
    if faithful:
        pdf_t = pdf_cosine(n_t, cand) + pdf_vndf(n_t, cand, v_t, rough_t)
        if statics.num_lights > 0:
            pdf_t = pdf_t + pdf_lights_lp(point_t, cand, lp, statics, lp_dev)
        pdf_t = true_div(pdf_t, n_comp)
        ok = (cand.dot(tile3(n_shade)) > 0.0) & (pdf_t > _SAFE)
    else:
        ok = (cand.dot(tile3(n_shade)) > 0.0) & (cand.dot(n_t) > 0.0)

    ok2 = ok.reshape(k, b)
    is_first = ok2 & (torch.cumsum(ok2.to(torch.int32), dim=0) == 1)
    w = is_first.to(torch.float32)

    def pick(x):
        return torch.sum(x.reshape(k, b) * w, dim=0)

    l = Vec3(pick(cand.x), pick(cand.y), pick(cand.z))
    accepted = ok2.any(dim=0)
    if faithful:
        pdf = pick(pdf_t)
    else:
        pdf = pdf_cosine(n_geom, l) + pdf_vndf(n_geom, l, v, roughness)
        if statics.num_lights > 0:
            pdf = pdf + pdf_lights_lp(point, l, lp, statics, lp_dev)
        pdf = true_div(pdf, n_comp)
        accepted = accepted & (pdf > _SAFE)
    if need is not None:
        accepted = accepted & need
    return l, torch.clamp(pdf, min=_SAFE), accepted
