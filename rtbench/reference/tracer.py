"""The plain path tracer that decides ``correct``.

The course's estimator (its ``rendering.rs``) as a loop over depth levels,
carrying per path the ray, the throughput T, the radiance L and an alive
flag: at each level the nearest hit over the finite primitives and the
planes; a miss adds T x background and ends the path, a hit adds T x
emission; the last level stops there. Otherwise a direction is drawn from
the one-sample mixture of the cosine lobe, the GGX visible normals and the
light surfaces (``max_tries`` candidates, the first with l.n_shade > 0 and
l.n_geom > 0 kept, the mixture pdf of that one), T is multiplied by
f(l, v) (l.n)+ / pdf (a mirror: its colour, along the reflection), and
with Russian roulette from the third level on a path survives with
probability p = clamp(max T, 0.05, 1) and T is divided by p. Every draw is
the counter RNG's (``rng.py``) at the work item (pixel, sample) and the
counter of the engine's layout. Path vertices are the levels each path
enters alive.

``Scene`` holds the arrays in the reference's dtype (float32; bfloat16 for
the control): every float of a path is computed in that dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..scenes import BOX, DIELECTRIC, DIFFUSE, ELLIPSOID, MIRROR, TRI, SceneSpec
from . import bvh
from .rng import Layout, uniform, work_key
from .vec import V3, reflect, rotate, tdiv, unrotate, where3

PI = math.pi
INF = float("inf")
EPS_BACKOFF = 1e-4
BOX_EPS = 1e-4
DIR_BIAS = 1e-9
SAFE = 1e-9
RR_START, RR_MIN_P = 2, 0.05
_T = math.sqrt(0.234 ** 2 + 0.1234 ** 2 + 0.97686 ** 2)
T_SEED = (0.234 / _T, 0.1234 / _T, 0.97686 / _T)


def _rot_rows(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    qv, w = q[:, :3], q[:, 3:4]
    t = 2.0 * np.cross(qv, v)
    return v + w * t + np.cross(qv, t)


class Scene:
    """The spec's arrays as the renderer stores them (float32, triangle
    transforms baked into the vertices in float64), on ``device`` in
    ``dtype``; ``tree``: walk a BVH (``bvh.py``) for the nearest hit, else
    sweep every primitive."""

    def __init__(self, spec: SceneSpec, device, dtype=torch.float32, tree: bool = False):
        p = {k: np.array(v) for k, v in spec.prims.items()}
        tri = p["kind"] == TRI
        if tri.any():
            q, t = p["rotation"][tri], p["position"][tri]
            for f in ("p0", "p1", "p2"):
                p[f][tri] = _rot_rows(q, p[f][tri].astype(np.float32).astype(np.float64)) + t
            for f in ("sn0", "sn1", "sn2"):
                p[f][tri] = _rot_rows(q, p[f][tri].astype(np.float32).astype(np.float64))
            p["position"][tri] = 0.0
            p["rotation"][tri] = (0.0, 0.0, 0.0, 1.0)
        f32 = {k: v.astype(np.float32) for k, v in p.items() if k not in ("kind", "mkind")}
        if np.isin(p["mkind"], (DIELECTRIC,)).any() or np.isin(spec.planes["mkind"],
                                                                (DIELECTRIC,)).any():
            raise NotImplementedError("the reference has no dielectric")
        self.device, self.dtype = device, dtype
        self.spec = spec

        def t(a, dt=dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)

        self.kind, self.mkind = t(p["kind"], torch.int64), t(p["mkind"], torch.int64)
        for f in ("p0", "p1", "p2", "sn0", "sn1", "sn2", "position", "rotation", "color",
                  "metallic", "roughness", "emission"):
            setattr(self, f, t(f32[f]))
        self.e1, self.e2 = t(f32["p1"] - f32["p0"]), t(f32["p2"] - f32["p0"])
        ident = np.array([0, 0, 0, 1], np.float32)
        self.rotated = t(np.abs(f32["rotation"] - ident).max(1) > 1e-7, torch.bool)
        self.any_nontri = bool((~tri).any())
        pl = {k: np.asarray(v) for k, v in spec.planes.items()}
        self.n_planes = len(pl["mkind"])
        self.pl = {k: t(v.astype(np.float32)) for k, v in pl.items() if k != "mkind"}
        self.pl_mkind = t(pl["mkind"], torch.int64)
        # lights: the emissive finite primitives, triangles only
        emit = np.linalg.norm(p["emission"], axis=1) > 1e-5
        lid = np.nonzero(emit)[0]
        if (p["kind"][lid] != TRI).any():
            raise NotImplementedError("the reference samples triangle lights only")
        self.n_lights = len(lid)
        a, b, c = (p[f][lid] for f in ("p0", "p1", "p2"))
        area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
        self.l_inv_area = (1.0 / np.maximum(area, 1e-30)).astype(np.float32)
        la, lb, lc = (f32[f][lid] for f in ("p0", "p1", "p2"))
        n = np.cross(lb - la, lc - la).astype(np.float32)
        n2 = (n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1] + n[:, 2] * n[:, 2]).astype(np.float32)
        self.l_n = n * (np.float32(1.0) / np.sqrt(np.maximum(n2, np.float32(1e-20))))[:, None]
        self.l_tab = t(np.stack([la, lb, lc], 1).reshape(-1, 9))
        self.l_consts = [(t(la[j]), t(lb[j] - la[j]), t(lc[j] - la[j]), t(self.l_n[j]),
                          float(self.l_inv_area[j])) for j in range(self.n_lights)]
        self.tree = None
        if tree:
            lo, hi = bvh.prim_boxes(p["kind"], f32["p0"], f32["p1"], f32["p2"],
                                    f32["position"], f32["rotation"])
            self.tree = bvh.DeviceTree(bvh.cached_build(lo, hi), device, dtype)


def _mt(ro: V3, rd: V3, a: V3, e1: V3, e2: V3):
    """Moller-Trumbore: (t, u, v, inside)."""
    pv = rd.cross(e2)
    det = e1.dot(pv)
    det_ok = torch.abs(det) > 1e-30
    inv = 1.0 / torch.where(det_ok, det, 1e-30)
    tv = ro - a
    u = tv.dot(pv) * inv
    qv = tv.cross(e1)
    v = rd.dot(qv) * inv
    t = e2.dot(qv) * inv
    return t, u, v, (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & det_ok


def _local(ro: V3, rd: V3, pos: V3, rot: tuple, rotated):
    o = ro - pos
    return where3(rotated, unrotate(rot, o), o), where3(rotated, unrotate(rot, rd), rd)


def _box_iv(o: V3, d: V3, s: V3):
    ix, iy, iz = 1.0 / (d.x + DIR_BIAS), 1.0 / (d.y + DIR_BIAS), 1.0 / (d.z + DIR_BIAS)
    ax, bx = (-s.x - o.x) * ix, (s.x - o.x) * ix
    ay, by = (-s.y - o.y) * iy, (s.y - o.y) * iy
    az, bz = (-s.z - o.z) * iz, (s.z - o.z) * iz
    mn, mx = torch.minimum, torch.maximum
    t1 = mx(mn(ax, bx), mx(mn(ay, by), mn(az, bz)))
    t2 = mn(mx(ax, bx), mn(mx(ay, by), mx(az, bz)))
    return t1, t2, t1 <= t2


def _ell_iv(o: V3, d: V3, r: V3):
    oo = V3(o.x / r.x, o.y / r.y, o.z / r.z)
    dd = V3(d.x / r.x, d.y / r.y, d.z / r.z)
    a, b, c = dd.dot(dd), oo.dot(dd), oo.dot(oo) - 1.0
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    inv_a = 1.0 / torch.clamp(a, min=1e-30)
    return (-b - sq) * inv_a, (-b + sq) * inv_a, disc >= 0.0


def _gather(s: Scene, rows):
    g = lambda a: V3(*a[rows].unbind(-1))  # noqa: E731
    return g


def prim_t(s: Scene, ro: V3, rd: V3, rows: torch.Tensor) -> torch.Tensor:
    """Each ray's nearest distance above 0 to primitive ``rows`` (inf on a
    miss); rows and rays broadcast."""
    g = _gather(s, rows)
    t, _, _, ok = _mt(ro, rd, g(s.p0), g(s.e1), g(s.e2))
    t = torch.where(ok & (t > 0.0), t, INF)
    if not s.any_nontri:
        return t
    kind = s.kind[rows]
    o, d = _local(ro, rd, g(s.position), tuple(s.rotation[rows].unbind(-1)), s.rotated[rows])
    s0 = g(s.p0)

    def nearest(t1, t2, valid):
        return torch.minimum(torch.where(valid & (t1 > 0.0), t1, INF),
                             torch.where(valid & (t2 > 0.0), t2, INF))

    t = torch.where(kind == BOX, nearest(*_box_iv(o, d, s0)), t)
    return torch.where(kind == ELLIPSOID, nearest(*_ell_iv(o, d, s0)), t)


def nearest_finite(s: Scene, ro: V3, rd: V3):
    """(t, row) of the nearest finite primitive: the tree's walk, or a sweep
    of every primitive (the first row wins a tie)."""
    if s.tree is not None:
        return bvh.walk(ro, rd, s.tree, lambda o, d, rows: prim_t(s, o, d, rows))
    n = s.kind.shape[0]
    rows = torch.arange(n, device=ro.x.device)[None, :]
    t = prim_t(s, V3(ro.x[:, None], ro.y[:, None], ro.z[:, None]),
               V3(rd.x[:, None], rd.y[:, None], rd.z[:, None]), rows)
    idx = torch.argmin(t, dim=1)
    return t.gather(1, idx[:, None])[:, 0], idx


def surface(s: Scene, ro: V3, rd: V3, t: torch.Tensor, idx: torch.Tensor):
    """The hit's point (backed off 1e-4), geometric and shading normals
    facing the ray, and material, with the planes folded in (a plane wins
    only when strictly nearer). Returns (hit, point, n_geom, n_shade,
    color, metallic, roughness, emission, mkind)."""
    g = _gather(s, idx)
    a, e1, e2 = g(s.p0), g(s.e1), g(s.e2)
    _, u, v, _ = _mt(ro, rd, a, e1, e2)
    flat = e1.cross(e2).normalize()
    front = flat.dot(rd) < 0.0
    sgn = torch.where(front, 1.0, -1.0).to(flat.x.dtype)
    sn0, sn1, sn2 = g(s.sn0), g(s.sn1), g(s.sn2)
    ns = (sn0 + (sn1 - sn0) * u + (sn2 - sn0) * v).normalize()
    n_geom, n_shade = flat * sgn, ns * sgn
    if s.any_nontri:
        kind = s.kind[idx]
        rot, rotated = tuple(s.rotation[idx].unbind(-1)), s.rotated[idx]
        o, d = _local(ro, rd, g(s.position), rot, rotated)
        b1, b2, bv = _box_iv(o, d, a)
        b_out = bv & (b1 > 0.0)
        p = o + d * torch.where(b_out, b1, b2)
        on_x, on_y = (a.x - torch.abs(p.x)) < BOX_EPS, (a.y - torch.abs(p.y)) < BOX_EPS
        z = torch.zeros_like(p.x)
        bn = where3(on_x, V3(torch.sign(p.x), z, z),
                    where3(on_y, V3(z, torch.sign(p.y), z), V3(z, z, torch.sign(p.z))))
        bn = where3(b_out, bn, -bn)
        e1_, e2_, ev = _ell_iv(o, d, a)
        e_out = ev & (e1_ > 0.0)
        p = o + d * torch.where(e_out, e1_, e2_)
        en = V3(p.x / (a.x * a.x), p.y / (a.y * a.y), p.z / (a.z * a.z)).normalize()
        en = where3(e_out, en, -en)
        bn = where3(rotated, rotate(rot, bn), bn)
        en = where3(rotated, rotate(rot, en), en)
        n_geom = where3(kind == BOX, bn, where3(kind == ELLIPSOID, en, n_geom))
        n_shade = where3(kind == BOX, bn, where3(kind == ELLIPSOID, en, n_shade))
    color, emission = g(s.color), g(s.emission)
    metallic, roughness, mkind = s.metallic[idx], s.roughness[idx], s.mkind[idx]
    hit = torch.isfinite(t)
    if s.n_planes:
        pt_best = torch.full_like(t, INF)
        p_idx = torch.zeros_like(idx)
        for j in range(s.n_planes):
            pl = {k: v[j] for k, v in s.pl.items()}
            q = tuple(pl["rotation"].unbind(-1))
            o = unrotate(q, ro - V3(*pl["position"].unbind(-1)))
            d = unrotate(q, rd)
            nl = V3(*pl["normal"].unbind(-1))
            den = nl.dot(d)
            den_ok = torch.abs(den) > 1e-30
            tp = -nl.dot(o) / torch.where(den_ok, den, 1e-30)
            tp = torch.where(den_ok & (tp > 0.0), tp, INF)
            nearer = tp < pt_best
            pt_best, p_idx = torch.where(nearer, tp, pt_best), torch.where(nearer, j, p_idx)
        on_plane = pt_best < t
        pg = lambda k: V3(*s.pl[k][p_idx].unbind(-1))  # noqa: E731
        q = tuple(s.pl["rotation"][p_idx].unbind(-1))
        pn = rotate(q, pg("normal").normalize())
        p_front = pn.dot(rd) < 0.0
        pn = pn * torch.where(p_front, 1.0, -1.0).to(pn.x.dtype)
        n_geom, n_shade = where3(on_plane, pn, n_geom), where3(on_plane, pn, n_shade)
        color = where3(on_plane, pg("color"), color)
        emission = where3(on_plane, pg("emission"), emission)
        metallic = torch.where(on_plane, s.pl["metallic"][p_idx], metallic)
        roughness = torch.where(on_plane, s.pl["roughness"][p_idx], roughness)
        mkind = torch.where(on_plane, s.pl_mkind[p_idx], mkind)
        t = torch.minimum(t, pt_best)
        hit = hit | torch.isfinite(pt_best)
    tt = torch.where(hit, t, 1.0)
    point = ro + rd * (tt - EPS_BACKOFF)
    return hit, point, n_geom, n_shade, color, metallic, roughness, emission, mkind


# --- sampling -----------------------------------------------------------------


def _tangents(n: V3):
    seed = V3(torch.full_like(n.x, T_SEED[0]), torch.full_like(n.x, T_SEED[1]),
              torch.full_like(n.x, T_SEED[2]))
    t1 = n.cross(seed).normalize()
    return t1, n.cross(t1).normalize()


def _sphere(u1, u2) -> V3:
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = (2.0 * PI) * u2
    return V3(r * torch.cos(phi), r * torch.sin(phi), z)


def _vndf_local(u0, u1, vl: V3, alpha) -> V3:
    vh = V3(alpha * vl.x, alpha * vl.y, vl.z).normalize(1e-20)
    lensq = vh.x * vh.x + vh.y * vh.y
    inv = torch.rsqrt(torch.clamp(lensq, min=1e-20))
    z, one = torch.zeros_like(vh.x), torch.ones_like(vh.x)
    t1 = where3(lensq > 1e-20, V3(-vh.y * inv, vh.x * inv, z), V3(one, z, z))
    t2 = vh.cross(t1)
    r = torch.sqrt(u0)
    phi = 2.0 * PI * u1
    p1, p2 = r * torch.cos(phi), r * torch.sin(phi)
    sw = 0.5 * (1.0 + vh.z)
    p2 = (1.0 - sw) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + sw * p2
    nh = t1 * p1 + t2 * p2 + vh * torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    return V3(alpha * nh.x, alpha * nh.y, torch.clamp(nh.z, min=0.0)).normalize(1e-20)


def _to_local(t1, t2, n, v) -> V3:
    return V3(v.dot(t1), v.dot(t2), v.dot(n))


def _nonzero(x, floor):
    return torch.where(torch.abs(x) > floor, x, floor)


def pdf_vndf(n: V3, l: V3, v: V3, rough) -> torch.Tensor:
    alpha = rough * rough
    t1, t2 = _tangents(n)
    vl, ll = _to_local(t1, t2, n, v), _to_local(t1, t2, n, l)
    h = (vl + ll).normalize(1e-20)
    a2 = alpha * alpha
    q = (h.x * h.x + h.y * h.y) / torch.clamp(a2, min=1e-20) + h.z * h.z
    d = 1.0 / torch.clamp(PI * a2 * q * q, min=1e-20)
    z2 = torch.clamp(vl.z * vl.z, min=1e-20)
    lam = 0.5 * (torch.sqrt(1.0 + alpha * alpha * (vl.x * vl.x + vl.y * vl.y) / z2) - 1.0)
    dv = 1.0 / (1.0 + lam) * torch.clamp(vl.dot(h), min=0.0) * d / _nonzero(vl.z, SAFE)
    den = 4.0 * vl.dot(h)
    pdf = dv / _nonzero(den, SAFE)
    return torch.where((vl.z > 0.0) & (den > 0.0) & (h.z > 0.0), pdf, 0.0)


def pdf_lights(s: Scene, point: V3, l: V3) -> torch.Tensor:
    total = torch.zeros_like(point.x)
    for a, e1, e2, n, inv_area in s.l_consts:
        t, _, _, ok = _mt(point, l, V3(*a.unbind(-1)), V3(*e1.unbind(-1)), V3(*e2.unbind(-1)))
        den = torch.clamp(torch.abs(V3(*n.unbind(-1)).dot(l)), min=SAFE)
        total = total + torch.where(ok & (t > 0.0), inv_area * t * t / den, 0.0)
    return tdiv(total, max(s.n_lights, 1))


def sample_light(s: Scene, u1, u2, u6, point: V3) -> V3:
    li = torch.clamp((u6 * s.n_lights).to(torch.int32), max=s.n_lights - 1).long()
    row = s.l_tab[li]
    p0, p1, p2 = (V3(*row[:, k:k + 3].unbind(-1)) for k in (0, 3, 6))
    fold = u1 + u2 >= 1.0
    tu, tv = torch.where(fold, 1.0 - u1, u1), torch.where(fold, 1.0 - u2, u2)
    pt = p0 + (p1 - p0) * tu + (p2 - p0) * tv
    return (pt - point).normalize(1e-20)


def sample_mixture(s: Scene, draw, point: V3, n: V3, ns: V3, v: V3, rough, k: int):
    """(l, pdf >= SAFE, accepted) of the first of ``k`` candidates with
    l.n_shade > 0 and l.n > 0; ``draw(t, r)`` is candidate t's row r."""
    n_comp = 3 if s.n_lights else 2
    z = torch.zeros_like(point.x)
    sel = V3(z, z, z + 1.0)
    acc = z > 1.0
    for t in range(k):
        which = torch.clamp((draw(t, 0) * n_comp).to(torch.int32), max=n_comp - 1)
        u1, u2 = draw(t, 1), draw(t, 2)
        cand = (_sphere(u1, u2) + n).normalize(1e-12)
        t1, t2 = _tangents(n)
        ne = _vndf_local(u1, u2, _to_local(t1, t2, n, v), rough * rough)
        cand = where3(which == 1, reflect(v, t1 * ne.x + t2 * ne.y + n * ne.z), cand)
        if s.n_lights:
            cand = where3(which == 2, sample_light(s, u1, u2, draw(t, 6), point), cand)
        ok = (cand.dot(ns) > 0.0) & (cand.dot(n) > 0.0)
        sel = where3(ok & ~acc, cand, sel)
        acc = acc | ok
    pdf = tdiv(torch.clamp(sel.dot(n), min=0.0), PI) + pdf_vndf(n, sel, v, rough)
    if s.n_lights:
        pdf = pdf + pdf_lights(s, point, sel)
    pdf = tdiv(pdf, n_comp)
    return sel, torch.clamp(pdf, min=SAFE), acc & (pdf > SAFE)


def brdf(l: V3, n: V3, v: V3, color: V3, metallic, rough, mkind) -> V3:
    h = (l + v).normalize()
    diffuse = V3(tdiv(color.x, PI), tdiv(color.y, PI), tdiv(color.z, PI))
    alpha = rough * rough
    a2 = alpha * alpha
    hn, ln, vn = h.dot(n), l.dot(n), v.dot(n)
    d = a2 * torch.where(hn > 0.0, 1.0, 0.0).to(hn.dtype) / torch.clamp(
        PI * torch.square((a2 - 1.0) * hn * hn + 1.0), min=1e-12)

    def g1(x):
        c2 = torch.clamp(x * x, 1e-12, 1.0)
        g = 2.0 / (1.0 + torch.sqrt(1.0 + alpha * alpha * ((1.0 - c2) / c2)))
        return torch.where(x > 0.0, g, 0.0)

    den = 4.0 * ln * vn
    spec = d * (g1(ln) * g1(vn)) / torch.where(torch.abs(den) > 1e-12, den, 1e-12)
    w = torch.pow(torch.clamp(1.0 - torch.abs(h.dot(l)), 0.0, 1.0), 5.0)
    one = 1.0

    def fresnel(f0):
        return f0 + (one - f0) * w

    metal = V3(spec * fresnel(color.x), spec * fresnel(color.y), spec * fresnel(color.z))
    fd = fresnel(0.04)
    diel = V3(spec * fd + diffuse.x * (1.0 - fd), spec * fd + diffuse.y * (1.0 - fd),
              spec * fd + diffuse.z * (1.0 - fd))
    pbr = diel * (1.0 - metallic) + metal * metallic
    return where3(mkind == DIFFUSE, diffuse, pbr)


# --- the estimator ---------------------------------------------------------------


def trace(s: Scene, seed32: int, wid: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
          layout: Layout, rr: bool, levels: list | None = None):
    """One path per work id through pixel (px, py): (radiance (3, R) in
    the scene's dtype, path vertices (R,) int64). ``levels``, when given,
    gets each level's rays (ro, rd, alive) appended."""
    spec, dt = s.spec, s.dtype
    key = work_key(seed32, wid)
    cam = spec.camera

    def c(name):
        return [float(np.float32(x)) for x in np.asarray(cam[name], np.float64)]

    tx, ty = float(np.float32(math.tan(cam["fov_x"] * 0.5))), float(np.float32(
        math.tan(cam["fov_y"] * 0.5)))
    sx = (tdiv(2.0 * (px.to(dt) + uniform(key, 0, dt)), spec.width) - 1.0) * tx
    sy = -(tdiv(2.0 * (py.to(dt) + uniform(key, 1, dt)), spec.height) - 1.0) * ty
    right, up, fwd, pos = c("right"), c("up"), c("forward"), c("position")
    rd = V3(*(sx * right[i] + sy * up[i] + fwd[i] for i in range(3))).normalize()
    z = rd.x * 0.0
    ro = V3(z + pos[0], z + pos[1], z + pos[2])
    thr = V3(z + 1.0, z + 1.0, z + 1.0)
    rad = V3(z, z, z)
    alive = torch.ones_like(z, dtype=torch.bool)
    verts = torch.zeros_like(wid, dtype=torch.int64)
    bg = V3(z + float(spec.bg[0]), z + float(spec.bg[1]), z + float(spec.bg[2]))
    for level in range(spec.ray_depth):
        verts += alive
        if levels is not None:
            levels.append((ro, rd, alive))
        live = torch.nonzero(alive).squeeze(1)
        t = torch.full_like(z, INF)
        idx = torch.zeros_like(wid, dtype=torch.int64)
        if live.numel():
            t[live], idx[live] = nearest_finite(s, ro.at(live), rd.at(live))
        hit, point, n, ns, color, metallic, rough, emission, mkind = surface(s, ro, rd, t, idx)
        rad = rad + where3(alive & ~hit, thr.had(bg),
                           where3(alive & hit, thr.had(emission), V3(z, z, z)))
        alive = alive & hit
        if level == spec.ray_depth - 1:
            break
        v = -rd
        is_mirror = mkind == MIRROR

        def draw(t_, r_, level=level):
            return uniform(key, layout.mix(level, t_, r_), dt)

        l, pdf, ok = sample_mixture(s, draw, point, n, ns, v, rough, layout.k)
        f = brdf(l, n, v, color, metallic, rough, mkind)
        w = f * (torch.clamp(l.dot(n), min=0.0) / torch.clamp(pdf, min=1e-20))
        l = where3(is_mirror, reflect(v, n), l)
        w = where3(is_mirror, color, w)
        alive = alive & (is_mirror | ok)
        thr = thr.had(where3(alive, w, V3(z, z, z)))
        if rr and level >= RR_START:
            p = torch.clamp(torch.maximum(torch.maximum(thr.x, thr.y), thr.z), RR_MIN_P, 1.0)
            survive = uniform(key, layout.rr(level), dt) < p
            roll = alive
            alive = alive & survive
            thr = thr * torch.where(roll & survive, 1.0 / p, 1.0)
        ro, rd = point, l
    return torch.stack([rad.x, rad.y, rad.z]), verts


def render_pixels(s: Scene, seed32: int, pixels: torch.Tensor, samples: int, lane: bool,
                  max_tries: int, rr: bool, chunk: int = 1 << 21):
    """Mean radiance (3, P) float32 over ``samples`` of each pixel (summed
    in sample order, then times 1 / samples) and path vertices (P,) int64
    of the frame keyed by ``seed32``: work id ``sample * W * H + pixel``."""
    w, h = s.spec.width, s.spec.height
    layout = Layout(lane, max_tries)
    n = pixels.shape[0]
    wid = (torch.arange(samples, device=pixels.device)[:, None] * (w * h) + pixels[None, :])
    wid = wid.reshape(-1)
    rads, verts = [], []
    for c0 in range(0, wid.shape[0], chunk):
        wc = wid[c0:c0 + chunk]
        pix = wc % (w * h)
        r, v = trace(s, seed32, wc, pix % w, pix // w, layout, rr)
        rads.append(r.float())
        verts.append(v)
    rad = torch.cat(rads, 1).reshape(3, samples, n)
    acc = torch.zeros((3, n), dtype=torch.float32, device=pixels.device)
    for k in range(samples):
        acc = acc + rad[:, k]
    return acc * (1.0 / samples), torch.cat(verts).reshape(samples, n).sum(0)
