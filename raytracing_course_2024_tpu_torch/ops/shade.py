"""The modular bounce's element-wise work: the hand-written CUDA kernels N1a
(``shade``) and N1b (``finish``), ``csrc/shade.cu``, and their plain
versions.

The JAX package has no kernel here: under ``jax.jit`` XLA fuses what sits
around the nearest hit and the sampler into a few loop fusions. N1a does
``_fold_in_planes`` + ``surface_detail`` + the accumulation of
``integrator/path.py:_collect_hit``; N1b the counter draws +
``_finish_bounce``. Each is one pass over the lanes where PyTorch launched
one kernel per op.

Both work on the (13, B) path state of the fused route and the lane
engines (rows ro 0-2, rd 3-5, throughput 6-8, radiance 9-11, alive 12):

* ``shade(state, t, idx, scene, bg, depth, last, final, count)``: ``(t, idx)`` is
  the nearest hit over the finite table (``ops/traverse.py:nearest_table``);
  the planes fold in here. Live lanes add the background (a miss: alive
  cleared) or the emission at the hit into the radiance. Returns ``(state,
  surf, need)``: ``surf`` a ``Surf``, the (SURF_ROWS, B) rows ``rows``
  (point, n_geom, n_shade, v = -rd, roughness: the sampler K3's 13 inputs in
  its order) and the (B, SURF_REC) records ``rec``, 32 bytes a lane (color,
  metallic, ior, mkind, is_outer as 0/1, t: what only ``finish`` reads);
  ``need`` the sampler's mask (live and not a delta material). In the lane
  layout (``depth`` given) alive becomes "hit and depth < last", the lane
  engines' final-depth rule. ``final`` (the batch scan's last level) leaves
  ``surf`` and ``need`` out (None). N1a reads the winner from the scene's
  row-major ``prim_rec`` (``ops/scene_intersect.py``). ``count`` (a 0-dim
  int64 tensor) gets the lanes alive on entry added: the path vertices of
  the level, counted by the kernel itself (on the CPU, the alive row's
  sum).
* ``finish(state, surf, l, pdf, ok, wid, seed, wid_off, cfg, bounce_i,
  depth)``: draws the dielectric split and, under ``cfg.rr``, the roulette
  draw from the counter RNG of ``work_key(seed, wid + wid_off)``, in the
  batch layout at ``bounce_i`` or, with ``depth``, the lane layout at each
  lane's depth; applies the BRDF weight, the delta rules and roulette.
  Returns ``(state, live)``, ``live`` the bool alive row. In the lane layout
  the dead lanes' rays are parked (``park``).

Rows where a kernel's values are not the plain version's (every lane's
radiance and alive come out as the plain version's): the surface of lanes
that are dead or missed (zero or left as they were); in the batch layout
the ray and throughput of lanes dead on entry to N1b (parked with a zero
throughput where a live lane shares their sectors, else left as they were).
The plain versions compute those rows; nothing reads them.

On a CUDA tensor ``shade`` and ``finish`` launch their kernels, in place
in ``state``, or raise; ``seed`` and ``wid_off`` reach N1b as a (2,) int64
device pair (``ops/rng.py:seed_off``), so a captured CUDA graph replays the
launch for any seed and sample offset. On the CPU they run the plain
versions, which return fresh tensors and are today's torch code, op for op:
the port's CPU numbers are those of the JAX package's stages.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..scene.types import DIELECTRIC, MIRROR, PlaneCol as PL
from .brdf import eval_brdf
from .kernels import check, launch_finish, launch_shade
from .rng import (WF_STRIDE, batch_ctr, draws_per_bounce, lane_ctr, offset_ids, seed_off,
                  uniform_ctr, work_key)
from .scene_intersect import PREC_WIDTH, ModularScene, Surface, surface_detail
from .traverse import fold_hit
from .vec import Vec3, reflect, where3

N_STATE = 13
# rows of Surf.rows: K3's inputs (ops/sampler.py) in order
SF_POINT, SF_NGEOM, SF_NSHADE, SF_V, SF_ROUGH = 0, 3, 6, 9, 12
SURF_ROWS = 13
# fields of a lane's Surf.rec, the 32-byte record only N1b reads
SR_COLOR, SR_METAL, SR_IOR, SR_MKIND, SR_OUTER, SR_T = 0, 3, 4, 5, 6, 7
SURF_REC = 8

RR_START = 2  # first bounce index (lane engines: depth) eligible for roulette
RR_MIN_P = 0.05

# a dead lane's parked ray: far outside every scene, pointing away along the
# all-positive diagonal so slab and cull tests reject it with finite math
PARK_ORIGIN = 1.0e30
PARK_DIR = 0.5773502691896258  # 1/sqrt(3)


class PathState(NamedTuple):
    ro: Vec3
    rd: Vec3
    throughput: Vec3
    radiance: Vec3
    alive: torch.Tensor


def state_of(state: torch.Tensor) -> PathState:
    """Views of a (13, B) state's rows; alive as a bool row."""
    s = state
    return PathState(Vec3(s[0], s[1], s[2]), Vec3(s[3], s[4], s[5]), Vec3(s[6], s[7], s[8]),
                     Vec3(s[9], s[10], s[11]), s[12] > 0.5)


def state_rows(ps: PathState) -> torch.Tensor:
    """A fresh (13, B) state from a ``PathState``."""
    return torch.stack([*ps.ro, *ps.rd, *ps.throughput, *ps.radiance,
                        ps.alive.to(torch.float32)])


def park(state: torch.Tensor, cont: torch.Tensor) -> torch.Tensor:
    """Set alive to ``cont`` and park the rays of the other lanes (in place)."""
    state[12] = cont.to(torch.float32)
    state[0:3] = torch.where(cont, state[0:3], PARK_ORIGIN)
    state[3:6] = torch.where(cont, state[3:6], PARK_DIR)
    return state


class Surf(NamedTuple):
    """N1a's surface at each lane's hit: ``rows`` (SURF_ROWS, B), the SF_
    rows K3 reads; ``rec`` (B, SURF_REC) row-major, the SR_ fields only N1b
    reads, so that a lane's read of them is one 32-byte sector."""

    rows: torch.Tensor
    rec: torch.Tensor

    def columns(self) -> list:
        """The 21 per-lane values as (B,) tensors: the rows, then the
        record's fields."""
        return [*self.rows, *self.rec.T]


def sampler_inputs(surf: Surf) -> tuple:
    """(point, n_geom, n_shade, v, roughness) of the surface rows: what K3
    and the XLA sampler take."""
    rows = surf.rows

    def v3(r):
        return Vec3(rows[r], rows[r + 1], rows[r + 2])

    return v3(SF_POINT), v3(SF_NGEOM), v3(SF_NSHADE), v3(SF_V), rows[SF_ROUGH]


def surface_of(surf: Surf) -> Surface:
    """The surface as ``_finish_bounce`` reads it (no emission: the shade
    pass used it up)."""
    point, n_geom, n_shade, _, roughness = sampler_inputs(surf)
    rec = surf.rec
    return Surface(t=rec[:, SR_T], point=point, n_geom=n_geom, n_shade=n_shade,
                   is_outer=rec[:, SR_OUTER] > 0.5,
                   color=Vec3(rec[:, SR_COLOR], rec[:, SR_COLOR + 1], rec[:, SR_COLOR + 2]),
                   metallic=rec[:, SR_METAL], roughness=roughness, emission=None,
                   ior=rec[:, SR_IOR], mkind=rec[:, SR_MKIND])


# ---------------------------------------------------------------------------
# N1a: shade
# ---------------------------------------------------------------------------


def shade_plain(state: torch.Tensor, t: torch.Tensor, idx: torch.Tensor, scene: ModularScene,
                bg, depth: torch.Tensor | None = None, last: int = 0, final: bool = False,
                count: torch.Tensor | None = None):
    """Plain version of ``shade``: the planes folded in
    (``ops/traverse.py:fold_hit``), ``surface_detail``, and the emission /
    background accumulation of ``_collect_hit``; the alive row's sum added
    to ``count``."""
    ps = state_of(state)
    if count is not None:
        count += ps.alive.sum()
    hit = fold_hit(ps.ro, ps.rd, scene, t, idx)
    surf = surface_detail(ps.ro, ps.rd, hit, scene)
    zero = ps.ro.x * 0.0
    bgv = Vec3(zero + bg[0], zero + bg[1], zero + bg[2])
    miss = ps.alive & ~hit.valid
    on_hit = ps.alive & hit.valid
    rad = ps.radiance + where3(miss, ps.throughput.mul(bgv),
                               where3(on_hit, ps.throughput.mul(surf.emission),
                                      Vec3(zero, zero, zero)))
    alive = on_hit if depth is None else on_hit & (depth < last)
    out = state_rows(ps._replace(radiance=rad, alive=alive))
    if final:
        return out, None, None
    is_delta = (surf.mkind == MIRROR) | (surf.mkind == DIELECTRIC)
    v = -ps.rd
    rows = torch.stack([*surf.point, *surf.n_geom, *surf.n_shade, *v, surf.roughness])
    rec = torch.stack([*surf.color, surf.metallic, surf.ior, surf.mkind,
                       surf.is_outer.to(torch.float32), surf.t], dim=1)
    return out, Surf(rows, rec), alive & ~is_delta


def shade(state: torch.Tensor, t: torch.Tensor, idx: torch.Tensor, scene: ModularScene, bg,
          depth: torch.Tensor | None = None, last: int = 0, final: bool = False,
          count: torch.Tensor | None = None):
    """N1a for tensors on CUDA (in place in ``state``), its plain version for
    tensors on the CPU. Returns ``(state, surf, need)``."""
    dev = state.device
    if dev.type == "cpu":
        return shade_plain(state, t, idx, scene, bg, depth, last, final, count)
    if dev.type != "cuda":
        raise ValueError(f"no shade kernel for device {dev}")
    b = state.shape[1]
    check("state", state, torch.float32, (N_STATE, b), dev)
    check("t", t, torch.float32, (b,), dev)
    check("idx", idx, torch.int32, (b,), dev)
    check("prim_rec", scene.prim_rec, torch.float32, (scene.packed.shape[1], PREC_WIDTH), dev)
    np_ = scene.plane_packed.shape[1]
    check("plane_packed", scene.plane_packed, torch.float32, (PL.COUNT, np_), dev)
    check("pl_mask", scene.pl_mask, torch.bool, (np_,), dev)
    if depth is not None:
        check("depth", depth, torch.int32, (b,), dev)
    if count is not None:
        check("count", count, torch.int64, (), dev)
    surf = None if final else Surf(
        torch.empty((SURF_ROWS, b), dtype=torch.float32, device=dev),
        torch.empty((b, SURF_REC), dtype=torch.float32, device=dev))
    need = None if final else torch.empty((b,), dtype=torch.bool, device=dev)
    statics = scene.statics
    launch_shade(state, t, idx, scene.prim_rec, scene.plane_packed, scene.pl_mask,
                 np_ if statics.num_planes > 0 else 0, statics.any_rotation,
                 statics.any_nontri, depth, last, bg, final, surf, need, count)
    return state, surf, need


# ---------------------------------------------------------------------------
# N1b: finish
# ---------------------------------------------------------------------------


def _finish_bounce(state: PathState, surf, l_s: Vec3, pdf: torch.Tensor,
                   ok: torch.Tensor, u_diel: torch.Tensor, cfg,
                   u_rr: torch.Tensor | None = None,
                   rr_mask: torch.Tensor | bool = False) -> PathState:
    """Post-sampling half of a bounce: BRDF weight, delta-material
    continuation rules, state update, then Russian roulette when ``cfg.rr``
    (survive with p = clamp(max throughput channel, RR_MIN_P, 1) on lanes
    where ``rr_mask`` holds, throughput / p)."""
    v = -state.rd  # rays are kept unit-length
    n = surf.n_geom
    is_mirror = surf.mkind == MIRROR
    is_diel = surf.mkind == DIELECTRIC
    is_delta = is_mirror | is_diel

    f = eval_brdf(l_s, n, v, surf.color, surf.metallic, surf.roughness, surf.mkind)
    # the reference's cos term is the signed l.n_geom; the fast sampler never
    # accepts l below the horizon, so the clamp only guards its kill-path zeros
    cos_l = l_s.dot(n) if cfg.faithful else torch.clamp(l_s.dot(n), min=0.0)
    w_sampled = f * (cos_l * (1.0 / torch.clamp(pdf, min=1e-20)))

    l_mirror = reflect(v, n)
    cos_i = torch.clamp(v.dot(n), 0.0, 1.0)
    eta = torch.where(surf.is_outer, 1.0 / surf.ior, surf.ior)
    sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin2_t > 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    r0 = torch.square((eta - 1.0) / (eta + 1.0))
    refl_p = r0 + (1.0 - r0) * torch.pow(1.0 - cos_i, 5.0)
    do_reflect = tir | (u_diel < refl_p)
    l_refr = (state.rd * eta + n * (eta * cos_i - cos_t)).normalize(eps=1e-20)
    l_diel = where3(do_reflect, l_mirror, l_refr)
    one = torch.ones_like(surf.color.x)
    w_diel = where3(do_reflect | ~surf.is_outer, Vec3(one, one, one), surf.color)

    next_dir = where3(is_mirror, l_mirror, where3(is_diel, l_diel, l_s))
    weight = where3(is_mirror, surf.color, where3(is_diel, w_diel, w_sampled))

    # scattered and reflected rays restart from the backed-off point on the
    # incoming side; transmitted rays continue from just past the surface
    transmitted = is_diel & ~do_reflect
    point_back = state.ro + state.rd * (surf.t + 1e-4)
    next_origin = where3(transmitted, point_back, surf.point)

    new_alive = state.alive & (is_delta | ok)
    zero = torch.zeros_like(one)
    throughput = state.throughput.mul(where3(new_alive, weight, Vec3(zero, zero, zero)))

    if cfg.rr and u_rr is not None:
        p = torch.clamp(torch.maximum(torch.maximum(throughput.x, throughput.y), throughput.z),
                        RR_MIN_P, 1.0)
        roll = new_alive & rr_mask
        survive = u_rr < p
        new_alive = new_alive & (survive | ~roll)
        throughput = throughput * torch.where(roll & survive, 1.0 / p, 1.0)

    return PathState(next_origin, next_dir, throughput, state.radiance, new_alive)


def finish_plain(state: torch.Tensor, surf: Surf, l_s: Vec3, pdf: torch.Tensor,
                 ok: torch.Tensor, wid: torch.Tensor, seed, wid_off, cfg, bounce_i: int = 0,
                 depth: torch.Tensor | None = None):
    """Plain version of ``finish``: the counter draws, ``_finish_bounce``
    and, in the lane layout, ``park``."""
    key = work_key(seed, offset_ids(wid, wid_off))
    k = cfg.max_tries
    ctr = batch_ctr(bounce_i * draws_per_bounce(k), k) if depth is None else lane_ctr(depth, k)
    kw = {}
    if cfg.rr:
        kw = dict(u_rr=uniform_ctr(key, ctr.base + ctr.rr),
                  rr_mask=bounce_i >= RR_START if depth is None else depth >= RR_START)
    ps = _finish_bounce(state_of(state), surface_of(surf), l_s, pdf, ok,
                        uniform_ctr(key, ctr.base + ctr.diel), cfg, **kw)
    out = state_rows(ps)
    if depth is not None:
        out = park(out, ps.alive)
    return out, ps.alive


def finish(state: torch.Tensor, surf: Surf, l_s: Vec3, pdf: torch.Tensor,
           ok: torch.Tensor, wid: torch.Tensor, seed, wid_off, cfg, bounce_i: int = 0,
           depth: torch.Tensor | None = None):
    """N1b for tensors on CUDA (in place in ``state``), its plain version for
    tensors on the CPU. Returns ``(state, live)``."""
    dev = state.device
    if dev.type == "cpu":
        return finish_plain(state, surf, l_s, pdf, ok, wid, seed, wid_off, cfg, bounce_i, depth)
    if dev.type != "cuda":
        raise ValueError(f"no finish kernel for device {dev}")
    b = state.shape[1]
    check("state", state, torch.float32, (N_STATE, b), dev)
    check("surf.rows", surf.rows, torch.float32, (SURF_ROWS, b), dev)
    check("surf.rec", surf.rec, torch.float32, (b, SURF_REC), dev)
    lpdf = (*l_s, pdf)
    for name, r in zip(("l.x", "l.y", "l.z", "pdf"), lpdf):
        check(name, r, torch.float32, (b,), dev)
    check("ok", ok, torch.bool, (b,), dev)
    check("wid", wid, torch.int32, (b,), dev)
    if depth is not None:
        check("depth", depth, torch.int32, (b,), dev)
    pair = seed_off(seed, wid_off, dev)
    check("seed_off", pair, torch.int64, (2,), dev)
    # the kernel's counters: base + stride * (the lane's depth or bounce_i)
    k = cfg.max_tries
    if depth is None:
        ctr, stride = batch_ctr(bounce_i * draws_per_bounce(k), k), 0
    else:
        ctr, stride = lane_ctr(0, k), WF_STRIDE
    live = torch.empty((b,), dtype=torch.bool, device=dev)
    launch_finish(state, surf, lpdf, ok, wid, pair, ctr.base, stride, ctr.diel, ctr.rr, depth,
                  bounce_i, cfg.rr, RR_START, cfg.faithful, live)
    return state, live
