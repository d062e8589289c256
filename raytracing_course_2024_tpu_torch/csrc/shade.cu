// The modular bounce's element-wise work for NVIDIA Hopper (sm_90a): two
// hand-written CUDA kernels, N1a (shade_kernel) and N1b (finish_kernel).
//
// They replace no Pallas kernel: in the JAX package XLA fuses this work, under
// jax.jit of the batch scan and of the lane engines' while loop, into a few
// loop fusions around the nearest hit and the sampler:
// * N1a, after the nearest hit (K6, K4 or the sweep), before the sampler:
//   raytracing_course_2024_tpu/ops/scene_intersect.py:_fold_in_planes and
//   surface_detail, and the accumulation of integrator/path.py:_collect_hit;
// * N1b, after the sampler: integrator/path.py:_finish_bounce with its
//   counter draws (the dielectric split, Russian roulette).
// The port launched one PyTorch kernel per element-wise op there, each
// reading and writing whole rows of the lanes in device memory. The plain
// versions are ops/shade.py:shade_plain and finish_plain, the torch code of
// ops/scene_intersect.py and ops/shade.py:_finish_bounce.
//
// Per lane the arithmetic is the plain version's op for op (no FMA
// contraction, --fmad=false; IEEE division and square root): torch.minimum,
// maximum and clamp propagate a NaN operand, so t_min/t_max/t_clamp do too;
// 1.0 / x is a reciprocal, as torch computes it; x^5 is powf (torch.pow). A
// torch.where computes both branches and keeps one; a kernel lane computes
// only the branch it keeps (triangle, box, ellipsoid or plane), whose bits
// are the kept ones.
//
// What the kernels write, and what they leave:
// * N1a reads the (13, b) state (ro, rd, thr, rad, alive rows) and the
//   nearest hit over the finite table (t, row), folds in the planes, and on
//   a live lane adds the background (a miss: alive cleared) or the winner's
//   emission into the radiance in place. For a lane that hits it writes the
//   surface rows (the SF_ rows below) and the sampler's `need` flag (live and not
//   a delta material). In the lane layout (`depth` given) alive becomes
//   "hit and depth < last". Emission is used up here and not written. A lane
//   dead on entry gets need = 0 and nothing else; a lane that misses gets no
//   surface rows. Nothing downstream reads those rows of those lanes.
// * N1b reads the state, the surface rows, the sampler's (l, pdf, ok) and
//   draws u_diel (and u_rr under roulette) from the counter RNG at the
//   bounce's counters: the batch layout (one bounce index for all lanes) or
//   the lane layout (each lane's depth, as K1's at_depth). It writes the next
//   ray, the throughput and alive in place and a bool `live` row (the next
//   nearest hit's mask). A lane dead on entry gets live = 0; in the lane
//   layout its ray is parked and its throughput zeroed as
//   integrator/wavefront.py:_park and the plain update do, in the batch
//   layout its other rows are left as they are (the plain version writes
//   them, nobody reads them: the radiance and alive are the lane's result).
//
// What bounds them on an H100: device memory. Per live lane N1a reads 52 B
// of state, 8 B of hit and up to 100 B of the winner's table column (at
// stride n: one 32 B sector per row), and writes 16 B of state, 84 B of
// surface and the flag; N1b reads ~150 B and writes ~40 B. A few hundred
// fp32 operations per lane are far below the card's 67 TFLOP/s at that rate.
// This first design runs one thread per lane over a grid of the lanes; the
// winner's gather is a column of the (C, n) table at stride n, which stays
// in L2 (81,920 triangles: 12 MB). Staging the plane table in shared memory,
// a row-major winner table and skipping whole dead warps are later work.

#include "common.cuh"

namespace {

constexpr int kShadeBlock = 256;
constexpr int N_STATE = 13;

// rows of the (SURF_ROWS, b) surface buffer (ops/shade.py): rows 0-12 are the
// sampler K3's 13 inputs in its order (point, n_geom, n_shade, v, roughness)
constexpr int SF_POINT = 0, SF_NGEOM = 3, SF_ROUGH = 12;
constexpr int SF_COLOR = 13, SF_METAL = 16, SF_IOR = 17, SF_MKIND = 18, SF_OUTER = 19;
constexpr int SF_T = 20, SURF_ROWS = 21;

// scene/types.py PrimCol and PlaneCol
constexpr int PC_PTYPE = 0, PC_P0 = 1, PC_P1 = 4, PC_P2 = 7, PC_SN0 = 10, PC_SN1 = 13;
constexpr int PC_SN2 = 16, PC_POS = 19, PC_ROT = 22, PC_COLOR = 26, PC_METAL = 29;
constexpr int PC_ROUGH = 30, PC_EMIT = 31, PC_IOR = 34, PC_MKIND = 35;
constexpr int PL_NORMAL = 0, PL_POS = 3, PL_ROT = 6, PL_COLOR = 10, PL_METAL = 13;
constexpr int PL_ROUGH = 14, PL_EMIT = 15, PL_IOR = 18, PL_MKIND = 19;

// integrator/wavefront.py: a dead lane's parked ray
constexpr float PARK_ORIGIN = 1.0e30f;
constexpr float PARK_DIR = 0.5773502691896258f;
constexpr float RR_MIN_P = 0.05f;

// torch.minimum / maximum / clamp on the card return a NaN operand; fminf and
// fmaxf would drop it
__device__ __forceinline__ float t_min(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float t_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float t_clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float t_clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ V3 neg(V3 a) { return mk(-a.x, -a.y, -a.z); }

struct Quat4 {
  float x, y, z, w;
};
// ops/vec.py Quat.rotate and inverse_rotate (the conjugate's rotate)
__device__ __forceinline__ V3 rotate(Quat4 q, V3 v) { return quat_rotate(q.x, q.y, q.z, q.w, v); }
__device__ __forceinline__ V3 inverse_rotate(Quat4 q, V3 v) {
  return quat_rotate(-q.x, -q.y, -q.z, q.w, v);
}

// A column of a (C, n) table.
struct Column {
  const float* tab;
  int n, j;
  __device__ __forceinline__ float f(int row) const { return __ldg(tab + (long long)row * n + j); }
  __device__ __forceinline__ V3 v3(int row) const { return mk(f(row), f(row + 1), f(row + 2)); }
  __device__ __forceinline__ Quat4 q(int row) const {
    return Quat4{f(row), f(row + 1), f(row + 2), f(row + 3)};
  }
};

struct ShadeParams {
  float* st;  // (13, b)
  long long b;
  const float* t;  // (b,) nearest over the finite table, +inf on a miss
  const int* idx;  // (b,) its row
  const float* packed;  // (36, n)
  int n;
  const float* plane;  // (20, np)
  const uint8_t* pl_mask;
  int np;  // 0: the scene has no planes
  int any_rotation, any_nontri;
  const int* depth;  // (b,) the lane layout's depths, or null
  int last;
  float bg0, bg1, bg2;
  int final_only;  // the batch scan's last level: radiance and alive only
  float* surf;     // (SURF_ROWS, b)
  uint8_t* need;   // (b,)
};

struct Material {
  V3 color, emission;
  float metallic, roughness, ior, mkind;
};

__device__ __forceinline__ Material material(const Column& c, int color, int metal, int rough,
                                             int emit, int ior, int mkind) {
  return Material{c.v3(color), c.v3(emit), c.f(metal), c.f(rough), c.f(ior), c.f(mkind)};
}

// ops/scene_intersect.py:_fold_in_planes: the nearest plane with t > 0, the
// first on a tie (argmin), against the finite table's t.
__device__ __forceinline__ void fold_planes(const ShadeParams& p, V3 ro, V3 rd, float& t, int& idx,
                                            bool& is_plane, bool& valid) {
  float pt = INFINITY;
  int pidx = 0;
  for (int j = 0; j < p.np; ++j) {
    const Column c{p.plane, p.np, j};
    const Quat4 q = c.q(PL_ROT);
    const V3 o = inverse_rotate(q, sub(ro, c.v3(PL_POS)));
    const V3 d = inverse_rotate(q, rd);
    const V3 nrm = c.v3(PL_NORMAL);
    const float denom = dot(nrm, d);
    const bool den_ok = fabsf(denom) > 1e-30f;
    float tj = -dot(nrm, o) / (den_ok ? denom : 1e-30f);
    tj = (den_ok && tj > 0.0f && p.pl_mask[j] != 0) ? tj : INFINITY;
    if (tj < pt) {
      pt = tj;
      pidx = j;
    }
  }
  const bool closer = pt < t;
  t = t_min(t, pt);
  if (closer) idx = pidx;
  is_plane = closer;
  valid = valid || isfinite(pt);
}

// ops/scene_intersect.py:surface_detail for the one primitive this lane hit:
// normals facing the ray, the entry side and the material.
__device__ void detail(const ShadeParams& p, V3 ro, V3 rd, int idx, bool is_plane, V3& n_geom,
                       V3& n_shade, bool& outer, Material& m) {
  if (is_plane) {
    const Column c{p.plane, p.np, min(max(idx, 0), p.np - 1)};
    const V3 pw = rotate(c.q(PL_ROT), normalize(c.v3(PL_NORMAL), 1e-30f));
    outer = dot(pw, rd) < 0.0f;
    n_geom = n_shade = scl(pw, outer ? 1.0f : -1.0f);
    m = material(c, PL_COLOR, PL_METAL, PL_ROUGH, PL_EMIT, PL_IOR, PL_MKIND);
    return;
  }
  const Column c{p.packed, p.n, min(max(idx, 0), p.n - 1)};
  m = material(c, PC_COLOR, PC_METAL, PC_ROUGH, PC_EMIT, PC_IOR, PC_MKIND);
  const float ptype = p.any_nontri ? c.f(PC_PTYPE) : (float)K_TRI;
  const V3 p0 = c.v3(PC_P0);
  if (ptype != (float)K_BOX && ptype != (float)K_ELL) {  // triangle, in world space
    const V3 b = c.v3(PC_P1), cc = c.v3(PC_P2);
    const V3 e1 = sub(b, p0), e2 = sub(cc, p0);
    const V3 pv = cross(rd, e2);
    const float det = dot(e1, pv);
    const bool det_ok = fabsf(det) > 1e-30f;
    const float inv_det = 1.0f / (det_ok ? det : 1e-30f);
    const V3 tv = sub(ro, p0);
    const float u = dot(tv, pv) * inv_det;
    const V3 qv = cross(tv, e1);
    const float v = dot(rd, qv) * inv_det;
    const V3 flat_n = normalize(cross(e1, e2), 1e-30f);
    outer = dot(flat_n, rd) < 0.0f;
    const V3 sn0 = c.v3(PC_SN0), sn1 = c.v3(PC_SN1), sn2 = c.v3(PC_SN2);
    const V3 ns = normalize(add(add(sn0, scl(sub(sn1, sn0), u)), scl(sub(sn2, sn0), v)), 1e-30f);
    const float sign = outer ? 1.0f : -1.0f;
    n_geom = scl(flat_n, sign);
    n_shade = scl(ns, sign);
    return;
  }
  const Quat4 q = c.q(PC_ROT);
  V3 o = sub(ro, c.v3(PC_POS));
  V3 d = rd;
  if (p.any_rotation) {
    o = inverse_rotate(q, o);
    d = inverse_rotate(q, rd);
  }
  const V3 s = p0;
  V3 nl;
  if (ptype == (float)K_BOX) {  // ops/intersect.py ray_box_interval, box_normal
    const float ix = 1.0f / (d.x + DIR_BIAS), iy = 1.0f / (d.y + DIR_BIAS),
                iz = 1.0f / (d.z + DIR_BIAS);
    const float ax = (-s.x - o.x) * ix, bx = (s.x - o.x) * ix;
    const float ay = (-s.y - o.y) * iy, by = (s.y - o.y) * iy;
    const float az = (-s.z - o.z) * iz, bz = (s.z - o.z) * iz;
    const float t1 = t_max(t_min(ax, bx), t_max(t_min(ay, by), t_min(az, bz)));
    const float t2 = t_min(t_max(ax, bx), t_min(t_max(ay, by), t_max(az, bz)));
    outer = (t1 <= t2) && (t1 > 0.0f);
    const float tb = outer ? t1 : t2;
    const V3 ph = add(o, scl(d, tb));
    const bool on_x = (s.x - fabsf(ph.x)) < EPS;
    const bool on_y = (s.y - fabsf(ph.y)) < EPS;
    nl = on_x ? mk(sgnf(ph.x), 0.0f, 0.0f)
              : (on_y ? mk(0.0f, sgnf(ph.y), 0.0f) : mk(0.0f, 0.0f, sgnf(ph.z)));
  } else {  // ops/intersect.py ray_ellipsoid_interval, ellipsoid_normal
    const V3 oo = mk(o.x / s.x, o.y / s.y, o.z / s.z);
    const V3 dd = mk(d.x / s.x, d.y / s.y, d.z / s.z);
    const float a = dot(dd, dd);
    const float bq = dot(oo, dd);
    const float cq = dot(oo, oo) - 1.0f;
    const float disc = bq * bq - a * cq;
    const float sq = sqrtf(t_clamp_min(disc, 0.0f));
    const float inv_a = 1.0f / t_clamp_min(a, 1e-30f);
    const float t1 = (-bq - sq) * inv_a, t2 = (-bq + sq) * inv_a;
    outer = (disc >= 0.0f) && (t1 > 0.0f);
    const float te = outer ? t1 : t2;
    const V3 ph = add(o, scl(d, te));
    nl = normalize(mk(ph.x / (s.x * s.x), ph.y / (s.y * s.y), ph.z / (s.z * s.z)), 1e-30f);
  }
  if (!outer) nl = neg(nl);
  if (p.any_rotation) nl = rotate(q, nl);
  n_geom = n_shade = nl;
}

__global__ void __launch_bounds__(kShadeBlock) shade_kernel(ShadeParams p) {
  const long long i = (long long)blockIdx.x * kShadeBlock + threadIdx.x;
  const long long b = p.b;
  if (i >= b) return;
  float* st = p.st;
  if (!(st[12 * b + i] > 0.5f)) {
    if (!p.final_only) p.need[i] = 0;
    return;
  }
  const V3 ro = mk(st[0 * b + i], st[1 * b + i], st[2 * b + i]);
  const V3 rd = mk(st[3 * b + i], st[4 * b + i], st[5 * b + i]);
  const V3 thr = mk(st[6 * b + i], st[7 * b + i], st[8 * b + i]);
  const V3 rad = mk(st[9 * b + i], st[10 * b + i], st[11 * b + i]);
  float t = p.t[i];
  int idx = p.idx[i];
  bool is_plane = false;
  bool valid = isfinite(t);
  if (p.np > 0) fold_planes(p, ro, rd, t, idx, is_plane, valid);

  V3 add_rad;
  bool alive = valid;
  V3 n_geom, n_shade;
  bool outer = true;
  Material m;
  if (!valid) {
    add_rad = mul(thr, mk(p.bg0, p.bg1, p.bg2));
  } else if (p.final_only) {
    const Column c = is_plane ? Column{p.plane, p.np, min(max(idx, 0), p.np - 1)}
                              : Column{p.packed, p.n, min(max(idx, 0), p.n - 1)};
    add_rad = mul(thr, c.v3(is_plane ? PL_EMIT : PC_EMIT));
  } else {
    detail(p, ro, rd, idx, is_plane, n_geom, n_shade, outer, m);
    add_rad = mul(thr, m.emission);
  }
  const V3 rad2 = add(rad, add_rad);
  st[9 * b + i] = rad2.x;
  st[10 * b + i] = rad2.y;
  st[11 * b + i] = rad2.z;
  if (valid && p.depth != nullptr) alive = p.depth[i] < p.last;
  if (!alive) st[12 * b + i] = 0.0f;
  if (p.final_only) return;
  if (!valid) {
    p.need[i] = 0;
    return;
  }
  const V3 point = add(ro, scl(rd, t - EPS_BACKOFF));
  const V3 v = neg(rd);
  float* sf = p.surf;
  const float rows[SURF_ROWS] = {point.x,   point.y,    point.z,     n_geom.x,   n_geom.y,
                                 n_geom.z,  n_shade.x,  n_shade.y,   n_shade.z,  v.x,
                                 v.y,       v.z,        m.roughness, m.color.x,  m.color.y,
                                 m.color.z, m.metallic, m.ior,       m.mkind,    outer ? 1.0f : 0.0f,
                                 t};
#pragma unroll
  for (int r = 0; r < SURF_ROWS; ++r) sf[r * b + i] = rows[r];
  const bool delta = m.mkind == (float)M_MIRROR || m.mkind == (float)M_DIELECTRIC;
  p.need[i] = (alive && !delta) ? 1 : 0;
}

struct FinishParams {
  float* st;  // (13, b)
  long long b;
  const float* surf;      // (SURF_ROWS, b)
  const float* lpdf[4];   // the sampler's l.x, l.y, l.z, pdf
  const uint8_t* ok;      // (b,)
  const int* wid;         // (b,)
  const long long* seed_off;  // (2,): seed, wid_off (low 32 bits of each)
  uint32_t base, stride, diel, rr_off;  // counters: base + stride * depth (+ diel | rr_off)
  const int* depth;       // (b,) the lane layout, or null: the batch layout at `level`
  int level, rr, rr_start, faithful;
  uint8_t* live;  // (b,)
};

__global__ void __launch_bounds__(kShadeBlock) finish_kernel(FinishParams p) {
  const long long i = (long long)blockIdx.x * kShadeBlock + threadIdx.x;
  const long long b = p.b;
  if (i >= b) return;
  float* st = p.st;
  const bool lane = p.depth != nullptr;
  if (!(st[12 * b + i] > 0.5f)) {
    p.live[i] = 0;
    if (lane) {  // _park, and the plain update's throughput * 0
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        st[r * b + i] = PARK_ORIGIN;
        st[(3 + r) * b + i] = PARK_DIR;
        st[(6 + r) * b + i] = st[(6 + r) * b + i] * 0.0f;
      }
    }
    return;
  }
  const V3 ro = mk(st[0 * b + i], st[1 * b + i], st[2 * b + i]);
  const V3 rd = mk(st[3 * b + i], st[4 * b + i], st[5 * b + i]);
  V3 thr = mk(st[6 * b + i], st[7 * b + i], st[8 * b + i]);
  const float* sf = p.surf;
  const V3 point = mk(sf[SF_POINT * b + i], sf[(SF_POINT + 1) * b + i], sf[(SF_POINT + 2) * b + i]);
  const V3 n = mk(sf[SF_NGEOM * b + i], sf[(SF_NGEOM + 1) * b + i], sf[(SF_NGEOM + 2) * b + i]);
  const V3 color = mk(sf[SF_COLOR * b + i], sf[(SF_COLOR + 1) * b + i], sf[(SF_COLOR + 2) * b + i]);
  const float mkind = sf[SF_MKIND * b + i];
  const int level = lane ? p.depth[i] : p.level;
  const uint32_t base = p.base + p.stride * (uint32_t)level;
  const uint32_t seed = (uint32_t)__ldg(&p.seed_off[0]);
  const uint32_t key = work_key(seed, (uint32_t)p.wid[i] + (uint32_t)__ldg(&p.seed_off[1]));
  const V3 v = neg(rd);
  V3 next_dir, weight;
  V3 next_origin = point;
  bool alive;
  if (mkind == (float)M_MIRROR) {
    next_dir = reflect(v, n);
    weight = color;
    alive = true;
  } else if (mkind == (float)M_DIELECTRIC) {
    const float ior = sf[SF_IOR * b + i];
    const bool outer = sf[SF_OUTER * b + i] > 0.5f;
    const float cos_i = t_clamp(dot(v, n), 0.0f, 1.0f);
    const float eta = outer ? 1.0f / ior : ior;
    const float sin2_t = eta * eta * t_clamp_min(1.0f - cos_i * cos_i, 0.0f);
    const bool tir = sin2_t > 1.0f;
    const float cos_t = sqrtf(t_clamp_min(1.0f - sin2_t, 0.0f));
    const float q = (eta - 1.0f) / (eta + 1.0f);
    const float r0 = q * q;
    const float refl_p = r0 + (1.0f - r0) * pow5_torch(1.0f - cos_i);
    const bool do_reflect = tir || (uniform_ctr(key, base + p.diel) < refl_p);
    if (do_reflect) {
      next_dir = reflect(v, n);
    } else {  // transmitted rays continue from just past the surface
      next_dir = normalize(add(scl(rd, eta), scl(n, eta * cos_i - cos_t)), 1e-20f);
      next_origin = add(ro, scl(rd, sf[SF_T * b + i] + 1e-4f));
    }
    weight = (do_reflect || !outer) ? mk(1.0f, 1.0f, 1.0f) : color;
    alive = true;
  } else {
    const V3 l = mk(p.lpdf[0][i], p.lpdf[1][i], p.lpdf[2][i]);
    const float pdf = p.lpdf[3][i];
    const V3 f = eval_brdf<true>(l, n, v, color, sf[SF_METAL * b + i], sf[SF_ROUGH * b + i],
                                 (int)mkind);
    // the reference's cos term is the signed l.n_geom; the fast sampler never
    // accepts l below the horizon, so the clamp only guards its kill-path zeros
    const float ldn = dot(l, n);
    const float cos_l = p.faithful ? ldn : t_clamp_min(ldn, 0.0f);
    weight = scl(f, cos_l * (1.0f / t_clamp_min(pdf, 1e-20f)));
    next_dir = l;
    alive = p.ok[i] != 0;
  }
  thr = mul(thr, alive ? weight : mk(0.0f, 0.0f, 0.0f));
  if (p.rr && alive && level >= p.rr_start) {  // Russian roulette
    const float pr = t_clamp(t_max(t_max(thr.x, thr.y), thr.z), RR_MIN_P, 1.0f);
    alive = uniform_ctr(key, base + p.rr_off) < pr;
    if (alive) thr = scl(thr, 1.0f / pr);
  }
  if (lane && !alive) {
    next_origin = mk(PARK_ORIGIN, PARK_ORIGIN, PARK_ORIGIN);
    next_dir = mk(PARK_DIR, PARK_DIR, PARK_DIR);
  }
  const float rows[N_STATE - 3] = {next_origin.x, next_origin.y, next_origin.z, next_dir.x,
                                   next_dir.y,    next_dir.z,    thr.x,         thr.y,
                                   thr.z,         alive ? 1.0f : 0.0f};
#pragma unroll
  for (int r = 0; r < 9; ++r) st[r * b + i] = rows[r];
  st[12 * b + i] = rows[9];
  p.live[i] = alive ? 1 : 0;
}

int grid_of(long long b) { return (int)((b + kShadeBlock - 1) / kShadeBlock); }

}  // namespace

// N1a. st: the (13, b) state, updated in place; t, idx: the nearest hit over
// the finite table; packed (36, n), plane (20, np) with np = 0 for a scene
// without planes, pl_mask (np,) bool; depth: (b,) int32 or null; surf
// (21, b) and need (b,) bool out, not touched with final_only. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for arguments the
// kernel does not take). Never synchronises.
extern "C" int rt_launch_shade(void* st, long long b, const void* t, const void* idx,
                               const void* packed, int n, const void* plane,
                               const void* pl_mask, int np, int any_rotation, int any_nontri,
                               const void* depth, int last, float bg0, float bg1, float bg2,
                               int final_only, void* surf, void* need, void* stream) {
  if (b < 0 || b > 0x7fffffffLL * kShadeBlock || n < 1 || np < 0) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  ShadeParams p{};
  p.st = static_cast<float*>(st);
  p.b = b;
  p.t = static_cast<const float*>(t);
  p.idx = static_cast<const int*>(idx);
  p.packed = static_cast<const float*>(packed);
  p.n = n;
  p.plane = static_cast<const float*>(plane);
  p.pl_mask = static_cast<const uint8_t*>(pl_mask);
  p.np = np;
  p.any_rotation = any_rotation;
  p.any_nontri = any_nontri;
  p.depth = static_cast<const int*>(depth);
  p.last = last;
  p.bg0 = bg0;
  p.bg1 = bg1;
  p.bg2 = bg2;
  p.final_only = final_only;
  p.surf = static_cast<float*>(surf);
  p.need = static_cast<uint8_t*>(need);
  shade_kernel<<<grid_of(b), kShadeBlock, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// N1b. st: the (13, b) state, updated in place; surf: N1a's rows; lpdf: host
// array of four device pointers (l.x, l.y, l.z, pdf), ok (b,) bool, wid
// (b,) int32, seed_off two int64 on the device (seed, work-id offset). Draws
// sit at base + stride * (depth[i] or level) + diel | rr_off. live (b,) bool
// out. Returns cudaGetLastError() after the launch. Never synchronises.
extern "C" int rt_launch_finish(void* st, long long b, const void* surf,
                                const void* const* lpdf, const void* ok, const void* wid,
                                const void* seed_off, unsigned base, unsigned stride,
                                unsigned diel, unsigned rr_off, const void* depth, int level,
                                int rr, int rr_start, int faithful, void* live, void* stream) {
  if (b < 0 || b > 0x7fffffffLL * kShadeBlock) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  FinishParams p{};
  p.st = static_cast<float*>(st);
  p.b = b;
  p.surf = static_cast<const float*>(surf);
  for (int r = 0; r < 4; ++r) p.lpdf[r] = static_cast<const float*>(lpdf[r]);
  p.ok = static_cast<const uint8_t*>(ok);
  p.wid = static_cast<const int*>(wid);
  p.seed_off = static_cast<const long long*>(seed_off);
  p.base = base;
  p.stride = stride;
  p.diel = diel;
  p.rr_off = rr_off;
  p.depth = static_cast<const int*>(depth);
  p.level = level;
  p.rr = rr;
  p.rr_start = rr_start;
  p.faithful = faithful;
  p.live = static_cast<uint8_t*>(live);
  finish_kernel<<<grid_of(b), kShadeBlock, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
