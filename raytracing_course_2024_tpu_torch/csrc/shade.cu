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
//   surface (K3's SF_ rows and N1b's SR_ record below) and the sampler's
//   `need` flag (live and not a delta material). In the lane layout
//   (`depth` given) alive becomes "hit and depth < last". Emission is used
//   up here and not written. A lane dead on entry gets need = 0 and keeps
//   its rows; a lane that misses gets no surface (zero rows where a lane of
//   its group hit, no record). Nothing downstream reads those rows of those
//   lanes. Given a `count`, N1a adds the lanes alive on its entry: the path
//   vertices of its level, counted for the caller, so that the batch route
//   launches no reduction per level (K1's count on the fused route). Each
//   block counts them in one barrier (__syncthreads_count, which also tells
//   a block that stages the planes whether it has a live lane) and adds them
//   with one atomic; the lane engines pass none, as N5 counts theirs. The
//   count costs N1a 0.13-0.16 ms of a 5.1 ms Cornell frame with roulette,
//   where the reductions it replaces took 2.6 ms (NVIDIA H100 80GB HBM3,
//   700 W). A barrier at the block's end, once its warps are done, saved
//   0.03 ms of that and cost a staged block a second barrier.
// * N1b reads the state, the surface, the sampler's (l, pdf, ok) and
//   draws u_diel (and u_rr under roulette) from the counter RNG at the
//   bounce's counters: the batch layout (one bounce index for all lanes) or
//   the lane layout (each lane's depth, as K1's at_depth). It writes the next
//   ray, the throughput and alive in place and a bool `live` row (the next
//   nearest hit's mask). A lane dead on entry gets live = 0; in the lane
//   layout its ray is parked and its throughput zeroed as
//   integrator/wavefront.py:_park and the plain update do; in the batch
//   layout, where a live lane shares its sectors, the same rows (a zero
//   throughput), else its rows are left as they are (the plain version
//   writes them, nobody reads them: the radiance and alive are the lane's
//   result).
//
// What bounds them on an H100: device memory, and where each lane's bytes
// sit. Per hit lane N1a reads 52 B of state, 8 B of hit and the winner's
// record, and writes 16 B of state, 52 B of K3's rows, a 32 B record and the
// flag; N1b reads ~110 B and writes ~40 B. A few hundred fp32 operations per
// lane are far below the card's 67 TFLOP/s at that rate. On bounce rays the
// live lanes are scattered, so a lane's row reads and writes are each a 32 B
// sector of their own; the design cuts the number of sectors a lane touches:
// * N1a gathers its winner from the scene's row-major primitive records
//   (ModularScene.prim_rec, ops/scene_intersect.py:PREC_COLS): everything a
//   triangle lane reads (type, vertices, shading normals, material) is the
//   first 128 B of a 160 B record, 8 float4 loads of one line, where a column
//   of the (36, n) table at stride n cost one sector per float (29 for a
//   triangle). Boxes and ellipsoids read position and rotation from the
//   record's last 32 B.
// * The fields only N1b reads (color, metallic, ior, mkind, is_outer, t) are
//   one 32 B record per lane (two float4), written and read as one sector;
//   K3's 13 inputs stay rows in its order. N1b reads ro only on transmitted
//   lanes and the work id only where a draw is used (up front under
//   roulette); what a common lane needs, the sampler's output included, in
//   one round of loads, so a lane waits on device memory twice (alive, then
//   the rest).
// * Rows are written in whole 32 B sectors: a row of the state or of K3's
//   inputs is written by every lane of an 8-lane group in which one lane
//   writes it (a warp ballot says which), a lane with nothing to say
//   writing back what it read, or a zero where nobody reads the row. A
//   sector written in part costs device memory a read before the write:
//   13 rows written on a random 38 % of 921,600 lanes take 0.0443 ms lane
//   by lane and 0.0225 ms in whole sectors (kernel_times.py
//   --sector-writes; NVIDIA H100 80GB HBM3, 700.00 W).
// * Each block of N1a stages the plane table and its mask in shared memory
//   (up to kStagePlanes planes; a larger table is read where it lies), after
//   __syncthreads_count tells it that one of its lanes is live: a block of dead
//   lanes writes its flags and leaves without staging. A warp whose lanes
//   are all dead (__ballot_sync) writes its need / live flags (and in the
//   lane layout N1b's park rows) and nothing else.
// The rows of the (13, b) state stay rows: K1-K6 and the lane engines read
// them so. One thread per lane over a grid of the lanes.

#include "common.cuh"

namespace {

constexpr int kShadeBlock = 256;
constexpr int N_STATE = 13;

// N1a's surface (ops/shade.py Surf): the (SURF_ROWS, b) rows, the sampler
// K3's 13 inputs in its order (point, n_geom, n_shade, v, roughness), and the
// (b, 8) records, the fields only N1b reads, 32 B per lane
constexpr int SF_POINT = 0, SF_NGEOM = 3, SF_ROUGH = 12, SURF_ROWS = 13;
constexpr int SR_COLOR = 0, SR_METAL = 3, SR_IOR = 4, SR_MKIND = 5, SR_OUTER = 6, SR_T = 7;

// ops/scene_intersect.py PREC_COLS: a primitive's 40-float record; a
// triangle lane reads the first R_LINE floats (128 B), boxes and ellipsoids
// also the last 8 (position, rotation)
constexpr int R_PTYPE = 0, R_P0 = 1, R_P1 = 4, R_P2 = 7, R_SN0 = 10, R_SN1 = 13, R_SN2 = 16;
constexpr int R_COLOR = 19, R_METAL = 22, R_ROUGH = 23, R_EMIT = 24, R_IOR = 27, R_MKIND = 28;
constexpr int R_LINE = 32, R_POS = 32, R_ROT = 35, R_WIDTH = 40;
// scene/types.py PlaneCol
constexpr int PL_NORMAL = 0, PL_POS = 3, PL_ROT = 6, PL_COLOR = 10, PL_METAL = 13;
constexpr int PL_ROUGH = 14, PL_EMIT = 15, PL_IOR = 18, PL_MKIND = 19, PL_COUNT = 20;
// planes a block stages in shared memory: 256 x 81 B = 20.3 KB
constexpr int kStagePlanes = 256;

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
__device__ __forceinline__ V3 v3_at(const float* r, int k) { return mk(r[k], r[k + 1], r[k + 2]); }

struct Quat4 {
  float x, y, z, w;
};
// ops/vec.py Quat.rotate and inverse_rotate (the conjugate's rotate)
__device__ __forceinline__ V3 rotate(Quat4 q, V3 v) { return quat_rotate(q.x, q.y, q.z, q.w, v); }
__device__ __forceinline__ V3 inverse_rotate(Quat4 q, V3 v) {
  return quat_rotate(-q.x, -q.y, -q.z, q.w, v);
}

// The (20, np) plane table and its mask, in shared memory once staged (plain
// loads: a generic pointer may point there).
struct Planes {
  const float* tab;
  const uint8_t* mask;
  int np;
  __device__ __forceinline__ float f(int row, int j) const { return tab[row * np + j]; }
  __device__ __forceinline__ V3 v3(int row, int j) const {
    return mk(f(row, j), f(row + 1, j), f(row + 2, j));
  }
  __device__ __forceinline__ Quat4 q(int row, int j) const {
    return Quat4{f(row, j), f(row + 1, j), f(row + 2, j), f(row + 3, j)};
  }
};

struct ShadeParams {
  float* st;  // (13, b)
  long long b;
  const float* t;  // (b,) nearest over the finite table, +inf on a miss
  const int* idx;  // (b,) its row
  const float* prim_rec;  // (n, R_WIDTH)
  int n;
  const float* plane;  // (20, np)
  const uint8_t* pl_mask;
  int np;  // 0: the scene has no planes
  int staged;  // 0 < np <= kStagePlanes: each block copies the planes to shared memory
  int any_rotation, any_nontri;
  const int* depth;  // (b,) the lane layout's depths, or null
  int last;
  float bg0, bg1, bg2;
  int final_only;   // the batch scan's last level: radiance and alive only
  float* surf_rows;  // (SURF_ROWS, b)
  float4* surf_rec;  // (b, 8) as 2 b float4
  uint8_t* need;     // (b,)
  unsigned long long* count;  // += lanes alive on entry, or nullptr
};

struct Material {
  V3 color, emission;
  float metallic, roughness, ior, mkind;
};

// ops/scene_intersect.py:_fold_in_planes: the nearest plane with t > 0, the
// first on a tie (argmin), against the finite table's t.
__device__ __forceinline__ void fold_planes(const Planes& pl, V3 ro, V3 rd, float& t, int& idx,
                                            bool& is_plane, bool& valid) {
  float pt = INFINITY;
  int pidx = 0;
  for (int j = 0; j < pl.np; ++j) {
    const Quat4 q = pl.q(PL_ROT, j);
    const V3 o = inverse_rotate(q, sub(ro, pl.v3(PL_POS, j)));
    const V3 d = inverse_rotate(q, rd);
    const V3 nrm = pl.v3(PL_NORMAL, j);
    const float denom = dot(nrm, d);
    const bool den_ok = fabsf(denom) > 1e-30f;
    float tj = -dot(nrm, o) / (den_ok ? denom : 1e-30f);
    tj = (den_ok && tj > 0.0f && pl.mask[j] != 0) ? tj : INFINITY;
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
__device__ void detail(const ShadeParams& p, const Planes& pl, V3 ro, V3 rd, int idx,
                       bool is_plane, V3& n_geom, V3& n_shade, bool& outer, Material& m) {
  if (is_plane) {
    const int j = min(max(idx, 0), pl.np - 1);
    const V3 pw = rotate(pl.q(PL_ROT, j), normalize(pl.v3(PL_NORMAL, j), 1e-30f));
    outer = dot(pw, rd) < 0.0f;
    n_geom = n_shade = scl(pw, outer ? 1.0f : -1.0f);
    m = Material{pl.v3(PL_COLOR, j), pl.v3(PL_EMIT, j), pl.f(PL_METAL, j), pl.f(PL_ROUGH, j),
                 pl.f(PL_IOR, j), pl.f(PL_MKIND, j)};
    return;
  }
  // the winner's record: one 128 B line of 8 float4 loads
  const float4* rec = reinterpret_cast<const float4*>(p.prim_rec) +
                      (long long)min(max(idx, 0), p.n - 1) * (R_WIDTH / 4);
  float r[R_LINE];
#pragma unroll
  for (int k = 0; k < R_LINE / 4; ++k) {
    const float4 q = __ldg(rec + k);
    r[4 * k] = q.x;
    r[4 * k + 1] = q.y;
    r[4 * k + 2] = q.z;
    r[4 * k + 3] = q.w;
  }
  m = Material{v3_at(r, R_COLOR), v3_at(r, R_EMIT), r[R_METAL], r[R_ROUGH], r[R_IOR], r[R_MKIND]};
  const float ptype = p.any_nontri ? r[R_PTYPE] : (float)K_TRI;
  const V3 p0 = v3_at(r, R_P0);
  if (ptype != (float)K_BOX && ptype != (float)K_ELL) {  // triangle, in world space
    const V3 b = v3_at(r, R_P1), cc = v3_at(r, R_P2);
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
    const V3 sn0 = v3_at(r, R_SN0), sn1 = v3_at(r, R_SN1), sn2 = v3_at(r, R_SN2);
    const V3 ns = normalize(add(add(sn0, scl(sub(sn1, sn0), u)), scl(sub(sn2, sn0), v)), 1e-30f);
    const float sign = outer ? 1.0f : -1.0f;
    n_geom = scl(flat_n, sign);
    n_shade = scl(ns, sign);
    return;
  }
  const float4 tail0 = __ldg(rec + R_POS / 4), tail1 = __ldg(rec + R_POS / 4 + 1);
  static_assert(R_ROT == R_POS + 3, "rotation follows position");
  const Quat4 q{tail0.w, tail1.x, tail1.y, tail1.z};
  V3 o = sub(ro, mk(tail0.x, tail0.y, tail0.z));
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

// Rows are written whole sector by sector: a 32 B sector of a float row is 8
// lanes, and a sector written in part costs device memory a read before the
// write. So where one lane of an 8-lane group writes a row, every lane of the
// group (below b) writes it: a lane that has nothing to say writes back the
// value it read, or a zero where nobody reads the row (the surface of a
// missed lane). A group of dead lanes writes nothing but its flags.
constexpr unsigned kFull = 0xffffffffu;
__device__ __forceinline__ unsigned group_of_lane() { return 0xffu << (threadIdx.x & 24u); }
// a store the compiler keeps when it writes back the value just read
__device__ __forceinline__ void store(float* addr, float v) {
  asm volatile("st.global.f32 [%0], %1;" ::"l"(addr), "f"(v));
}

__global__ void __launch_bounds__(kShadeBlock) shade_kernel(ShadeParams p) {
  extern __shared__ float4 stage_raw[];  // the staged plane table, then its mask
  const long long i = (long long)blockIdx.x * kShadeBlock + threadIdx.x;
  const long long b = p.b;
  float* st = p.st;
  const bool in = i < b;
  const float alive_in = in ? st[12 * b + i] : 0.0f;
  const bool live = alive_in > 0.5f;
  Planes pl{p.plane, p.pl_mask, p.np};
  // the block's lanes alive on entry: what `count` gets, and whether a staged
  // block reads the planes at all (the same for every thread of the block)
  int block_live = 1;
  if (p.count != nullptr || p.staged) {
    block_live = __syncthreads_count(live);
    if (p.count != nullptr && threadIdx.x == 0 && block_live > 0)
      atomicAdd(p.count, (unsigned long long)block_live);
  }
  if (p.staged) {
    if (block_live == 0) {  // no live lane: no plane is read
      if (in && !p.final_only) p.need[i] = 0;
      return;
    }
    float* tab = reinterpret_cast<float*>(stage_raw);
    uint8_t* mask = reinterpret_cast<uint8_t*>(tab + PL_COUNT * p.np);
    for (int k = threadIdx.x; k < PL_COUNT * p.np; k += kShadeBlock) tab[k] = __ldg(p.plane + k);
    for (int k = threadIdx.x; k < p.np; k += kShadeBlock) mask[k] = __ldg(p.pl_mask + k);
    __syncthreads();
    pl = Planes{tab, mask, p.np};
  }
  const unsigned live_lanes = __ballot_sync(kFull, live);
  if (live_lanes == 0u) {  // a dead warp: its flags and nothing else
    if (in && !p.final_only) p.need[i] = 0;
    return;
  }
  const unsigned group = group_of_lane();
  const bool group_live = in && (live_lanes & group) != 0u;
  V3 rad;
  if (group_live) rad = mk(st[9 * b + i], st[10 * b + i], st[11 * b + i]);
  V3 ro, rd, n_geom, n_shade;
  float t = INFINITY;
  bool valid = false, alive = false, outer = true;
  Material m{};
  if (live) {
    ro = mk(st[0 * b + i], st[1 * b + i], st[2 * b + i]);
    rd = mk(st[3 * b + i], st[4 * b + i], st[5 * b + i]);
    const V3 thr = mk(st[6 * b + i], st[7 * b + i], st[8 * b + i]);
    t = p.t[i];
    int idx = p.idx[i];
    const int depth = p.depth != nullptr ? p.depth[i] : 0;
    bool is_plane = false;
    valid = isfinite(t);
    if (p.np > 0) fold_planes(pl, ro, rd, t, idx, is_plane, valid);
    V3 add_rad;
    if (!valid) {
      add_rad = mul(thr, mk(p.bg0, p.bg1, p.bg2));
    } else if (p.final_only) {  // the emission alone: one float4 of the record
      if (is_plane) {
        add_rad = mul(thr, pl.v3(PL_EMIT, min(max(idx, 0), pl.np - 1)));
      } else {
        const float4 e = __ldg(reinterpret_cast<const float4*>(
            p.prim_rec + (long long)min(max(idx, 0), p.n - 1) * R_WIDTH + R_EMIT));
        add_rad = mul(thr, mk(e.x, e.y, e.z));
      }
    } else {
      detail(p, pl, ro, rd, idx, is_plane, n_geom, n_shade, outer, m);
      add_rad = mul(thr, m.emission);
    }
    rad = add(rad, add_rad);
    alive = valid;
    if (valid && p.depth != nullptr) alive = depth < p.last;
  }
  if (group_live) {
    store(st + 9 * b + i, rad.x);
    store(st + 10 * b + i, rad.y);
    store(st + 11 * b + i, rad.z);
    store(st + 12 * b + i, live && !alive ? 0.0f : alive_in);
  }
  if (p.final_only) return;
  const bool hit = live && valid;
  const unsigned hit_lanes = __ballot_sync(kFull, hit);
  const bool delta = m.mkind == (float)M_MIRROR || m.mkind == (float)M_DIELECTRIC;
  if (in) p.need[i] = (hit && alive && !delta) ? 1 : 0;
  if (!in || (hit_lanes & group) == 0u) return;
  const V3 point = hit ? add(ro, scl(rd, t - EPS_BACKOFF)) : mk(0.0f, 0.0f, 0.0f);
  const V3 v = hit ? neg(rd) : mk(0.0f, 0.0f, 0.0f);
  if (!hit) n_geom = n_shade = mk(0.0f, 0.0f, 0.0f);
  float* sf = p.surf_rows;
  const float rows[SURF_ROWS] = {point.x,  point.y,  point.z,   n_geom.x,  n_geom.y,
                                 n_geom.z, n_shade.x, n_shade.y, n_shade.z, v.x,
                                 v.y,      v.z,      hit ? m.roughness : 0.0f};
#pragma unroll
  for (int r = 0; r < SURF_ROWS; ++r) sf[r * b + i] = rows[r];
  static_assert(SR_COLOR == 0 && SR_METAL == 3 && SR_IOR == 4 && SR_MKIND == 5 && SR_OUTER == 6 &&
                    SR_T == 7,
                "the record's order");
  if (hit) {  // a lane's record is a sector of its own
    p.surf_rec[2 * i] = make_float4(m.color.x, m.color.y, m.color.z, m.metallic);
    p.surf_rec[2 * i + 1] = make_float4(m.ior, m.mkind, outer ? 1.0f : 0.0f, t);
  }
}

struct FinishParams {
  float* st;  // (13, b)
  long long b;
  const float* surf_rows;    // (SURF_ROWS, b)
  const float4* surf_rec;    // (b, 8) as 2 b float4
  const float* lpdf[4];      // the sampler's l.x, l.y, l.z, pdf
  const uint8_t* ok;         // (b,)
  const int* wid;            // (b,)
  const long long* seed_off;  // (2,): seed, wid_off (low 32 bits of each)
  uint32_t base, stride, diel, rr_off;  // counters: base + stride * depth (+ diel | rr_off)
  const int* depth;       // (b,) the lane layout, or null: the batch layout at `level`
  int level, rr, rr_start, faithful;
  uint8_t* live;  // (b,)
};

// the counter key of the lane with work id `wid`
__device__ __forceinline__ uint32_t lane_key(const FinishParams& p, int wid) {
  return work_key((uint32_t)__ldg(&p.seed_off[0]),
                  (uint32_t)wid + (uint32_t)__ldg(&p.seed_off[1]));
}

__global__ void __launch_bounds__(kShadeBlock) finish_kernel(FinishParams p) {
  const long long i = (long long)blockIdx.x * kShadeBlock + threadIdx.x;
  const long long b = p.b;
  const bool in = i < b;
  float* st = p.st;
  const bool lane = p.depth != nullptr;
  const float alive_in = in ? st[12 * b + i] : 0.0f;
  const bool live = alive_in > 0.5f;
  const unsigned live_lanes = __ballot_sync(kFull, live);
  if (!in) return;
  if (!live) {
    p.live[i] = 0;
    // the lane layout: _park, and the plain update's throughput * 0; the
    // batch layout, where nobody reads a dead lane's ray: the same rows
    // without the throughput's read, where a live lane shares the sectors
    const bool group_live = (live_lanes & group_of_lane()) != 0u;
    if (lane || group_live) {
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        st[r * b + i] = PARK_ORIGIN;
        st[(3 + r) * b + i] = PARK_DIR;
        st[(6 + r) * b + i] = lane ? st[(6 + r) * b + i] * 0.0f : 0.0f;
      }
    }
    if (group_live) store(st + 12 * b + i, alive_in);
    return;
  }
  // one round of loads for what most lanes need: the ray, the throughput,
  // the surface, and the sampler's output of a sampled lane (read before the
  // material says whether the lane is one); the work id up front under
  // roulette, which draws on most lanes
  const V3 rd = mk(st[3 * b + i], st[4 * b + i], st[5 * b + i]);
  V3 thr = mk(st[6 * b + i], st[7 * b + i], st[8 * b + i]);
  const float4 rec0 = __ldg(p.surf_rec + 2 * i), rec1 = __ldg(p.surf_rec + 2 * i + 1);
  const float* sf = p.surf_rows;
  const V3 n = mk(sf[SF_NGEOM * b + i], sf[(SF_NGEOM + 1) * b + i], sf[(SF_NGEOM + 2) * b + i]);
  const V3 point = mk(sf[SF_POINT * b + i], sf[(SF_POINT + 1) * b + i], sf[(SF_POINT + 2) * b + i]);
  const V3 l = mk(p.lpdf[0][i], p.lpdf[1][i], p.lpdf[2][i]);
  const float pdf = p.lpdf[3][i], roughness = sf[SF_ROUGH * b + i];
  const bool ok = p.ok[i] != 0;
  const int level = lane ? p.depth[i] : p.level;
  const int wid_rr = p.rr ? p.wid[i] : 0;
  const V3 color = mk(rec0.x, rec0.y, rec0.z);
  const float metallic = rec0.w, ior = rec1.x, mkind = rec1.y, t_hit = rec1.w;
  const bool outer = rec1.z > 0.5f;
  const uint32_t base = p.base + p.stride * (uint32_t)level;
  const V3 v = neg(rd);
  V3 next_dir, weight;
  bool alive, transmitted = false;
  if (mkind == (float)M_MIRROR) {
    next_dir = reflect(v, n);
    weight = color;
    alive = true;
  } else if (mkind == (float)M_DIELECTRIC) {
    const float cos_i = t_clamp(dot(v, n), 0.0f, 1.0f);
    const float eta = outer ? 1.0f / ior : ior;
    const float sin2_t = eta * eta * t_clamp_min(1.0f - cos_i * cos_i, 0.0f);
    const bool tir = sin2_t > 1.0f;
    const float cos_t = sqrtf(t_clamp_min(1.0f - sin2_t, 0.0f));
    const float q = (eta - 1.0f) / (eta + 1.0f);
    const float r0 = q * q;
    const float refl_p = r0 + (1.0f - r0) * pow5_torch(1.0f - cos_i);
    const bool do_reflect =
        tir || (uniform_ctr(lane_key(p, p.rr ? wid_rr : p.wid[i]), base + p.diel) < refl_p);
    if (do_reflect) {
      next_dir = reflect(v, n);
    } else {  // transmitted rays continue from just past the surface
      next_dir = normalize(add(scl(rd, eta), scl(n, eta * cos_i - cos_t)), 1e-20f);
      transmitted = true;
    }
    weight = (do_reflect || !outer) ? mk(1.0f, 1.0f, 1.0f) : color;
    alive = true;
  } else {
    const V3 f = eval_brdf<true>(l, n, v, color, metallic, roughness, (int)mkind);
    // the reference's cos term is the signed l.n_geom; the fast sampler never
    // accepts l below the horizon, so the clamp only guards its kill-path zeros
    const float ldn = dot(l, n);
    const float cos_l = p.faithful ? ldn : t_clamp_min(ldn, 0.0f);
    weight = scl(f, cos_l * (1.0f / t_clamp_min(pdf, 1e-20f)));
    next_dir = l;
    alive = ok;
  }
  thr = mul(thr, alive ? weight : mk(0.0f, 0.0f, 0.0f));
  if (p.rr && alive && level >= p.rr_start) {  // Russian roulette
    const float pr = t_clamp(t_max(t_max(thr.x, thr.y), thr.z), RR_MIN_P, 1.0f);
    alive = uniform_ctr(lane_key(p, wid_rr), base + p.rr_off) < pr;
    if (alive) thr = scl(thr, 1.0f / pr);
  }
  V3 next_origin;
  if (lane && !alive) {
    next_origin = mk(PARK_ORIGIN, PARK_ORIGIN, PARK_ORIGIN);
    next_dir = mk(PARK_DIR, PARK_DIR, PARK_DIR);
  } else if (transmitted) {
    const V3 ro = mk(st[0 * b + i], st[1 * b + i], st[2 * b + i]);
    next_origin = add(ro, scl(rd, t_hit + 1e-4f));
  } else {
    next_origin = point;
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

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

}  // namespace

// N1a. st: the (13, b) state, updated in place; t, idx: the nearest hit over
// the finite table; prim_rec (n, 40) the primitive records, 16-byte aligned;
// plane (20, np) with np = 0 for a scene without planes, pl_mask (np,) bool;
// depth: (b,) int32 or null; surf_rows (13, b), surf_rec (b, 8) 16-byte
// aligned and need (b,) bool out, not touched (and may be null) with
// final_only. count: one int64 on the device that gets the lanes alive on
// entry added, or null. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take). Never
// synchronises.
extern "C" int rt_launch_shade(void* st, long long b, const void* t, const void* idx,
                               const void* prim_rec, int n, const void* plane,
                               const void* pl_mask, int np, int any_rotation, int any_nontri,
                               const void* depth, int last, float bg0, float bg1, float bg2,
                               int final_only, void* surf_rows, void* surf_rec, void* need,
                               void* count, void* stream) {
  if (b < 0 || b > 0x7fffffffLL * kShadeBlock || n < 1 || np < 0 || !aligned16(prim_rec))
    return (int)cudaErrorInvalidValue;
  if (!final_only && (surf_rows == nullptr || need == nullptr || !aligned16(surf_rec) ||
                      surf_rec == nullptr))
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  ShadeParams p{};
  p.st = static_cast<float*>(st);
  p.b = b;
  p.t = static_cast<const float*>(t);
  p.idx = static_cast<const int*>(idx);
  p.prim_rec = static_cast<const float*>(prim_rec);
  p.n = n;
  p.plane = static_cast<const float*>(plane);
  p.pl_mask = static_cast<const uint8_t*>(pl_mask);
  p.np = np;
  p.staged = np > 0 && np <= kStagePlanes;
  p.any_rotation = any_rotation;
  p.any_nontri = any_nontri;
  p.depth = static_cast<const int*>(depth);
  p.last = last;
  p.bg0 = bg0;
  p.bg1 = bg1;
  p.bg2 = bg2;
  p.final_only = final_only;
  p.surf_rows = static_cast<float*>(surf_rows);
  p.surf_rec = static_cast<float4*>(surf_rec);
  p.need = static_cast<uint8_t*>(need);
  p.count = static_cast<unsigned long long*>(count);
  const size_t smem = p.staged ? (size_t)np * (PL_COUNT * sizeof(float) + 1) : 0;
  shade_kernel<<<grid_of(b), kShadeBlock, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// N1b. st: the (13, b) state, updated in place; surf_rows (13, b) and
// surf_rec (b, 8), 16-byte aligned: N1a's surface; lpdf: host array of four
// device pointers (l.x, l.y, l.z, pdf), ok (b,) bool, wid (b,) int32,
// seed_off two int64 on the device (seed, work-id offset). Draws sit at base
// + stride * (depth[i] or level) + diel | rr_off. live (b,) bool out. Returns
// cudaGetLastError() after the launch. Never synchronises.
extern "C" int rt_launch_finish(void* st, long long b, const void* surf_rows,
                                const void* surf_rec, const void* const* lpdf, const void* ok,
                                const void* wid, const void* seed_off, unsigned base,
                                unsigned stride, unsigned diel, unsigned rr_off,
                                const void* depth, int level, int rr, int rr_start,
                                int faithful, void* live, void* stream) {
  if (b < 0 || b > 0x7fffffffLL * kShadeBlock || !aligned16(surf_rec))
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  FinishParams p{};
  p.st = static_cast<float*>(st);
  p.b = b;
  p.surf_rows = static_cast<const float*>(surf_rows);
  p.surf_rec = static_cast<const float4*>(surf_rec);
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
