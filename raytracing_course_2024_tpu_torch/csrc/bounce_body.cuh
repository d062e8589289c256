// The fused bounce's device code, shared by the bounce kernels K1/K2
// (bounce.cu) and the persistent round K5 (persistent.cu), so all three run
// the same body: the nearest hit over the scene's entries, the bounce itself
// (emission / background, MIS mixture sampling, BRDF * cos / pdf with
// common.cuh's eval_brdf, the MIRROR / DIELECTRIC rules) and the staging of
// the scene tables in shared memory (the camera ray is common.cuh's). The persistent grid and the queue of live
// lanes are lane_queue.cuh's, which K3 and K4 walk their batches with too.
// The plain PyTorch version is ops/bounce.py:_bounce_math. Everything sits in
// an anonymous namespace, as in common.cuh.
//
// What bounds the body on an H100 is instruction rate and latency, not
// device memory: a lane moves ~100 B of state against m x 53 fp32 operations
// of the intersection loop (without FMA contraction and with an IEEE division
// per entry, ~86 scheduler slots) and a few hundred more of the sampler, some
// 4,600 instructions of straight-line code in all, at 80 registers and so 24
// warps per SM. A launch's time follows the passes its warps make over that
// code. The design makes passes for live lanes only and keeps the loop's
// inner data short:
// * A persistent grid: as many blocks as the card holds at once (SM count x
//   resident blocks, asked of the runtime by grid_for), each drawing tiles of
//   kTile lanes from a counter until none is left (walk_tiles). The tables
//   are staged once per block, not once per 256 lanes, and the blocks end
//   together whatever share of their tiles was dead.
// * Compaction of the live lanes (push_tile, walk_tiles): every thread reads
//   the alive flag of its own lanes of a tile, a ballot and a prefix over the
//   warps' counts give each live lane a dense rank, and the lanes go to the
//   block's queue in shared memory. Whenever a block's worth of lanes waits,
//   every thread takes one and runs the body, so no warp walks the whole
//   loop for one live lane. (Two other forms were tried and did not pay:
//   ranking within one 512-lane tile left a second pass to one or two warps
//   while the rest waited at the barrier; warps that each walked tiles and
//   kept a queue of their own, with no barrier at all, ran up to twice as
//   long, the more so the larger their tiles.) A dead lane gets its few
//   stores from the thread that owns it. A lane's arithmetic is untouched,
//   so its result does not depend on its rank.
// * The loop reads entry-major records (ops/bounce.py:build_loop_records):
//   three float4 per entry, the spec word in the first one's w, read with
//   three 16-byte broadcast loads instead of ten 4-byte ones at stride m.
//   The 19 attribute rows of the (C_GEO, m) table stay in device memory and
//   are read for the winner only. Shared memory per block: 6,144 B of
//   records, 2,432 B of lights, (kBlock + kTile) x 4 B of lane queue.
// * The loop keeps (t, u, v, i) only. The facing normal and the entry side
//   are computed once after it, for the winner, by the same function on the
//   same operands (test_entry<true>), so the bits are those of a loop that
//   computed them for every entry.

#pragma once

#include "common.cuh"
#include "lane_queue.cuh"

namespace {

// Blocks of kBlock threads walk tiles of kTile lanes (lane_queue.cuh). Three
// blocks stay resident per SM (kMinBlocks holds the register allocation to
// that). What else was timed on an H100 and ran slower: 128-thread blocks,
// 512-lane tiles, two or four resident blocks, the intersection loop
// unrolled by two.
constexpr int kMinBlocks = 3;

// The scene tables (device pointers) and the constants of one launch.
struct SceneArgs {
  const float* geo;   // (C_GEO, m): attributes, read for the winner
  const float4* rec;  // (m, 3): the loop's records
  int m;
  const float* lp;   // (LC_COUNT, nl)
  const int* lspec;  // (nl,)
  int nl, num_lights;
  float bg0, bg1, bg2;
  int max_tries;
};

// ---- section 1: nearest hit over the entries ---------------------------------
struct Hit {
  float t, u, v;
  int i;
  V3 n_geom;  // normalized, facing the ray
  bool outer, tri;
};

// The nearest hit: strict t < best_t, so the lowest index wins a tie. On a
// miss t is inf and the other fields are unused.
__device__ Hit intersect_all(const Tables& T, V3 ro, V3 rd) {
  Hit h;
  h.t = INFINITY;
  h.u = 0.0f;
  h.v = 0.0f;
  h.i = 0;
  Facing f;
  f.cn = mk(0.0f, 0.0f, 1.0f);
  f.outer = true;
  f.tri = false;
  for (int i = 0; i < T.m; ++i) {
    float t, u, v;
    if (test_entry<false>(T.rec, i, ro, rd, t, u, v, f) && (t < h.t)) {
      h.t = t;
      h.i = i;
      h.u = u;
      h.v = v;
    }
  }
  if (isfinite(h.t)) {
    float t, u, v;
    test_entry<true>(T.rec, h.i, ro, rd, t, u, v, f);
  }
  h.n_geom = normalize(f.cn, 1e-30f);
  h.outer = f.outer;
  h.tri = f.tri;
  return h;
}

// ---- the bounce body ----------------------------------------------------------
struct Lane {
  V3 ro, rd, thr, rad;
  bool alive;
};

// One bounce of one live lane. `key` is the path's work key, `ctr` where this
// bounce's draws sit. The kernels call it for live lanes only; a dead lane's
// part (a full bounce zeroes its throughput) is theirs.
template <bool FINAL_ONLY>
__device__ Lane bounce_body(const Tables& T, const SceneArgs& p, uint32_t key, const Ctr& ctr,
                            Lane s) {
  const Hit h = intersect_all(T, s.ro, s.rd);
  const bool hit = isfinite(h.t);
  const float t_safe = hit ? h.t : 1.0f;
  const V3 point = add(s.ro, scl(s.rd, t_safe - EPS_BACKOFF));
  Lane o;
  // --- 3. emission / background
  if (!hit) {
    o.ro = point;
    o.rd = s.rd;
    o.thr = scl(s.thr, 0.0f);
    o.rad = add(s.rad, mul(s.thr, mk(p.bg0, p.bg1, p.bg2)));
    o.alive = false;
    if (FINAL_ONLY) o.thr = s.thr;
    return o;
  }
  const int bi = h.i;
  o.rad = add(s.rad, mul(s.thr, T.G3(G_EMIT, bi)));
  if (FINAL_ONLY) {
    o.ro = point;
    o.rd = s.rd;
    o.thr = s.thr;
    o.alive = true;
    return o;
  }
  // --- 2. winner attributes by index
  V3 n_shade = h.n_geom;
  if (h.tri) {
    const V3 sn0 = T.G3(G_SN0, bi), sn1 = T.G3(G_SN1, bi), sn2 = T.G3(G_SN2, bi);
    const V3 ns = add(add(sn0, scl(sub(sn1, sn0), h.u)), scl(sub(sn2, sn0), h.v));
    n_shade = scl(normalize(ns, 1e-30f), h.outer ? 1.0f : -1.0f);
  }
  const V3 color = T.G3(G_COLOR, bi);
  const int mkind = (int)T.G(G_MKIND, bi);
  const V3 n = h.n_geom;
  const V3 v_dir = scl(s.rd, -1.0f);
  V3 l, w;
  V3 next_origin = point;
  bool new_alive;
  if (mkind == M_MIRROR) {
    l = reflect(v_dir, n);
    w = color;
    new_alive = true;
  } else if (mkind == M_DIELECTRIC) {
    const float ior = T.G(G_IOR, bi);
    const float u_diel = uniform_ctr(key, ctr.base + ctr.diel);
    const float cos_i = fminf(fmaxf(dot(v_dir, n), 0.0f), 1.0f);
    const float eta = h.outer ? 1.0f / ior : ior;
    const float sin2_t = eta * eta * fmaxf(0.0f, 1.0f - cos_i * cos_i);
    const bool tir = sin2_t > 1.0f;
    const float cos_t = sqrtf(fmaxf(0.0f, 1.0f - sin2_t));
    const float rr = (eta - 1.0f) / (eta + 1.0f);
    const float r0 = rr * rr;
    const float refl_p = r0 + (1.0f - r0) * pow5(1.0f - cos_i);
    const bool do_reflect = tir || (u_diel < refl_p);
    if (do_reflect) {
      l = reflect(v_dir, n);
    } else {  // transmitted rays continue from just PAST the surface
      l = normalize(add(scl(s.rd, eta), scl(n, eta * cos_i - cos_t)), 1e-20f);
      next_origin = add(s.ro, scl(s.rd, t_safe + 1e-4f));
    }
    w = (do_reflect || !h.outer) ? mk(1.0f, 1.0f, 1.0f) : color;
    new_alive = true;
  } else {
    // --- 4. mixture sampling, 5. BRDF * cos / pdf
    const float metallic = T.G(G_METAL, bi), roughness = T.G(G_ROUGH, bi);
    float pdf;
    bool ok;
    mixture(T, key, ctr, p.max_tries, point, n, n_shade, v_dir, roughness, l, pdf, ok);
    const V3 f = eval_brdf<false>(l, n, v_dir, color, metallic, roughness, mkind);
    const float cos_l = fmaxf(dot(l, n), 0.0f);
    w = scl(f, cos_l / fmaxf(pdf, 1e-20f));
    new_alive = ok;
  }
  o.ro = next_origin;
  o.rd = l;
  o.thr = mul(s.thr, new_alive ? w : mk(0.0f, 0.0f, 0.0f));
  o.alive = new_alive;
  return o;
}

// ---- per block: the tables, the lane list, the grid ---------------------------
struct SharedTables {
  float4 rec[3 * MAX_PRIMS];
  float lp[LC_COUNT * MAX_LIGHTS];
  int lspec[MAX_LIGHTS];
};

// Once per block, before its first tile.
__device__ __forceinline__ Tables stage_tables(const SceneArgs& p, bool lights, SharedTables& sh) {
  for (int k = threadIdx.x; k < 3 * p.m; k += blockDim.x) sh.rec[k] = p.rec[k];
  if (lights) {
    for (int k = threadIdx.x; k < LC_COUNT * p.nl; k += blockDim.x) sh.lp[k] = p.lp[k];
    for (int k = threadIdx.x; k < p.nl; k += blockDim.x) sh.lspec[k] = p.lspec[k];
  }
  __syncthreads();
  return Tables{p.geo, sh.rec, p.m, sh.lp, sh.lspec, p.nl, p.num_lights};
}

// Rows 0-12 of a channel-major (rows, b) state: ro3, rd3, thr3, rad3, alive.
__device__ __forceinline__ Lane load_lane(const float* in, long long b, long long i) {
  Lane s;
  s.ro = mk(in[0 * b + i], in[1 * b + i], in[2 * b + i]);
  s.rd = mk(in[3 * b + i], in[4 * b + i], in[5 * b + i]);
  s.thr = mk(in[6 * b + i], in[7 * b + i], in[8 * b + i]);
  s.rad = mk(in[9 * b + i], in[10 * b + i], in[11 * b + i]);
  s.alive = in[12 * b + i] > 0.5f;
  return s;
}

__device__ __forceinline__ void store_lane(float* out, long long b, long long i, const Lane& o) {
  out[0 * b + i] = o.ro.x;
  out[1 * b + i] = o.ro.y;
  out[2 * b + i] = o.ro.z;
  out[3 * b + i] = o.rd.x;
  out[4 * b + i] = o.rd.y;
  out[5 * b + i] = o.rd.z;
  out[6 * b + i] = o.thr.x;
  out[7 * b + i] = o.thr.y;
  out[8 * b + i] = o.thr.z;
  out[9 * b + i] = o.rad.x;
  out[10 * b + i] = o.rad.y;
  out[11 * b + i] = o.rad.z;
  out[12 * b + i] = o.alive ? 1.0f : 0.0f;
}

SceneArgs scene_args(const void* geo, const void* rec, int m, const void* lp, const void* lspec,
                     int nl, int num_lights, float bg0, float bg1, float bg2, int max_tries) {
  return SceneArgs{static_cast<const float*>(geo), static_cast<const float4*>(rec), m,
                   static_cast<const float*>(lp), static_cast<const int*>(lspec), nl,
                   num_lights, bg0, bg1, bg2, max_tries};
}

int bad_args(long long b, int m, int nl, int num_lights, int max_tries) {
  return b < 0 || b > 0x7fffffffLL || m < 1 || m > MAX_PRIMS || nl < 1 || nl > MAX_LIGHTS ||
         num_lights < 0 || num_lights > nl || max_tries < 1;
}

}  // namespace
