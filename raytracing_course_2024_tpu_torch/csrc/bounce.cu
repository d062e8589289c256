// Fused path-tracing bounce for NVIDIA Hopper (sm_90a), hand-written CUDA.
//
// Entry points (launchers at the end of the file, plain C interface, bound
// with ctypes by ops/kernels.py):
//   rt_launch_bounce(final_only = 0)  replaces the TPU kernel K1,
//       raytracing_course_2024_tpu/ops/pallas_bounce.py:_kernel (via _run):
//       one full bounce of a live path;
//   rt_launch_bounce(final_only = 1)  the same kernel with the sampling and
//       continuation sections compiled out: the integrator's last depth
//       level (intersect + emission only);
//   rt_launch_primary                 replaces the TPU kernel K2,
//       ops/pallas_bounce.py:_primary_kernel (via _run_primary): camera
//       jitter -> pinhole ray -> bounce 0 of a fresh path.
//
// Each thread owns one lane (one path): it reads its 13 state floats
// (ro3, rd3, thr3, rad3, alive) and writes 13 back. The port may pass the
// same buffer as input and output (in-place update; the JAX kernel always
// wrote fresh buffers): every thread reads its lane before it writes it.
//
// Per lane: nearest hit over the unified geo table (35 rows x M <= 128
// entries: triangles by Moller-Trumbore in world space, boxes by a slab
// test with DIR_BIAS, ellipsoids by a quadratic, planes; rotated entries in
// their local frame), the winner's attributes read by index, emission and
// background, the MIS mixture sampler (mixture_body of ops/pallas_sampling.py:
// up to max_tries candidates, first accept, mixture pdf of the chosen one),
// the glTF metallic-roughness BRDF * cos / pdf, and the MIRROR / DIELECTRIC
// rules. The plain PyTorch versions in ops/bounce.py compute the same thing.
// The sampler stage and the math under it live in common.cuh, which the
// standalone sampler kernel (sampler.cu, K3) includes too.
//
// Translation from the TPU kernel:
// * The TPU kernel unrolls the scene statically (one specialised code path
//   per primitive). Here the spec is a small int table (kind | rotated << 2
//   | mkind << 3) and every thread walks the same entry at the same time, so
//   the switch on the kind is uniform across a warp.
// * The geo table (~18 KB) and the light table (18 x L <= 32) are staged in
//   shared memory at block start; the winner's attributes are read by index
//   (the TPU needed select chains because its lanes have no random access).
// * The TPU hardware PRNG has no Hopper equivalent: draws come from the
//   counter RNG of ops/rng.py (work_key/uniform_ctr in common.cuh), keyed by
//   (seed, work id) and counter = bounce * draws_per_bounce + d, so kernel and
//   plain version see identical numbers and the image does not depend on the
//   lane count.
// * 256-thread blocks with a masked tail (the TPU's 8192-lane block was a
//   Mosaic PRNG lowering rule).
// * Build without --use_fast_math: a miss is best_t = inf, boxes divide by
//   d + 1e-9, and both need IEEE inf; sign() keeps sign(0) == 0. Build with
//   --fmad=false (ops/kernels.py): rounding op by op, as the plain PyTorch
//   versions do, keeps the two in agreement on >= 99.99 % of lanes.
// * Work the result cannot depend on is skipped: dead lanes and delta
//   (MIRROR/DIELECTRIC) lanes run no mixture sampling, and sampling stops at
//   the first accepted candidate.
//
// What bounds it on an H100: per lane and launch ~104 B of state traffic
// (13 floats in, 13 out) against a few hundred to a few thousand flops (M
// primitives x ~30 flops for the intersect, plus up to 4 sampling tries
// with their light pdf): ~10-40 flop/B, near or above the card's fp32 ridge
// (67 TFLOP/s / 3.35 TB/s ~ 20 flop/B). So it is bound by fp32 issue,
// warp divergence (hit/miss, material and sampling branches) and latency,
// not by HBM. The design keeps one pass per bounce and nothing in device
// memory between kernels but the 13 state lanes.

#include "common.cuh"

namespace {

struct Params {
  const float* in;  // (13, b) state (bounce modes)
  float* out;       // (13, b) state
  long long b;
  const float* px;   // (b,) pixel x (primary)
  const float* py;   // (b,) pixel y (primary)
  const float* cam;  // (128,) camera row (primary)
  int width, height;
  const int* wid;  // (b,) work id base per lane
  uint32_t wid_off, seed, ctr_base;
  const float* geo;  // (C_GEO, m)
  const int* spec;   // (m,)
  int m;
  const float* lp;   // (LC_COUNT, nl)
  const int* lspec;  // (nl,)
  int nl, num_lights;
  float bg0, bg1, bg2;
  int max_tries;
};

// ---- section 1: nearest hit over the geo table -------------------------------
struct Hit {
  float t, u, v;
  int i;
  V3 n_geom;  // normalized, facing the ray
  bool outer, tri;
};

__device__ Hit intersect_all(const Tables& T, V3 ro, V3 rd) {
  float best_t = INFINITY, best_u = 0.0f, best_v = 0.0f;
  int best_i = 0;
  V3 bn = mk(0.0f, 0.0f, 1.0f);
  bool best_outer = true, best_tri = false;
  for (int i = 0; i < T.m; ++i) {
    const int code = T.spec[i];
    const int kind = code & 3;
    const bool rotated = (code >> 2) & 1;
    float t, u = 0.0f, v = 0.0f;
    bool ok, outer;
    V3 cn;
    if (kind == K_TRI) {
      const V3 e1 = T.G3(G_E1, i), e2 = T.G3(G_E2, i), a = T.G3(G_A, i);
      const V3 pv = cross(rd, e2);
      const float det = dot(e1, pv);
      const bool det_ok = fabsf(det) > 1e-30f;
      const float inv_det = 1.0f / (det_ok ? det : 1e-30f);
      const V3 tv = sub(ro, a);
      u = dot(tv, pv) * inv_det;
      const V3 qv = cross(tv, e1);
      v = dot(rd, qv) * inv_det;
      t = dot(e2, qv) * inv_det;
      ok = (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && det_ok && (t > 0.0f);
      const V3 fn = cross(e1, e2);
      const bool front = dot(fn, rd) < 0.0f;
      cn = scl(fn, front ? 1.0f : -1.0f);
      outer = front;
    } else {
      V3 o = sub(ro, T.G3(G_POS, i));
      V3 d = rd;
      const float qx = T.G(G_ROT, i), qy = T.G(G_ROT + 1, i), qz = T.G(G_ROT + 2, i),
                  qw = T.G(G_ROT + 3, i);
      if (rotated) {  // world -> local: rotate by the conjugate
        o = quat_rotate(-qx, -qy, -qz, qw, o);
        d = quat_rotate(-qx, -qy, -qz, qw, rd);
      }
      const float ax = T.G(G_A, i), ay = T.G(G_A + 1, i), az = T.G(G_A + 2, i);
      if (kind == K_BOX) {
        const float ivx = 1.0f / (d.x + DIR_BIAS);
        const float ivy = 1.0f / (d.y + DIR_BIAS);
        const float ivz = 1.0f / (d.z + DIR_BIAS);
        const float lox = (-ax - o.x) * ivx, hix = (ax - o.x) * ivx;
        const float loy = (-ay - o.y) * ivy, hiy = (ay - o.y) * ivy;
        const float loz = (-az - o.z) * ivz, hiz = (az - o.z) * ivz;
        const float t1 = fmaxf(fminf(lox, hix), fmaxf(fminf(loy, hiy), fminf(loz, hiz)));
        const float t2 = fminf(fmaxf(lox, hix), fminf(fmaxf(loy, hiy), fmaxf(loz, hiz)));
        const bool valid = t1 <= t2;
        outer = valid && (t1 > 0.0f);
        t = outer ? t1 : t2;
        ok = valid && (t > 0.0f);
        const float hx = o.x + d.x * t, hy = o.y + d.y * t, hz = o.z + d.z * t;
        const bool on_x = (ax - fabsf(hx)) < EPS;
        const bool on_y = (ay - fabsf(hy)) < EPS;
        const float flip = outer ? 1.0f : -1.0f;
        cn = mk((on_x ? sgnf(hx) : 0.0f) * flip, ((!on_x && on_y) ? sgnf(hy) : 0.0f) * flip,
                ((!on_x && !on_y) ? sgnf(hz) : 0.0f) * flip);
      } else if (kind == K_ELL) {
        const float iox = o.x / ax, ioy = o.y / ay, ioz = o.z / az;
        const float idx = d.x / ax, idy = d.y / ay, idz = d.z / az;
        const float a_q = idx * idx + idy * idy + idz * idz;
        const float b_q = iox * idx + ioy * idy + ioz * idz;
        const float c_q = iox * iox + ioy * ioy + ioz * ioz - 1.0f;
        const float disc = b_q * b_q - a_q * c_q;
        const bool valid = disc >= 0.0f;
        const float sq = sqrtf(fmaxf(disc, 0.0f));
        const float inv_a = 1.0f / fmaxf(a_q, 1e-30f);
        const float t1 = (-b_q - sq) * inv_a;
        const float t2 = (-b_q + sq) * inv_a;
        outer = valid && (t1 > 0.0f);
        t = outer ? t1 : t2;
        ok = valid && (t > 0.0f);
        const float hx = o.x + d.x * t, hy = o.y + d.y * t, hz = o.z + d.z * t;
        const float flip = outer ? 1.0f : -1.0f;
        cn = mk(hx / (ax * ax) * flip, hy / (ay * ay) * flip, hz / (az * az) * flip);
      } else {  // infinite plane through the local origin, normal (ax, ay, az)
        const float denom = ax * d.x + ay * d.y + az * d.z;
        const float num = ax * o.x + ay * o.y + az * o.z;
        const bool den_ok = fabsf(denom) > 1e-30f;
        t = -num / (den_ok ? denom : 1e-30f);
        ok = den_ok && (t > 0.0f);
        outer = denom < 0.0f;
        const float flip = outer ? 1.0f : -1.0f;
        cn = mk(ax * flip, ay * flip, az * flip);
      }
      if (rotated) cn = quat_rotate(qx, qy, qz, qw, cn);
    }
    if (ok && (t < best_t)) {
      best_t = t;
      best_i = i;
      best_u = u;
      best_v = v;
      bn = cn;
      best_outer = outer;
      best_tri = kind == K_TRI;
    }
  }
  Hit h;
  h.t = best_t;
  h.u = best_u;
  h.v = best_v;
  h.i = best_i;
  h.n_geom = normalize(bn, 1e-30f);
  h.outer = best_outer;
  h.tri = best_tri;
  return h;
}

// ---- section 5: BRDF (ops/brdf.py) -----------------------------------------
__device__ __forceinline__ float smith_g1(float ndx, float alpha) {
  const float c2 = fminf(fmaxf(ndx * ndx, BRDF_SAFE), 1.0f);
  const float tan2 = (1.0f - c2) / c2;
  const float g1 = 2.0f / (1.0f + sqrtf(1.0f + alpha * alpha * tan2));
  return ndx > 0.0f ? g1 : 0.0f;
}

__device__ V3 eval_brdf(V3 l, V3 n, V3 v, V3 color, float metallic, float roughness, int mkind) {
  const V3 diffuse = mk(color.x / PI_F, color.y / PI_F, color.z / PI_F);
  if (mkind == M_DIFFUSE) return diffuse;
  const V3 h = normalize(add(l, v), 1e-30f);
  const float alpha = roughness * roughness;
  const float ldn = dot(l, n), vdn = dot(v, n), hdn = dot(h, n);
  const float a2 = alpha * alpha;
  const float dq = (a2 - 1.0f) * hdn * hdn + 1.0f;
  const float d = a2 * (hdn > 0.0f ? 1.0f : 0.0f) / fmaxf(PI_F * (dq * dq), BRDF_SAFE);
  const float g = smith_g1(ldn, alpha) * smith_g1(vdn, alpha);
  const float sden = 4.0f * ldn * vdn;
  const float spec = d * g / (fabsf(sden) > BRDF_SAFE ? sden : BRDF_SAFE);
  const float w = powf(fminf(fmaxf(1.0f - fabsf(dot(h, l)), 0.0f), 1.0f), 5.0f);
  const V3 metal = mk(spec * (color.x + (1.0f - color.x) * w), spec * (color.y + (1.0f - color.y) * w),
                      spec * (color.z + (1.0f - color.z) * w));
  const float f_diel = 0.04f + (1.0f - 0.04f) * w;
  const V3 diel = add(scl(mk(spec, spec, spec), f_diel), scl(diffuse, 1.0f - f_diel));
  return add(scl(diel, 1.0f - metallic), scl(metal, metallic));
}

// ---- the bounce body ----------------------------------------------------------
struct Lane {
  V3 ro, rd, thr, rad;
  bool alive;
};

template <bool FINAL_ONLY>
__device__ Lane bounce_body(const Tables& T, const Params& p, uint32_t key, Lane s) {
  if (!s.alive) {  // dead lanes stay dead; a full bounce zeroes throughput
    if (!FINAL_ONLY) s.thr = scl(s.thr, 0.0f);
    return s;
  }
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
    const float u_diel = uniform_ctr(key, p.ctr_base + 2u + 7u * (uint32_t)p.max_tries);
    const float cos_i = fminf(fmaxf(dot(v_dir, n), 0.0f), 1.0f);
    const float eta = h.outer ? 1.0f / ior : ior;
    const float sin2_t = eta * eta * fmaxf(0.0f, 1.0f - cos_i * cos_i);
    const bool tir = sin2_t > 1.0f;
    const float cos_t = sqrtf(fmaxf(0.0f, 1.0f - sin2_t));
    const float rr = (eta - 1.0f) / (eta + 1.0f);
    const float r0 = rr * rr;
    const float refl_p = r0 + (1.0f - r0) * powf(1.0f - cos_i, 5.0f);
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
    mixture(T, key, p.ctr_base, p.max_tries, point, n, n_shade, v_dir, roughness, l, pdf, ok);
    const V3 f = eval_brdf(l, n, v_dir, color, metallic, roughness, mkind);
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

__device__ __forceinline__ void stage_tables(const Params& p, bool lights, float* geo_s,
                                             int* spec_s, float* lp_s, int* lspec_s) {
  for (int k = threadIdx.x; k < C_GEO * p.m; k += blockDim.x) geo_s[k] = p.geo[k];
  for (int k = threadIdx.x; k < p.m; k += blockDim.x) spec_s[k] = p.spec[k];
  if (lights) {
    for (int k = threadIdx.x; k < LC_COUNT * p.nl; k += blockDim.x) lp_s[k] = p.lp[k];
    for (int k = threadIdx.x; k < p.nl; k += blockDim.x) lspec_s[k] = p.lspec[k];
  }
  __syncthreads();
}

__device__ __forceinline__ void store(const Params& p, long long i, const Lane& o) {
  const long long b = p.b;
  float* out = p.out;
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

template <bool FINAL_ONLY>
__global__ void __launch_bounds__(kThreads) bounce_kernel(Params p) {
  __shared__ float geo_s[C_GEO * MAX_PRIMS];
  __shared__ int spec_s[MAX_PRIMS];
  __shared__ float lp_s[LC_COUNT * MAX_LIGHTS];
  __shared__ int lspec_s[MAX_LIGHTS];
  stage_tables(p, !FINAL_ONLY, geo_s, spec_s, lp_s, lspec_s);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.b) return;
  const Tables T{geo_s, spec_s, p.m, lp_s, lspec_s, p.nl, p.num_lights};
  const long long b = p.b;
  const float* in = p.in;
  Lane s;
  s.ro = mk(in[0 * b + i], in[1 * b + i], in[2 * b + i]);
  s.rd = mk(in[3 * b + i], in[4 * b + i], in[5 * b + i]);
  s.thr = mk(in[6 * b + i], in[7 * b + i], in[8 * b + i]);
  s.rad = mk(in[9 * b + i], in[10 * b + i], in[11 * b + i]);
  s.alive = in[12 * b + i] > 0.5f;
  const uint32_t key = work_key(p.seed, (uint32_t)p.wid[i] + p.wid_off);
  store(p, i, bounce_body<FINAL_ONLY>(T, p, key, s));
}

__global__ void __launch_bounds__(kThreads) primary_kernel(Params p) {
  __shared__ float geo_s[C_GEO * MAX_PRIMS];
  __shared__ int spec_s[MAX_PRIMS];
  __shared__ float lp_s[LC_COUNT * MAX_LIGHTS];
  __shared__ int lspec_s[MAX_LIGHTS];
  stage_tables(p, true, geo_s, spec_s, lp_s, lspec_s);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.b) return;
  const Tables T{geo_s, spec_s, p.m, lp_s, lspec_s, p.nl, p.num_lights};
  const uint32_t key = work_key(p.seed, (uint32_t)p.wid[i] + p.wid_off);
  // camera prologue: same math as ops/camera.py generate_rays_u
  const float* cam = p.cam;
  const float u0 = uniform_ctr(key, p.ctr_base + 0u);
  const float u1 = uniform_ctr(key, p.ctr_base + 1u);
  const float sx = (2.0f * (p.px[i] + u0) / (float)p.width - 1.0f) * cam[CAM_TANX];
  const float sy = -(2.0f * (p.py[i] + u1) / (float)p.height - 1.0f) * cam[CAM_TANY];
  V3 d;
  d.x = sx * cam[CAM_RIGHT + 0] + sy * cam[CAM_UP + 0] + cam[CAM_FWD + 0];
  d.y = sx * cam[CAM_RIGHT + 1] + sy * cam[CAM_UP + 1] + cam[CAM_FWD + 1];
  d.z = sx * cam[CAM_RIGHT + 2] + sy * cam[CAM_UP + 2] + cam[CAM_FWD + 2];
  Lane s;
  s.ro = mk(cam[CAM_POS], cam[CAM_POS + 1], cam[CAM_POS + 2]);
  s.rd = normalize(d, 1e-30f);
  s.thr = mk(1.0f, 1.0f, 1.0f);
  s.rad = mk(0.0f, 0.0f, 0.0f);
  s.alive = true;
  store(p, i, bounce_body<false>(T, p, key, s));
}

Params make_params(long long b, const void* wid, unsigned wid_off, unsigned seed,
                   unsigned ctr_base, const void* geo, const void* spec, int m, const void* lp,
                   const void* lspec, int nl, int num_lights, float bg0, float bg1, float bg2,
                   int max_tries) {
  Params p{};
  p.b = b;
  p.wid = static_cast<const int*>(wid);
  p.wid_off = wid_off;
  p.seed = seed;
  p.ctr_base = ctr_base;
  p.geo = static_cast<const float*>(geo);
  p.spec = static_cast<const int*>(spec);
  p.m = m;
  p.lp = static_cast<const float*>(lp);
  p.lspec = static_cast<const int*>(lspec);
  p.nl = nl;
  p.num_lights = num_lights;
  p.bg0 = bg0;
  p.bg1 = bg1;
  p.bg2 = bg2;
  p.max_tries = max_tries;
  return p;
}

int bad_args(long long b, int m, int nl, int num_lights) {
  return b < 0 || m < 1 || m > MAX_PRIMS || nl < 1 || nl > MAX_LIGHTS || num_lights < 0 ||
         num_lights > nl;
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take). Never synchronises.
extern "C" int rt_launch_bounce(const void* in, void* out, long long b, const void* wid,
                                unsigned wid_off, unsigned seed, unsigned ctr_base,
                                const void* geo, const void* spec, int m, const void* lp,
                                const void* lspec, int nl, int num_lights, float bg0,
                                float bg1, float bg2, int max_tries, int final_only,
                                void* stream) {
  if (bad_args(b, m, nl, num_lights)) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  Params p = make_params(b, wid, wid_off, seed, ctr_base, geo, spec, m, lp, lspec, nl,
                         num_lights, bg0, bg1, bg2, max_tries);
  p.in = static_cast<const float*>(in);
  p.out = static_cast<float*>(out);
  const unsigned grid = (unsigned)((b + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (final_only)
    bounce_kernel<true><<<grid, kThreads, 0, st>>>(p);
  else
    bounce_kernel<false><<<grid, kThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int rt_launch_primary(const void* px, const void* py, const void* cam, int width,
                                 int height, void* out, long long b, const void* wid,
                                 unsigned wid_off, unsigned seed, unsigned ctr_base,
                                 const void* geo, const void* spec, int m, const void* lp,
                                 const void* lspec, int nl, int num_lights, float bg0,
                                 float bg1, float bg2, int max_tries, void* stream) {
  if (bad_args(b, m, nl, num_lights) || width < 1 || height < 1)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  Params p = make_params(b, wid, wid_off, seed, ctr_base, geo, spec, m, lp, lspec, nl,
                         num_lights, bg0, bg1, bg2, max_tries);
  p.px = static_cast<const float*>(px);
  p.py = static_cast<const float*>(py);
  p.cam = static_cast<const float*>(cam);
  p.width = width;
  p.height = height;
  p.out = static_cast<float*>(out);
  const unsigned grid = (unsigned)((b + kThreads - 1) / kThreads);
  primary_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
