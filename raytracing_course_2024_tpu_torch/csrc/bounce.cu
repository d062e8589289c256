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
//   counter RNG of ops/rng.py (work_key/uniform_ctr below), keyed by
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

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int C_GEO = 35;
constexpr int MAX_PRIMS = 128;
constexpr int MAX_LIGHTS = 32;
constexpr int LC_COUNT = 18;

// geo table rows (ops/bounce.py)
constexpr int G_A = 0, G_E1 = 3, G_E2 = 6, G_POS = 9, G_ROT = 12;
constexpr int G_SN0 = 16, G_SN1 = 19, G_SN2 = 22, G_COLOR = 25;
constexpr int G_METAL = 28, G_ROUGH = 29, G_EMIT = 30, G_IOR = 33;
constexpr int G_MKIND = 34;
// light pack rows (scene/types.py LightCol)
constexpr int L_PTYPE = 0, L_P0 = 1, L_P1 = 4, L_P2 = 7, L_POS = 10;
constexpr int L_ROT = 13, L_INV_AREA = 17;
// camera row (ops/camera.py)
constexpr int CAM_POS = 0, CAM_RIGHT = 3, CAM_UP = 6, CAM_FWD = 9;
constexpr int CAM_TANX = 12, CAM_TANY = 13;

constexpr int K_TRI = 0, K_BOX = 1, K_ELL = 2;  // kind 3 = plane
constexpr int M_DIFFUSE = 0, M_MIRROR = 1, M_DIELECTRIC = 2;

constexpr float EPS = 1e-4f;
constexpr float DIR_BIAS = 1e-9f;
constexpr float EPS_BACKOFF = 1e-4f;
constexpr float SAFE = 1e-9f;        // ops/sampling.py _SAFE
constexpr float BRDF_SAFE = 1e-12f;  // ops/brdf.py _SAFE
constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.28318530717958647692f;
// the reference's tangent-frame seed vector (0.234, 0.1234, 0.97686),
// normalized in float64 as ops/sampling.py does
constexpr double T_NORM = 1.012046945353821;
constexpr float T_SEED_X = (float)(0.234 / T_NORM);
constexpr float T_SEED_Y = (float)(0.1234 / T_NORM);
constexpr float T_SEED_Z = (float)(0.97686 / T_NORM);

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 mk(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 scl(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 normalize(V3 v, float eps) {
  return scl(v, rsqrtf(fmaxf(dot(v, v), eps)));
}
__device__ __forceinline__ float sgnf(float x) { return (float)((x > 0.0f) - (x < 0.0f)); }
// reflect outgoing v about n: -v + 2 (v.n) n
__device__ __forceinline__ V3 reflect(V3 v, V3 n) { return sub(scl(n, 2.0f * dot(v, n)), v); }

// v + 2w (q x v) + 2 q x (q x v), quaternion (x, y, z, w)
__device__ __forceinline__ V3 quat_rotate(float qx, float qy, float qz, float qw, V3 v) {
  float tx = 2.0f * (qy * v.z - qz * v.y);
  float ty = 2.0f * (qz * v.x - qx * v.z);
  float tz = 2.0f * (qx * v.y - qy * v.x);
  return {v.x + qw * tx + (qy * tz - qz * ty), v.y + qw * ty + (qz * tx - qx * tz),
          v.z + qw * tz + (qx * ty - qy * tx)};
}

// ---- counter RNG, bit-exact with ops/rng.py ---------------------------------
__device__ __forceinline__ uint32_t fmix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}
__device__ __forceinline__ uint32_t work_key(uint32_t seed, uint32_t wid) {
  return fmix((wid * 0x9E3779B9u) ^ seed);
}
__device__ __forceinline__ float uniform_ctr(uint32_t key, uint32_t ctr) {
  uint32_t bits = fmix(key ^ (ctr * 0x85EBCA77u + 0x165667B1u));
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

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

struct Tables {
  const float* geo;
  const int* spec;
  int m;
  const float* lp;
  const int* lspec;
  int nl, num_lights;
  __device__ __forceinline__ float G(int row, int i) const { return geo[row * m + i]; }
  __device__ __forceinline__ V3 G3(int row, int i) const {
    return mk(G(row, i), G(row + 1, i), G(row + 2, i));
  }
  __device__ __forceinline__ float L(int row, int j) const { return lp[row * nl + j]; }
  __device__ __forceinline__ V3 L3(int row, int j) const {
    return mk(L(row, j), L(row + 1, j), L(row + 2, j));
  }
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

// ---- section 4: mixture sampling (ops/sampling.py, ops/mixture.py) -----------
__device__ __forceinline__ V3 unit_sphere(float u1, float u2) {
  const float z = 1.0f - 2.0f * u1;
  const float r = sqrtf(fmaxf(0.0f, 1.0f - z * z));
  const float phi = TWO_PI_F * u2;
  return mk(r * cosf(phi), r * sinf(phi), z);
}

__device__ __forceinline__ void tangent_frame(V3 n, V3& t1, V3& t2) {
  t1 = normalize(cross(n, mk(T_SEED_X, T_SEED_Y, T_SEED_Z)), 1e-30f);
  t2 = normalize(cross(n, t1), 1e-30f);
}

__device__ __forceinline__ V3 frame_local(V3 t1, V3 t2, V3 n, V3 v) {
  return mk(dot(v, t1), dot(v, t2), dot(v, n));
}

__device__ V3 sample_cosine(float u1, float u2, V3 n) {
  return normalize(add(unit_sphere(u1, u2), n), 1e-12f);
}

__device__ V3 sample_vndf(float u0, float u1, V3 n, V3 v, float roughness) {
  const float alpha = roughness * roughness;
  V3 t1, t2;
  tangent_frame(n, t1, t2);
  const V3 vl = frame_local(t1, t2, n, v);
  const V3 vh = normalize(mk(alpha * vl.x, alpha * vl.y, vl.z), 1e-20f);
  const float lensq = vh.x * vh.x + vh.y * vh.y;
  const float inv_len = rsqrtf(fmaxf(lensq, 1e-20f));
  const V3 a1 = lensq > 1e-20f ? mk(-vh.y * inv_len, vh.x * inv_len, 0.0f) : mk(1.0f, 0.0f, 0.0f);
  const V3 a2 = cross(vh, a1);
  const float r = sqrtf(u0);
  const float phi = TWO_PI_F * u1;
  const float p1 = r * cosf(phi);
  float p2 = r * sinf(phi);
  const float s = 0.5f * (1.0f + vh.z);
  p2 = (1.0f - s) * sqrtf(fmaxf(0.0f, 1.0f - p1 * p1)) + s * p2;
  const V3 nh = add(add(scl(a1, p1), scl(a2, p2)), scl(vh, sqrtf(fmaxf(0.0f, 1.0f - p1 * p1 - p2 * p2))));
  const V3 ne = normalize(mk(alpha * nh.x, alpha * nh.y, fmaxf(0.0f, nh.z)), 1e-20f);
  const V3 ne_w = add(add(scl(t1, ne.x), scl(t2, ne.y)), scl(n, ne.z));
  return reflect(v, ne_w);
}

__device__ __forceinline__ float pdf_cosine(V3 n, V3 l) { return fmaxf(0.0f, dot(l, n)) / PI_F; }

__device__ __forceinline__ float nonzero(float x, float floor) { return fabsf(x) > floor ? x : floor; }

__device__ float pdf_vndf(V3 n, V3 l, V3 v, float roughness) {
  const float alpha = roughness * roughness;
  V3 t1, t2;
  tangent_frame(n, t1, t2);
  const V3 vl = frame_local(t1, t2, n, v);
  const V3 ll = frame_local(t1, t2, n, l);
  const V3 h = normalize(add(vl, ll), 1e-20f);
  // Smith G1 of vl
  const float z2 = fmaxf(vl.z * vl.z, 1e-20f);
  const float under = 1.0f + alpha * alpha * (vl.x * vl.x + vl.y * vl.y) / z2;
  const float g1 = 1.0f / (1.0f + 0.5f * (sqrtf(under) - 1.0f));
  // GGX D of h
  const float a2 = alpha * alpha;
  const float q = (h.x * h.x + h.y * h.y) / fmaxf(a2, 1e-20f) + h.z * h.z;
  const float dd = 1.0f / fmaxf(PI_F * a2 * q * q, 1e-20f);
  const float vdh = dot(vl, h);
  const float dv = g1 * fmaxf(0.0f, vdh) * dd / nonzero(vl.z, SAFE);
  const float denom = 4.0f * vdh;
  const float pdf = dv / nonzero(denom, SAFE);
  return (vl.z > 0.0f && denom > 0.0f && h.z > 0.0f) ? pdf : 0.0f;
}

__device__ V3 sample_light_dir(const Tables& T, const float us[6], V3 point) {
  const int li = min((int)(us[5] * (float)T.num_lights), T.num_lights - 1);
  const float ptype = T.L(L_PTYPE, li);
  const V3 s = T.L3(L_P0, li);
  V3 local;
  if (ptype == (float)K_BOX) {
    const float wx = 4.0f * s.y * s.z;
    const float wy = 4.0f * s.x * s.z;
    const float wz = 4.0f * s.x * s.y;
    const float w = wx + wy + wz;
    const float x = us[0] * w;
    const float sign = us[1] < 0.5f ? 1.0f : -1.0f;
    const float cu = us[2] * 2.0f - 1.0f;
    const float cv = us[3] * 2.0f - 1.0f;
    const bool on_x = x < wx;
    const bool on_y = !on_x && (x < wx + wy);
    local = on_x ? mk(s.x * sign, cu * s.y, cv * s.z)
                 : (on_y ? mk(cu * s.x, s.y * sign, cv * s.z) : mk(cu * s.x, cv * s.y, s.z * sign));
  } else if (ptype == (float)K_ELL) {
    const V3 sph = unit_sphere(us[2], us[4]);
    local = mk(sph.x * s.x, sph.y * s.y, sph.z * s.z);
  } else {  // triangle with uv folding
    float tu = us[0], tv = us[1];
    if (tu + tv >= 1.0f) {
      tu = 1.0f - tu;
      tv = 1.0f - tv;
    }
    const V3 p1 = T.L3(L_P1, li), p2 = T.L3(L_P2, li);
    local = add(add(s, scl(sub(p1, s), tu)), scl(sub(p2, s), tv));
  }
  const V3 world = add(quat_rotate(T.L(L_ROT, li), T.L(L_ROT + 1, li), T.L(L_ROT + 2, li),
                                   T.L(L_ROT + 3, li), local),
                       T.L3(L_POS, li));
  return normalize(sub(world, point), 1e-20f);
}

__device__ __forceinline__ float contrib(float t, float n_dot_l, float local_pdf, bool valid) {
  const float denom = fmaxf(fabsf(n_dot_l), SAFE);
  return (valid && t > 0.0f) ? local_pdf * t * t / denom : 0.0f;
}

__device__ float pdf_lights(const Tables& T, V3 point, V3 l) {
  float total = 0.0f;
  for (int j = 0; j < T.num_lights; ++j) {
    const int code = T.lspec[j];
    const int type = code & 3;
    const bool rotated = (code >> 2) & 1;
    const float inv_area = T.L(L_INV_AREA, j);
    if (type == K_TRI) {
      const V3 p0 = T.L3(L_P0, j), p1 = T.L3(L_P1, j), p2 = T.L3(L_P2, j);
      const V3 e1 = sub(p1, p0), e2 = sub(p2, p0);
      const V3 pv = cross(l, e2);
      const float det = dot(e1, pv);
      const bool det_ok = fabsf(det) > 1e-30f;
      const float inv_det = 1.0f / (det_ok ? det : 1e-30f);
      const V3 tv = sub(point, p0);
      const float u = dot(tv, pv) * inv_det;
      const V3 qv = cross(tv, e1);
      const float v = dot(l, qv) * inv_det;
      const float t = dot(e2, qv) * inv_det;
      const bool valid = (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && det_ok;
      const V3 tri_n = normalize(cross(e1, e2), 1e-20f);
      total += contrib(t, dot(tri_n, l), inv_area, valid);
      continue;
    }
    const float qx = T.L(L_ROT, j), qy = T.L(L_ROT + 1, j), qz = T.L(L_ROT + 2, j),
                qw = T.L(L_ROT + 3, j);
    V3 o = sub(point, T.L3(L_POS, j));
    V3 d = l;
    if (rotated) {
      o = quat_rotate(-qx, -qy, -qz, qw, o);
      d = quat_rotate(-qx, -qy, -qz, qw, l);
    }
    const V3 s = T.L3(L_P0, j);
    if (type == K_BOX) {
      const float ix = 1.0f / (d.x + DIR_BIAS), iy = 1.0f / (d.y + DIR_BIAS),
                  iz = 1.0f / (d.z + DIR_BIAS);
      const float ax = (-s.x - o.x) * ix, bx = (s.x - o.x) * ix;
      const float ay = (-s.y - o.y) * iy, by = (s.y - o.y) * iy;
      const float az = (-s.z - o.z) * iz, bz = (s.z - o.z) * iz;
      const float t1 = fmaxf(fminf(ax, bx), fmaxf(fminf(ay, by), fminf(az, bz)));
      const float t2 = fminf(fmaxf(ax, bx), fminf(fmaxf(ay, by), fmaxf(az, bz)));
      const bool valid = t1 <= t2;
      const float roots[2] = {t1, t2};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float tr = roots[r];
        const V3 p = add(o, scl(d, tr));
        const bool on_x = (s.x - fabsf(p.x)) < EPS;
        const bool on_y = (s.y - fabsf(p.y)) < EPS;
        V3 nl = on_x ? mk(sgnf(p.x), 0.0f, 0.0f)
                     : (on_y ? mk(0.0f, sgnf(p.y), 0.0f) : mk(0.0f, 0.0f, sgnf(p.z)));
        if (rotated) nl = quat_rotate(qx, qy, qz, qw, nl);
        total += contrib(tr, dot(nl, l), inv_area, valid);
      }
    } else {  // ellipsoid: pullback pdf 1 / (4 pi |J|)
      const V3 oo = mk(o.x / s.x, o.y / s.y, o.z / s.z);
      const V3 dd = mk(d.x / s.x, d.y / s.y, d.z / s.z);
      const float a = dot(dd, dd);
      const float b = dot(oo, dd);
      const float c = dot(oo, oo) - 1.0f;
      const float disc = b * b - a * c;
      const bool valid = disc >= 0.0f;
      const float sq = sqrtf(fmaxf(disc, 0.0f));
      const float inv_a = 1.0f / fmaxf(a, 1e-30f);
      const float roots[2] = {(-b - sq) * inv_a, (-b + sq) * inv_a};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float tr = roots[r];
        const V3 p = add(o, scl(d, tr));
        V3 nl = normalize(mk(p.x / (s.x * s.x), p.y / (s.y * s.y), p.z / (s.z * s.z)), 1e-30f);
        if (rotated) nl = quat_rotate(qx, qy, qz, qw, nl);
        const V3 us = mk(p.x / s.x, p.y / s.y, p.z / s.z);
        const float jx = us.x * s.y * s.z, jy = s.x * us.y * s.z, jz = s.x * s.y * us.z;
        const float jac = sqrtf(fmaxf(jx * jx + jy * jy + jz * jz, 1e-20f));
        total += contrib(tr, dot(nl, l), inv_area / jac, valid);
      }
    }
  }
  return total / (float)max(T.num_lights, 1);
}

// K candidates, first accept, mixture pdf of the chosen one (mixture_body)
__device__ void mixture(const Tables& T, uint32_t key, uint32_t ctr, int max_tries, V3 point,
                        V3 n, V3 ns, V3 v, float roughness, V3& l, float& pdf, bool& accepted) {
  const int n_comp = T.num_lights > 0 ? 3 : 2;
  V3 pick = mk(0.0f, 0.0f, 1.0f);
  accepted = false;
  for (int t = 0; t < max_tries && !accepted; ++t) {
    const uint32_t c0 = ctr + 2u + 7u * (uint32_t)t;
    const int which = min((int)(uniform_ctr(key, c0) * (float)n_comp), n_comp - 1);
    const float u1 = uniform_ctr(key, c0 + 1u), u2 = uniform_ctr(key, c0 + 2u);
    V3 cand;
    if (which == 0) {
      cand = sample_cosine(u1, u2, n);
    } else if (which == 1) {
      cand = sample_vndf(u1, u2, n, v, roughness);
    } else {
      const float us[6] = {u1, u2, uniform_ctr(key, c0 + 3u), uniform_ctr(key, c0 + 4u),
                           uniform_ctr(key, c0 + 5u), uniform_ctr(key, c0 + 6u)};
      cand = sample_light_dir(T, us, point);
    }
    if (dot(cand, ns) > 0.0f && dot(cand, n) > 0.0f) {
      pick = cand;
      accepted = true;
    }
  }
  float p = pdf_cosine(n, pick) + pdf_vndf(n, pick, v, roughness);
  if (T.num_lights > 0) p = p + pdf_lights(T, point, pick);
  p = p / (float)n_comp;
  accepted = accepted && (p > SAFE);
  pdf = fmaxf(p, SAFE);
  l = pick;
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
