// Device code shared by the fused bounce (bounce.cu, K1/K2), the persistent
// round (persistent.cu, K5), the standalone mixture sampler (sampler.cu, K3),
// the dense nearest hit (dense_nearest.cu, K4), the BVH nearest hit
// (bvh_traverse.cu, K6), the modular bounce's shade and finish (shade.cu,
// N1a/N1b) and the lane engines' refill and restart (refill.cu, N2a/N2b):
// table layouts, 3-vector and quaternion math, the counter RNG and
// its draw layouts, the camera ray, the three direction samplers, their pdfs and the MIS
// mixture stage, the BRDF, and the ray test of one primitive record. K1, K5
// and K3 therefore run the same sampler code, K1, K5 and K6 the same shape
// tests, and all match the plain PyTorch versions in ops/sampling.py,
// ops/mixture.py and ops/intersect.py. Everything sits in an anonymous namespace: each
// translation unit that includes this header gets its own copy.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

// Where one bounce's draws sit (ops/rng.py Ctr): row r of mixture candidate t
// at base + t * cand + r * row, the dielectric split at base + diel. The batch
// paths use (bounce * draws_per_bounce + 2, 7, 1, 7 T); the lane engines
// (base0 + stride * depth, 1, T, 63) with base0 = 2, stride = 64.
struct Ctr {
  uint32_t base, cand, row, diel;
};
__device__ __forceinline__ Ctr at_depth(Ctr c, uint32_t stride, uint32_t depth) {
  c.base += stride * depth;
  return c;
}
constexpr uint32_t CTR_JITTER = 0;  // draws 0 and 1 of every path: camera jitter

// Jittered pinhole ray through pixel (px, py): ops/camera.py generate_rays_u,
// op for op (K2, K5 and the lane engines' refill and restart, N2a/N2b).
__device__ __forceinline__ void camera_ray(const float* cam, float px, float py, int width,
                                           int height, float u0, float u1, V3& ro, V3& rd) {
  const float sx = (2.0f * (px + u0) / (float)width - 1.0f) * cam[CAM_TANX];
  const float sy = -(2.0f * (py + u1) / (float)height - 1.0f) * cam[CAM_TANY];
  V3 d;
  d.x = sx * cam[CAM_RIGHT + 0] + sy * cam[CAM_UP + 0] + cam[CAM_FWD + 0];
  d.y = sx * cam[CAM_RIGHT + 1] + sy * cam[CAM_UP + 1] + cam[CAM_FWD + 1];
  d.z = sx * cam[CAM_RIGHT + 2] + sy * cam[CAM_UP + 2] + cam[CAM_FWD + 2];
  ro = mk(cam[CAM_POS], cam[CAM_POS + 1], cam[CAM_POS + 2]);
  rd = normalize(d, 1e-30f);
}

// What the device functions read of the scene. `rec` (the intersection
// loop's records, bounce_body.cuh) and the light tables `lp`/`lspec` sit in
// shared memory; `geo` is the (C_GEO, m) table in device memory, read through
// G/G3 for the winning entry only (18 KB at most: it stays in L2). K3 sets
// only the light tables. The light functions below read a table through
// L/L3 (light j's LightCol row) and spec (its ptype | rotated << 2), so K3's
// tables above 32 lights (light_tree.cuh) run the same code.
struct Tables {
  const float* geo;
  const float4* rec;
  int m;
  const float* lp;
  const int* lspec;
  int nl, num_lights;
  __device__ __forceinline__ float G(int row, int i) const { return __ldg(geo + row * m + i); }
  __device__ __forceinline__ V3 G3(int row, int i) const {
    return mk(G(row, i), G(row + 1, i), G(row + 2, i));
  }
  __device__ __forceinline__ float L(int row, int j) const { return lp[row * nl + j]; }
  __device__ __forceinline__ V3 L3(int row, int j) const {
    return mk(L(row, j), L(row + 1, j), L(row + 2, j));
  }
  __device__ __forceinline__ int spec(int j) const { return lspec[j]; }
};

// ---- section 4: mixture sampling (ops/sampling.py, ops/mixture.py) -----------
// Both of one angle in one call: a sampler needs sine and cosine together.
__device__ __forceinline__ void sin_cos(float phi, float& s, float& c) { sincosf(phi, &s, &c); }

// x^5 of Schlick's Fresnel term by three multiplications (powf(x, 5) is a
// generic exp2/log2 sequence many times as long; on the MIXED scene the
// kernels stayed bit for bit equal to the plain versions' torch.pow(x, 5.0)).
__device__ __forceinline__ float pow5(float x) {
  const float x2 = x * x;
  return x2 * x2 * x;
}

// x^5 as torch.pow(x, 5.0) computes it on the card: ATen's pow with a
// scalar exponent other than 2, 3 or a root is powf. N1's kernels
// (shade.cu) mirror the plain modular bounce with it.
__device__ __forceinline__ float pow5_torch(float x) { return powf(x, 5.0f); }

// ---- the BRDF (ops/brdf.py) ---------------------------------------------------
__device__ __forceinline__ float smith_g1(float ndx, float alpha) {
  const float c2 = fminf(fmaxf(ndx * ndx, BRDF_SAFE), 1.0f);
  const float tan2 = (1.0f - c2) / c2;
  const float g1 = 2.0f / (1.0f + sqrtf(1.0f + alpha * alpha * tan2));
  return ndx > 0.0f ? g1 : 0.0f;
}

// TORCH_POW: Schlick's x^5 by pow5_torch (N1b, shade.cu) or by pow5 (the
// fused bounce's K1/K2/K5, bounce_body.cuh); the rest is one code for both.
template <bool TORCH_POW>
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
  const float x = fminf(fmaxf(1.0f - fabsf(dot(h, l)), 0.0f), 1.0f);
  const float w = TORCH_POW ? pow5_torch(x) : pow5(x);
  const V3 metal = mk(spec * (color.x + (1.0f - color.x) * w), spec * (color.y + (1.0f - color.y) * w),
                      spec * (color.z + (1.0f - color.z) * w));
  const float f_diel = 0.04f + (1.0f - 0.04f) * w;
  const V3 diel = add(scl(mk(spec, spec, spec), f_diel), scl(diffuse, 1.0f - f_diel));
  return add(scl(diel, 1.0f - metallic), scl(metal, metallic));
}

__device__ __forceinline__ V3 unit_sphere(float u1, float u2) {
  const float z = 1.0f - 2.0f * u1;
  const float r = sqrtf(fmaxf(0.0f, 1.0f - z * z));
  float sp, cp;
  sin_cos(TWO_PI_F * u2, sp, cp);
  return mk(r * cp, r * sp, z);
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
  float sp, cp;
  sin_cos(TWO_PI_F * u1, sp, cp);
  const float p1 = r * cp;
  float p2 = r * sp;
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

template <class LT>
__device__ V3 sample_light_dir(const LT& T, const float us[6], V3 point) {
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

// Light j's terms of the light pdf along (point, l), added to `total` in
// order: a triangle's one hit, a box's or an ellipsoid's two roots.
template <class LT>
__device__ __forceinline__ void add_light_pdf(const LT& T, int j, V3 point, V3 l, float& total) {
  const int code = T.spec(j);
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
    return;
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

// The light pdf over every light of the table, in table order.
__device__ float pdf_lights(const Tables& T, V3 point, V3 l) {
  float total = 0.0f;
  for (int j = 0; j < T.num_lights; ++j) add_light_pdf(T, j, point, l, total);
  return total / (float)max(T.num_lights, 1);
}

// The mixture's components: cosine, GGX-VNDF and, with lights, the lights.
template <class LS>
__device__ __forceinline__ int mixture_components(const LS& T) {
  return T.num_lights > 0 ? 3 : 2;
}

// K candidates, first accept (mixture_body's candidate loop): the picked
// direction, (0, 0, 1) where no candidate is accepted.
template <class LS>
__device__ __forceinline__ void mixture_pick(const LS& T, uint32_t key, const Ctr& ctr,
                                             int max_tries, int n_comp, V3 point, V3 n, V3 ns,
                                             V3 v, float roughness, V3& pick, bool& accepted) {
  pick = mk(0.0f, 0.0f, 1.0f);
  accepted = false;
  for (int t = 0; t < max_tries && !accepted; ++t) {
    const uint32_t c0 = ctr.base + ctr.cand * (uint32_t)t;
    const uint32_t r = ctr.row;
    const int which = min((int)(uniform_ctr(key, c0) * (float)n_comp), n_comp - 1);
    const float u1 = uniform_ctr(key, c0 + r), u2 = uniform_ctr(key, c0 + 2u * r);
    V3 cand;
    if (which == 0) {
      cand = sample_cosine(u1, u2, n);
    } else if (which == 1) {
      cand = sample_vndf(u1, u2, n, v, roughness);
    } else {
      const float us[6] = {u1, u2, uniform_ctr(key, c0 + 3u * r), uniform_ctr(key, c0 + 4u * r),
                           uniform_ctr(key, c0 + 5u * r), uniform_ctr(key, c0 + 6u * r)};
      cand = sample_light_dir(T, us, point);
    }
    if (dot(cand, ns) > 0.0f && dot(cand, n) > 0.0f) {
      pick = cand;
      accepted = true;
    }
  }
}

// The mixture pdf of the pick from its sum `p` over the components, (cos +
// vndf) + light; `accepted` comes in as the candidate loop's.
__device__ __forceinline__ void mixture_pdf(float p, int n_comp, V3 pick, V3& l, float& pdf,
                                            bool& accepted) {
  p = p / (float)n_comp;
  accepted = accepted && (p > SAFE);
  pdf = fmaxf(p, SAFE);
  l = pick;
}

// K candidates, first accept, mixture pdf of the chosen one (mixture_body).
// LS: the lights' Tables, whose sample_light_dir and pdf_lights the call
// takes. K3 above 32 lights runs the two pieces apart, with its walk of the
// lights' tree between them (sampler.cu sampler_many_kernel).
template <class LS>
__device__ void mixture(const LS& T, uint32_t key, const Ctr& ctr, int max_tries, V3 point,
                        V3 n, V3 ns, V3 v, float roughness, V3& l, float& pdf, bool& accepted) {
  const int n_comp = mixture_components(T);
  V3 pick;
  mixture_pick(T, key, ctr, max_tries, n_comp, point, n, ns, v, roughness, pick, accepted);
  float p = pdf_cosine(n, pick) + pdf_vndf(n, pick, v, roughness);
  if (T.num_lights > 0) p = p + pdf_lights(T, point, pick);
  mixture_pdf(p, n_comp, pick, l, pdf, accepted);
}

// ---- one primitive record against a ray --------------------------------------
struct Facing {
  V3 cn;  // geometric normal facing the ray, not normalized
  bool outer, tri;
};

__device__ __forceinline__ V3 xyz(float4 r) { return mk(r.x, r.y, r.z); }

// Entry i against the ray: whether it is hit beyond tmin, and where. A
// record is three float4: a triangle's (a, spec) (e1, -) (e2, -); a box's,
// ellipsoid's or plane's (half-extents | radii | normal, spec) (position, -)
// (quaternion). With NORMAL the facing normal and the entry side are computed
// too: the fused loop (bounce_body.cuh) runs without, the winner is tested
// once more with. The BVH walk (bvh_traverse.cu) tests its leaves with it.
// The arithmetic is the plain versions' op for op (ops/intersect.py), so t
// comes out bit for bit as theirs.
template <bool NORMAL>
__device__ __forceinline__ bool test_entry(const float4* rec, int i, V3 ro, V3 rd, float& t,
                                           float& u, float& v, Facing& f, float tmin = 0.0f) {
  const float4 r0 = rec[3 * i], r1 = rec[3 * i + 1], r2 = rec[3 * i + 2];
  const int code = __float_as_int(r0.w);
  const int kind = code & 3;
  const bool rotated = (code >> 2) & 1;
  u = 0.0f;
  v = 0.0f;
  bool ok;
  if (kind == K_TRI) {
    const V3 a = xyz(r0), e1 = xyz(r1), e2 = xyz(r2);
    const V3 pv = cross(rd, e2);
    const float det = dot(e1, pv);
    const bool det_ok = fabsf(det) > 1e-30f;
    const float inv_det = 1.0f / (det_ok ? det : 1e-30f);
    const V3 tv = sub(ro, a);
    u = dot(tv, pv) * inv_det;
    const V3 qv = cross(tv, e1);
    v = dot(rd, qv) * inv_det;
    t = dot(e2, qv) * inv_det;
    ok = (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && det_ok && (t > tmin);
    if (NORMAL) {
      const V3 fn = cross(e1, e2);
      const bool front = dot(fn, rd) < 0.0f;
      f.cn = scl(fn, front ? 1.0f : -1.0f);
      f.outer = front;
      f.tri = true;
    }
    return ok;
  }
  V3 o = sub(ro, xyz(r1));
  V3 d = rd;
  const float qx = r2.x, qy = r2.y, qz = r2.z, qw = r2.w;
  if (rotated) {  // world -> local: rotate by the conjugate
    o = quat_rotate(-qx, -qy, -qz, qw, o);
    d = quat_rotate(-qx, -qy, -qz, qw, rd);
  }
  const float ax = r0.x, ay = r0.y, az = r0.z;
  V3 cn = mk(0.0f, 0.0f, 1.0f);
  bool outer;
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
    outer = valid && (t1 > tmin);
    t = outer ? t1 : t2;
    ok = valid && (t > tmin);
    if (NORMAL) {
      const float hx = o.x + d.x * t, hy = o.y + d.y * t, hz = o.z + d.z * t;
      const bool on_x = (ax - fabsf(hx)) < EPS;
      const bool on_y = (ay - fabsf(hy)) < EPS;
      const float flip = outer ? 1.0f : -1.0f;
      cn = mk((on_x ? sgnf(hx) : 0.0f) * flip, ((!on_x && on_y) ? sgnf(hy) : 0.0f) * flip,
              ((!on_x && !on_y) ? sgnf(hz) : 0.0f) * flip);
    }
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
    outer = valid && (t1 > tmin);
    t = outer ? t1 : t2;
    ok = valid && (t > tmin);
    if (NORMAL) {
      const float hx = o.x + d.x * t, hy = o.y + d.y * t, hz = o.z + d.z * t;
      const float flip = outer ? 1.0f : -1.0f;
      cn = mk(hx / (ax * ax) * flip, hy / (ay * ay) * flip, hz / (az * az) * flip);
    }
  } else {  // infinite plane through the local origin, normal (ax, ay, az)
    const float denom = ax * d.x + ay * d.y + az * d.z;
    const float num = ax * o.x + ay * o.y + az * o.z;
    const bool den_ok = fabsf(denom) > 1e-30f;
    t = -num / (den_ok ? denom : 1e-30f);
    ok = den_ok && (t > tmin);
    outer = denom < 0.0f;
    if (NORMAL) {
      const float flip = outer ? 1.0f : -1.0f;
      cn = mk(ax * flip, ay * flip, az * flip);
    }
  }
  if (NORMAL) {
    if (rotated) cn = quat_rotate(qx, qy, qz, qw, cn);
    f.cn = cn;
    f.outer = outer;
    f.tri = false;
  }
  return ok;
}

}  // namespace
