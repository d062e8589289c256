// Fused path-tracing bounce for NVIDIA Hopper (sm_90a), hand-written CUDA.
//
// Entry points (launchers at the end of the file, plain C interface, bound
// with ctypes by ops/kernels.py):
//   rt_launch_bounce(final_only = 0)  replaces the TPU kernel K1,
//       raytracing_course_2024_tpu/ops/pallas_bounce.py:_kernel (via _run):
//       one full bounce of a live path. In lane mode (a per-lane depth
//       pointer) each lane draws at its own depth in the lane engines' layout
//       (integrator/wavefront.py); the JAX package's fused wavefront core
//       called the same TPU kernel;
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
// The body lives in bounce_body.cuh, which the persistent round
// (persistent.cu, K5) includes too; the sampler stage and the math under it
// live in common.cuh, which the standalone sampler kernel (sampler.cu, K3)
// includes as well.
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
//   (seed, work id) at the counters of a Ctr layout (batch: bounce *
//   draws_per_bounce + d; lane mode: 2 + 64 depth + d), so kernel and plain
//   version see identical numbers and the image does not depend on the lane
//   count. On the TPU the lane engines drew per (round, block) from the
//   hardware PRNG, which made their images depend on the lane count; here
//   every draw is keyed by work item on every engine.
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

#include "bounce_body.cuh"

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
  uint32_t wid_off, seed;
  Ctr ctr;             // this bounce's draws (lane mode: at depth 0)
  const int* depth;    // (b,) per-lane depth in lane mode, else nullptr
  uint32_t ctr_stride;  // counters per depth level in lane mode
  SceneArgs sc;
};

template <bool FINAL_ONLY>
__global__ void __launch_bounds__(kThreads) bounce_kernel(Params p) {
  __shared__ SharedTables sh;
  const Tables T = stage_tables(p.sc, !FINAL_ONLY, sh);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.b) return;
  const Lane s = load_lane(p.in, p.b, i);
  const uint32_t key = work_key(p.seed, (uint32_t)p.wid[i] + p.wid_off);
  const Ctr ctr = p.depth ? at_depth(p.ctr, p.ctr_stride, (uint32_t)p.depth[i]) : p.ctr;
  store_lane(p.out, p.b, i, bounce_body<FINAL_ONLY>(T, p.sc, key, ctr, s));
}

__global__ void __launch_bounds__(kThreads) primary_kernel(Params p) {
  __shared__ SharedTables sh;
  const Tables T = stage_tables(p.sc, true, sh);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.b) return;
  const uint32_t key = work_key(p.seed, (uint32_t)p.wid[i] + p.wid_off);
  Lane s;
  camera_ray(p.cam, p.px[i], p.py[i], p.width, p.height, uniform_ctr(key, CTR_JITTER),
             uniform_ctr(key, CTR_JITTER + 1u), s.ro, s.rd);
  s.thr = mk(1.0f, 1.0f, 1.0f);
  s.rad = mk(0.0f, 0.0f, 0.0f);
  s.alive = true;
  store_lane(p.out, p.b, i, bounce_body<false>(T, p.sc, key, p.ctr, s));
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take). Never synchronises. `depth` may be
// null (batch mode: every lane draws at `ctr`).
extern "C" int rt_launch_bounce(const void* in, void* out, long long b, const void* wid,
                                unsigned wid_off, unsigned seed, unsigned ctr_base,
                                unsigned ctr_cand, unsigned ctr_row, unsigned ctr_diel,
                                const void* depth, unsigned ctr_stride, const void* geo,
                                const void* spec, int m, const void* lp, const void* lspec,
                                int nl, int num_lights, float bg0, float bg1, float bg2,
                                int max_tries, int final_only, void* stream) {
  if (bad_args(b, m, nl, num_lights, max_tries)) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  Params p{};
  p.in = static_cast<const float*>(in);
  p.out = static_cast<float*>(out);
  p.b = b;
  p.wid = static_cast<const int*>(wid);
  p.wid_off = wid_off;
  p.seed = seed;
  p.ctr = Ctr{ctr_base, ctr_cand, ctr_row, ctr_diel};
  p.depth = static_cast<const int*>(depth);
  p.ctr_stride = ctr_stride;
  p.sc = scene_args(geo, spec, m, lp, lspec, nl, num_lights, bg0, bg1, bg2, max_tries);
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
                                 unsigned ctr_cand, unsigned ctr_row, unsigned ctr_diel,
                                 const void* geo, const void* spec, int m, const void* lp,
                                 const void* lspec, int nl, int num_lights, float bg0,
                                 float bg1, float bg2, int max_tries, void* stream) {
  if (bad_args(b, m, nl, num_lights, max_tries) || width < 1 || height < 1)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  Params p{};
  p.px = static_cast<const float*>(px);
  p.py = static_cast<const float*>(py);
  p.cam = static_cast<const float*>(cam);
  p.width = width;
  p.height = height;
  p.out = static_cast<float*>(out);
  p.b = b;
  p.wid = static_cast<const int*>(wid);
  p.wid_off = wid_off;
  p.seed = seed;
  p.ctr = Ctr{ctr_base, ctr_cand, ctr_row, ctr_diel};
  p.sc = scene_args(geo, spec, m, lp, lspec, nl, num_lights, bg0, bg1, bg2, max_tries);
  const unsigned grid = (unsigned)((b + kThreads - 1) / kThreads);
  primary_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
