// Persistent pixel-sticky round for NVIDIA Hopper (sm_90a), hand-written CUDA.
//
// rt_launch_persistent replaces the TPU kernel K5,
// raytracing_course_2024_tpu/ops/pallas_bounce.py:_persistent_kernel (via
// _run_persistent, API persistent_round): one round of the pixel-sticky
// engine's fused loop (integrator/wavefront.py _sticky_fused). Lane l owns
// pixel pix_base + l and walks its kmax paths one after another. Per lane:
//   1. flush: a dead lane with k > 0 adds its path radiance to acc;
//   2. restart: a dead lane with k < kmax starts path k (k += 1, depth 0,
//      throughput 1);
//   3. the work key of path (pixel, sample samp_base + k - 1), taken after
//      the restart;
//   4. camera jitter from counters 0 and 1 of that key, the pinhole ray;
//   5. the fused bounce: bounce_body of bounce_body.cuh, the body K1 runs,
//      at the lane's own depth in the lane engines' draw layout;
//   6. the depth cap: alive' = alive && depth < ray_depth - 1, depth + 1.
// Two counts per round go to counts[0] (lanes alive after the restart: path
// vertices) and counts[1] (lanes still alive or with paths left), by a warp
// and block reduction and one atomicAdd per block each. The plain PyTorch
// version is ops/persistent.py:persistent_plain.
//
// State: (18, b) f32, channel-major, in the JAX order ro3, rd3, thr3, rad3,
// alive, k, depth, acc3 (rows 0-12 are K1's state). The JAX kernel aliased
// its 18 inputs to its outputs; here `out` may be `in` itself (every thread
// reads its lane before it writes it), which is how the engine calls it.
//
// Translation from the TPU kernel:
// * The TPU kernel drew from the hardware PRNG seeded per (round, block), so
//   the JAX images of this engine depended on the lane count. Here every
//   draw comes from the counter RNG of ops/rng.py keyed by work item (the
//   decision K1/K2 made): the image is the one the counter-refill engine and
//   the unfused sticky engine give, for any lane count.
// * The TPU grid ran 8192-lane blocks, and the engine padded the lanes to a
//   multiple of 8192; here the lanes are the pixels, in 256-thread blocks
//   with a masked tail.
// * Per-block partial sums of the two counts became one atomicAdd per block
//   into a (2,) int32 counter that the caller zeroes; the engine reads the
//   counts one round late, so the card is not left idle while the host reads.
// * Counters k, kmax and depth stay f32, as in the JAX state (budgets are far
//   below 2^24).
//
// What bounds it on an H100: per lane and round 156 B of traffic at most
// (px, py, kmax and the 18 state rows in; 18 rows out), against the intersect
// loop (M entries x ~70 fp32 operations) and the sampler for live lanes: as
// for K1, fp32 issue, divergence and latency, not HBM. The design keeps the
// whole round in one pass: no restart, flush or camera pass of its own.

#include "bounce_body.cuh"

namespace {

constexpr int S_K = 13, S_DEPTH = 14, S_ACC = 15;  // rows after K1's 13

struct PersistentParams {
  const float* in;  // (18, b)
  float* out;       // (18, b), may be `in`
  long long b;
  const float* px;    // (b,) pixel x
  const float* py;    // (b,) pixel y
  const float* kmax;  // (b,) paths per lane
  const float* cam;   // (128,) camera row
  int width, height;
  uint32_t seed, frame_pix, pix_base, samp_base;
  Ctr ctr;             // the draws of depth 0
  uint32_t ctr_stride;  // counters per depth level
  int ray_depth;
  SceneArgs sc;
  int* counts;  // (2,): live lanes after the restart, lanes with work left
};

__device__ __forceinline__ int block_sum(int v, int* red) {
  v = __reduce_add_sync(0xffffffffu, v);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) total += red[w];
  return total;  // meaningful in thread 0
}

__global__ void __launch_bounds__(kThreads) persistent_kernel(PersistentParams p) {
  __shared__ SharedTables sh;
  __shared__ int red[2][kThreads / 32];
  const Tables T = stage_tables(p.sc, true, sh);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long b = p.b;
  int live = 0, more = 0;
  if (i < b) {
    const float* in = p.in;
    Lane s = load_lane(in, b, i);
    float k = in[S_K * b + i];
    float depth = in[S_DEPTH * b + i];
    V3 acc = mk(in[(S_ACC + 0) * b + i], in[(S_ACC + 1) * b + i], in[(S_ACC + 2) * b + i]);
    const float kmax = p.kmax[i];
    // 1. flush the finished path; 2. restart the lane's next path
    const bool dead = !s.alive;
    if (dead && k > 0.5f) acc = add(acc, s.rad);
    if (dead) s.rad = mk(0.0f, 0.0f, 0.0f);
    const bool take = dead && k < kmax;
    if (take) {
      k += 1.0f;
      depth = 0.0f;
      s.thr = mk(1.0f, 1.0f, 1.0f);
    }
    // 3. the key of path (pixel, sample k - 1), after the restart
    const uint32_t samp = k > 0.5f ? (uint32_t)(k - 1.0f) : 0u;
    const uint32_t wid = (p.samp_base + samp) * p.frame_pix + p.pix_base + (uint32_t)i;
    const uint32_t key = work_key(p.seed, wid);
    // 4. the camera ray of a restarted lane
    if (take) {
      camera_ray(p.cam, p.px[i], p.py[i], p.width, p.height, uniform_ctr(key, CTR_JITTER),
                 uniform_ctr(key, CTR_JITTER + 1u), s.ro, s.rd);
      s.alive = true;
    }
    live = s.alive;
    // 5. the fused bounce at the lane's depth; 6. the depth cap
    Lane o = bounce_body<false>(T, p.sc, key, at_depth(p.ctr, p.ctr_stride, (uint32_t)depth), s);
    o.alive = o.alive && depth < (float)(p.ray_depth - 1);
    more = o.alive || k < kmax;
    float* out = p.out;
    store_lane(out, b, i, o);
    out[S_K * b + i] = k;
    out[S_DEPTH * b + i] = depth + 1.0f;
    out[(S_ACC + 0) * b + i] = acc.x;
    out[(S_ACC + 1) * b + i] = acc.y;
    out[(S_ACC + 2) * b + i] = acc.z;
  }
  const int live_blk = block_sum(live, red[0]);
  const int more_blk = block_sum(more, red[1]);
  if (threadIdx.x == 0) {
    if (live_blk) atomicAdd(&p.counts[0], live_blk);
    if (more_blk) atomicAdd(&p.counts[1], more_blk);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take). Never synchronises.
extern "C" int rt_launch_persistent(const void* in, void* out, long long b, const void* px,
                                    const void* py, const void* kmax, const void* cam,
                                    int width, int height, unsigned seed, unsigned frame_pix,
                                    unsigned pix_base, unsigned samp_base, unsigned ctr_base,
                                    unsigned ctr_cand, unsigned ctr_row, unsigned ctr_diel,
                                    unsigned ctr_stride, int ray_depth, const void* geo,
                                    const void* spec, int m, const void* lp, const void* lspec,
                                    int nl, int num_lights, float bg0, float bg1, float bg2,
                                    int max_tries, void* counts, void* stream) {
  if (bad_args(b, m, nl, num_lights, max_tries) || width < 1 || height < 1)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  PersistentParams p{};
  p.in = static_cast<const float*>(in);
  p.out = static_cast<float*>(out);
  p.b = b;
  p.px = static_cast<const float*>(px);
  p.py = static_cast<const float*>(py);
  p.kmax = static_cast<const float*>(kmax);
  p.cam = static_cast<const float*>(cam);
  p.width = width;
  p.height = height;
  p.seed = seed;
  p.frame_pix = frame_pix;
  p.pix_base = pix_base;
  p.samp_base = samp_base;
  p.ctr = Ctr{ctr_base, ctr_cand, ctr_row, ctr_diel};
  p.ctr_stride = ctr_stride;
  p.ray_depth = ray_depth;
  p.sc = scene_args(geo, spec, m, lp, lspec, nl, num_lights, bg0, bg1, bg2, max_tries);
  p.counts = static_cast<int*>(counts);
  const unsigned grid = (unsigned)((b + kThreads - 1) / kThreads);
  persistent_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
