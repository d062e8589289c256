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
// State: 13 floats per lane (ro3, rd3, thr3, rad3, alive), channel-major
// (13, b). The port may pass the same buffer as input and output (in-place
// update; the JAX kernel always wrote fresh buffers): a lane is read and
// written by one thread only, its owner when it is dead on entry, else the
// thread of the same block it was ranked to, and that thread reads it before
// it writes it.
//
// Per live lane: nearest hit over the scene's M <= 128 entries (triangles by
// Moller-Trumbore in world space, boxes by a slab test with DIR_BIAS,
// ellipsoids by a quadratic, planes; rotated entries in their local frame),
// the winner's attributes read by index from the (35, M) table, emission and
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
// * The loop's records (48 B per entry) and the light table (18 x L <= 32)
//   are staged in shared memory once per block; the winner's attributes are
//   read by index from device memory (the TPU needed select chains because
//   its lanes have no random access).
// * The TPU hardware PRNG has no Hopper equivalent: draws come from the
//   counter RNG of ops/rng.py (work_key/uniform_ctr in common.cuh), keyed by
//   (seed, work id) at the counters of a Ctr layout (batch: bounce *
//   draws_per_bounce + d; lane mode: 2 + 64 depth + d), so kernel and plain
//   version see identical numbers and the image does not depend on the lane
//   count. On the TPU the lane engines drew per (round, block) from the
//   hardware PRNG, which made their images depend on the lane count; here
//   every draw is keyed by work item on every engine.
// * A persistent grid of 256-thread blocks drawing tiles of lanes, the last
//   tile masked (the TPU's 8192-lane block was a Mosaic PRNG lowering rule).
// * Build without --use_fast_math: a miss is best_t = inf, boxes divide by
//   d + 1e-9, and both need IEEE inf; sign() keeps sign(0) == 0. Build with
//   --fmad=false (ops/kernels.py): rounding op by op, as the plain PyTorch
//   versions do, keeps the two in agreement on >= 99.99 % of lanes.
// * Work the result cannot depend on is skipped: dead lanes and delta
//   (MIRROR/DIELECTRIC) lanes run no mixture sampling, and sampling stops at
//   the first accepted candidate.
//
// What bounds it on an H100: per lane and launch at most 108 B of state and
// work-id traffic (a dead lane in place: 28 B) against M x 53 fp32 operations
// of the intersection loop for each live lane, plus up to max_tries sampling
// tries, the mixture pdf over every light and the BRDF. The bytes would take
// 0.03 ms for 921,600 lanes; the launch takes 0.16 ms, and its time follows
// the passes the warps make over the body's ~4,600 instructions at 80
// registers (24 warps per SM): instruction rate and latency bound it,
// with divergence (hit or miss, material, the sampler's three-way pick), not
// HBM. From a frame's second bounce on under half the lanes are alive and
// they die one by one, so with a thread per lane most warps walked the whole
// loop for a few live lanes (the lanes dead at bounce 1 are mostly whole runs
// of background pixels, which a thread per lane skipped well enough). What
// the design does about it (bounce_body.cuh has the details): a persistent
// grid that stages the tables once per block and draws its tiles from a
// counter; the live lanes of each tile ranked into a queue in shared memory,
// from which the block takes a lane per thread, so that every pass over the
// body runs with all threads busy; 16-byte records for the loop and
// attributes for the winner only; the facing normal computed once, for the
// winner; in place a dead lane costs three loads and three stores; the live
// lanes on entry are counted for the caller, so that the integrator launches
// no reduction per level. K2's lanes are all alive: it shares the grid, the
// records and the loop, and needs no ranking.

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
  const int* wid;                // (b,) work id base per lane
  const long long* seed_off;     // (2,): seed, wid_off (low 32 bits of each)
  Ctr ctr;             // this bounce's draws (lane mode: at depth 0)
  const int* depth;    // (b,) per-lane depth in lane mode, else nullptr
  uint32_t ctr_stride;  // counters per depth level in lane mode
  unsigned long long* count;  // += lanes alive on entry, or nullptr
  int* tick;                  // (2,) tile counter of walk_tiles, 0 between launches
  SceneArgs sc;
};

// The lane's key: the seed and the work-id offset are read from device
// memory where the key is made (one broadcast load each, from L1), so that a
// CUDA graph that captured the launch replays it for any seed and sample
// offset; held from the kernel's start they would live through the walk.
__device__ __forceinline__ uint32_t lane_key(const Params& p, long long i) {
  const uint32_t seed = (uint32_t)__ldg(&p.seed_off[0]);
  const uint32_t wid_off = (uint32_t)__ldg(&p.seed_off[1]);
  return work_key(seed, (uint32_t)p.wid[i] + wid_off);
}

// A lane that is dead on entry stays dead; a full bounce zeroes its
// throughput. In place nothing else of it changes.
template <bool FINAL_ONLY>
__device__ __forceinline__ void pass_dead(const Params& p, long long i) {
  const long long b = p.b;
  if (!FINAL_ONLY) {
#pragma unroll
    for (int r = 6; r < 9; ++r) p.out[r * b + i] = p.in[r * b + i] * 0.0f;
  }
  if (p.out != p.in) {
#pragma unroll
    for (int r = 0; r < 12; ++r)
      if (FINAL_ONLY || r < 6 || r >= 9) p.out[r * b + i] = p.in[r * b + i];
    p.out[12 * b + i] = 0.0f;
  }
}

template <bool FINAL_ONLY>
__device__ __forceinline__ void run_lane(const Params& p, const Tables& T, long long i) {
  Lane s = load_lane(p.in, p.b, i);
  s.alive = true;
  const uint32_t key = lane_key(p, i);
  const Ctr ctr = p.depth ? at_depth(p.ctr, p.ctr_stride, (uint32_t)p.depth[i]) : p.ctr;
  store_lane(p.out, p.b, i, bounce_body<FINAL_ONLY>(T, p.sc, key, ctr, s));
}

template <bool FINAL_ONLY>
__global__ void __launch_bounds__(kBlock, kMinBlocks) bounce_kernel(Params p) {
  __shared__ SharedTables sh;
  __shared__ LaneQueue queue;
  __shared__ int red[kWarps];
  const Tables T = stage_tables(p.sc, !FINAL_ONLY, sh);
  const long long b = p.b;
  const float* alive_row = p.in + 12 * b;
  const int entered = walk_tiles(
      b, p.tick, queue, [&](long long i) { return i < b && alive_row[i] > 0.5f; },
      [&](long long i) { pass_dead<FINAL_ONLY>(p, i); },
      [&](long long i) { run_lane<FINAL_ONLY>(p, T, i); });
  if (p.count) {  // the lanes alive on entry
    const int total = block_sum(entered, red);
    if (threadIdx.x == 0 && total) atomicAdd(p.count, (unsigned long long)total);
  }
}

// Every lane starts a path, so there is nothing to rank: the grid walks the
// lanes a block's width at a time.
__global__ void __launch_bounds__(kBlock, kMinBlocks) primary_kernel(Params p) {
  __shared__ SharedTables sh;
  const Tables T = stage_tables(p.sc, true, sh);
  for (long long i = (long long)blockIdx.x * kBlock + threadIdx.x; i < p.b;
       i += (long long)gridDim.x * kBlock) {
    const uint32_t key = lane_key(p, i);
    Lane s;
    camera_ray(p.cam, p.px[i], p.py[i], p.width, p.height, uniform_ctr(key, CTR_JITTER),
               uniform_ctr(key, CTR_JITTER + 1u), s.ro, s.rd);
    s.thr = mk(1.0f, 1.0f, 1.0f);
    s.rad = mk(0.0f, 0.0f, 0.0f);
    s.alive = true;
    store_lane(p.out, p.b, i, bounce_body<false>(T, p.sc, key, p.ctr, s));
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take). Never synchronises. `seed_off` is two
// int64 in device memory, the seed and the work-id offset, read by the
// kernel (their low 32 bits). `depth` may be
// null (batch mode: every lane draws at `ctr`). `count` may be null; else the
// kernel adds the lanes alive on entry to the int64 it points to. `tick` is
// two int32 that are 0 between launches and belong to this stream: the
// kernel hands out its tiles with them and sets them back.
extern "C" int rt_launch_bounce(const void* in, void* out, long long b, const void* wid,
                                const void* seed_off, unsigned ctr_base,
                                unsigned ctr_cand, unsigned ctr_row, unsigned ctr_diel,
                                const void* depth, unsigned ctr_stride, const void* geo,
                                const void* rec, int m, const void* lp, const void* lspec,
                                int nl, int num_lights, float bg0, float bg1, float bg2,
                                int max_tries, int final_only, void* count, void* tick,
                                void* stream) {
  if (bad_args(b, m, nl, num_lights, max_tries)) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  Params p{};
  p.in = static_cast<const float*>(in);
  p.out = static_cast<float*>(out);
  p.b = b;
  p.wid = static_cast<const int*>(wid);
  p.seed_off = static_cast<const long long*>(seed_off);
  p.ctr = Ctr{ctr_base, ctr_cand, ctr_row, ctr_diel};
  p.depth = static_cast<const int*>(depth);
  p.ctr_stride = ctr_stride;
  p.count = static_cast<unsigned long long*>(count);
  p.tick = static_cast<int*>(tick);
  p.sc = scene_args(geo, rec, m, lp, lspec, nl, num_lights, bg0, bg1, bg2, max_tries);
  const long long blocks = (b + kTile - 1) / kTile;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (final_only)
    bounce_kernel<true><<<grid_for(bounce_kernel<true>, blocks), kBlock, 0, st>>>(p);
  else
    bounce_kernel<false><<<grid_for(bounce_kernel<false>, blocks), kBlock, 0, st>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int rt_launch_primary(const void* px, const void* py, const void* cam, int width,
                                 int height, void* out, long long b, const void* wid,
                                 const void* seed_off, unsigned ctr_base,
                                 unsigned ctr_cand, unsigned ctr_row, unsigned ctr_diel,
                                 const void* geo, const void* rec, int m, const void* lp,
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
  p.seed_off = static_cast<const long long*>(seed_off);
  p.ctr = Ctr{ctr_base, ctr_cand, ctr_row, ctr_diel};
  p.sc = scene_args(geo, rec, m, lp, lspec, nl, num_lights, bg0, bg1, bg2, max_tries);
  primary_kernel<<<grid_for(primary_kernel, (b + kBlock - 1) / kBlock), kBlock, 0,
                   static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// Launch geometry of the three kernels, for reports: out = {SMs of the
// current device, threads per block, lanes per tile, resident blocks per SM
// of bounce_kernel<false>, of bounce_kernel<true>, of primary_kernel}.
extern "C" void rt_bounce_geometry(int* out) {
  out[0] = sm_count();
  out[1] = kBlock;
  out[2] = kTile;
  out[3] = resident_blocks(bounce_kernel<false>);
  out[4] = resident_blocks(bounce_kernel<true>);
  out[5] = resident_blocks(primary_kernel);
}
