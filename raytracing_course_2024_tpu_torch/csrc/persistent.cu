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
// Two counts per round, lanes alive after the restart (path vertices) and
// lanes still alive or with paths left, are summed per block; the last block
// writes them into the loop's counters as the round test (loop.cuh: n = the
// second, more = n > 0, the first added to the path vertices), so the
// engine's loop needs no launch of its own to test a K5 round. The seed,
// pix_base and samp_base are three int64 on the device (`sb`), so that one
// captured graph of the round serves every frame. The plain PyTorch version
// is ops/persistent.py:persistent_plain, with ops/loop.py:k5_round_plain.
//
// State: (18, b) f32, channel-major, in the JAX order ro3, rd3, thr3, rad3,
// alive, k, depth, acc3 (rows 0-12 are K1's state). The JAX kernel aliased
// its 18 inputs to its outputs; here `out` may be `in` itself (a lane is read
// and written by one thread only, which reads it before it writes it), which
// is how the engine calls it.
//
// Translation from the TPU kernel:
// * The TPU kernel drew from the hardware PRNG seeded per (round, block), so
//   the JAX images of this engine depended on the lane count. Here every
//   draw comes from the counter RNG of ops/rng.py keyed by work item (the
//   decision K1/K2 made): the image is the one the counter-refill engine and
//   the unfused sticky engine give, for any lane count.
// * The TPU grid ran 8192-lane blocks, and the engine padded the lanes to a
//   multiple of 8192; here the lanes are the pixels, walked in tiles by a
//   persistent grid of 256-thread blocks, the last tile masked.
// * Per-block partial sums of the two counts became one atomicAdd per block
//   into the loop's 64-bit scratch, which the last block to take a ticket
//   turns into the loop's counters and the next round's IF predicate, and
//   leaves at 0; the host reads the counters once per replay of several
//   rounds (integrator/wavefront.py:FusedStickyLoop).
// * Counters k, kmax and depth stay f32, as in the JAX state (budgets are far
//   below 2^24).
//
// What bounds it on an H100: per lane and round 120 B of traffic at most
// (a lane that goes on: 16 rows in, 14 out), against the intersection loop
// (M entries x 53 fp32 operations) and the sampler for each lane that runs a
// path: as for K1, instruction rate, divergence and latency, not HBM (the
// bytes would take 0.03 ms for 921,600 lanes, the round takes 0.22 ms when
// every lane runs a path). In a 16 spp Cornell frame every lane runs a path
// for 16 rounds, 56 % do for the next 50 (the others, the pixels that see
// only the background, have finished), and very few in the last rounds. What
// the design does about it, with K1 (bounce_body.cuh): a persistent grid
// that stages the tables once per block and draws its tiles from a counter;
// per tile, every thread reads alive, k and kmax of its own lanes, the lanes
// that run a path this round (alive, or dead with paths left) are ranked
// into the block's queue, and whenever a block's worth of lanes waits every
// thread takes one and flushes, restarts and bounces it; a finished lane
// gets its flush and its counters from the thread that owns it; each case
// moves only the rows it needs; 16-byte records for the loop, attributes and
// the facing normal for the winner only. The first count is the tiles' live
// lanes; each count takes one block reduction per launch. The whole round
// stays one pass: no restart, flush or camera pass of its own.

#include "bounce_body.cuh"
#include "loop.cuh"

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
  uint32_t frame_pix;
  const long long* sb;  // (3,) seed, pix_base, samp_base on the device
  Ctr ctr;             // the draws of depth 0
  uint32_t ctr_stride;  // counters per depth level
  int ray_depth;
  SceneArgs sc;
  LoopOut lo;  // the loop's counters, written by the last block
  int* tick;    // (2,) tile counter of walk_tiles, 0 between launches
};

// Whether lane i runs a path this round: alive, or dead with paths left.
__device__ __forceinline__ bool runs_path(const PersistentParams& p, long long i) {
  const long long b = p.b;
  return i < b && (p.in[12 * b + i] > 0.5f || p.in[S_K * b + i] < p.kmax[i]);
}

// A lane whose paths are all finished: flush the last one, zero radiance and
// throughput (a bounce zeroes a dead lane's throughput), count the round in
// its depth. In place its rays, flag and k stay as they are, and from its
// second such round on (radiance and throughput already 0) only the depth
// moves: 44 B of traffic instead of 104 B.
__device__ __forceinline__ void finish_lane(const PersistentParams& p, long long i) {
  const long long b = p.b;
  const float* in = p.in;
  float* out = p.out;
  const V3 thr = mk(in[6 * b + i], in[7 * b + i], in[8 * b + i]);
  const V3 rad = mk(in[9 * b + i], in[10 * b + i], in[11 * b + i]);
  const float depth = in[S_DEPTH * b + i];
  out[S_DEPTH * b + i] = depth + 1.0f;
  const bool settled = thr.x == 0.0f && thr.y == 0.0f && thr.z == 0.0f && rad.x == 0.0f &&
                       rad.y == 0.0f && rad.z == 0.0f;
  if (settled && out == in) return;
  const float k = in[S_K * b + i];
  V3 acc = mk(in[(S_ACC + 0) * b + i], in[(S_ACC + 1) * b + i], in[(S_ACC + 2) * b + i]);
  if (k > 0.5f) acc = add(acc, rad);
  out[6 * b + i] = thr.x * 0.0f;
  out[7 * b + i] = thr.y * 0.0f;
  out[8 * b + i] = thr.z * 0.0f;
#pragma unroll
  for (int r = 9; r < 12; ++r) out[r * b + i] = 0.0f;
  out[(S_ACC + 0) * b + i] = acc.x;
  out[(S_ACC + 1) * b + i] = acc.y;
  out[(S_ACC + 2) * b + i] = acc.z;
  if (out != in) {
#pragma unroll
    for (int r = 0; r < 6; ++r) out[r * b + i] = in[r * b + i];
    out[12 * b + i] = 0.0f;
    out[S_K * b + i] = k;
  }
}

// One round of a lane that runs a path (runs_path): a live lane goes on, a
// dead one has paths left and restarts. Returns whether it has work left.
// Only what the lane's case needs is moved: a restart reads no ray and no
// throughput, and in place the accumulator moves only with a flush and k
// only with a restart.
__device__ __forceinline__ bool run_lane(const PersistentParams& p, const Tables& T,
                                         const uint3 ids, long long i) {
  const long long b = p.b;
  const float* in = p.in;
  float* out = p.out;
  const bool inplace = out == in;
  const bool dead = !(in[12 * b + i] > 0.5f);
  float k = in[S_K * b + i];
  const float kmax = p.kmax[i];
  // 1. flush the finished path
  const bool flush = dead && k > 0.5f;
  const bool acc_moves = flush || !inplace;
  V3 acc = mk(0.0f, 0.0f, 0.0f);
  if (acc_moves)
    acc = mk(in[(S_ACC + 0) * b + i], in[(S_ACC + 1) * b + i], in[(S_ACC + 2) * b + i]);
  if (flush) acc = add(acc, mk(in[9 * b + i], in[10 * b + i], in[11 * b + i]));
  Lane s;
  float depth;
  if (dead) {  // 2. restart the lane's next path (it has one: k < kmax)
    k += 1.0f;
    depth = 0.0f;
    s.thr = mk(1.0f, 1.0f, 1.0f);
    s.rad = mk(0.0f, 0.0f, 0.0f);
  } else {
    s = load_lane(in, b, i);
    depth = in[S_DEPTH * b + i];
  }
  s.alive = true;
  // 3. the key of path (pixel, sample k - 1), after the restart
  const uint32_t samp = k > 0.5f ? (uint32_t)(k - 1.0f) : 0u;
  const uint32_t wid = (ids.z + samp) * p.frame_pix + ids.y + (uint32_t)i;
  const uint32_t key = work_key(ids.x, wid);
  // 4. the camera ray of a restarted lane
  if (dead)
    camera_ray(p.cam, p.px[i], p.py[i], p.width, p.height, uniform_ctr(key, CTR_JITTER),
               uniform_ctr(key, CTR_JITTER + 1u), s.ro, s.rd);
  // k, depth and the accumulator are final here: stored before the bounce, so
  // that only two flags stay in registers across it
  if (dead || !inplace) out[S_K * b + i] = k;
  out[S_DEPTH * b + i] = depth + 1.0f;
  if (acc_moves) {
    out[(S_ACC + 0) * b + i] = acc.x;
    out[(S_ACC + 1) * b + i] = acc.y;
    out[(S_ACC + 2) * b + i] = acc.z;
  }
  const bool paths_left = k < kmax;
  const bool below_cap = depth < (float)(p.ray_depth - 1);
  // 5. the fused bounce at the lane's depth; 6. the depth cap
  Lane o = bounce_body<false>(T, p.sc, key, at_depth(p.ctr, p.ctr_stride, (uint32_t)depth), s);
  o.alive = o.alive && below_cap;
  store_lane(out, b, i, o);
  return o.alive || paths_left;
}

__global__ void __launch_bounds__(kBlock, kMinBlocks) persistent_kernel(PersistentParams p) {
  __shared__ SharedTables sh;
  __shared__ LaneQueue queue;
  __shared__ int red[kWarps];
  const Tables T = stage_tables(p.sc, true, sh);
  // (seed, pix_base, samp_base), low 32 bits, read on the device
  const uint3 ids = make_uint3((uint32_t)__ldg(p.sb), (uint32_t)__ldg(p.sb + 1),
                               (uint32_t)__ldg(p.sb + 2));
  int more = 0;  // lanes of this thread's passes with work left
  // a lane that runs a path is alive after its restart: the first count
  const int live = walk_tiles(
      p.b, p.tick, queue, [&](long long i) { return runs_path(p, i); },
      [&](long long i) { finish_lane(p, i); },
      [&](long long i) { more += run_lane(p, T, ids, i); });
  const int live_blk = block_sum(live, red);
  __syncthreads();
  const int more_blk = block_sum(more, red);
  if (threadIdx.x != 0) return;
  long long live_all = live_blk, more_all = more_blk;
  if (last_block_totals(p.lo, live_all, more_all))
    write_round(p.lo, more_all, more_all > 0, false, live_all);
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take). Never synchronises. `tick`: as for
// rt_launch_bounce. `sb`: three int64 on the device (seed, pix_base,
// samp_base). `loop`, `preds`, `scratch`: the loop's counters (loop.cuh),
// the scratch at 0.
extern "C" int rt_launch_persistent(const void* in, void* out, long long b, const void* px,
                                    const void* py, const void* kmax, const void* cam,
                                    int width, int height, const void* sb, unsigned frame_pix,
                                    unsigned ctr_base,
                                    unsigned ctr_cand, unsigned ctr_row, unsigned ctr_diel,
                                    unsigned ctr_stride, int ray_depth, const void* geo,
                                    const void* rec, int m, const void* lp, const void* lspec,
                                    int nl, int num_lights, float bg0, float bg1, float bg2,
                                    int max_tries, void* loop, void* preds, void* scratch,
                                    void* tick, void* stream) {
  if (bad_args(b, m, nl, num_lights, max_tries) || width < 1 || height < 1 || sb == nullptr ||
      loop == nullptr || preds == nullptr || scratch == nullptr)
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
  p.frame_pix = frame_pix;
  p.sb = static_cast<const long long*>(sb);
  p.ctr = Ctr{ctr_base, ctr_cand, ctr_row, ctr_diel};
  p.ctr_stride = ctr_stride;
  p.ray_depth = ray_depth;
  p.sc = scene_args(geo, rec, m, lp, lspec, nl, num_lights, bg0, bg1, bg2, max_tries);
  p.lo = LoopOut{static_cast<long long*>(loop), static_cast<bool*>(preds),
                  static_cast<unsigned long long*>(scratch)};
  p.tick = static_cast<int*>(tick);
  persistent_kernel<<<grid_for(persistent_kernel, (b + kTile - 1) / kTile), kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of persistent_kernel on the current device.
extern "C" int rt_persistent_resident_blocks() { return resident_blocks(persistent_kernel); }
