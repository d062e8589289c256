// The lane engines' refill and restart for NVIDIA Hopper (sm_90a),
// hand-written CUDA.
//
// Entry points (plain C interface, bound with ctypes by ops/kernels.py):
//   rt_launch_refill   N2a, the counter wavefront's refill: two launches,
//       refill_count_kernel then refill_kernel;
//   rt_launch_restart  N2b, the pixel-sticky engine's restart: one launch.
// Neither replaces a Pallas kernel. The JAX package runs each lane engine as
// one lax.while_loop under jax.jit, and XLA fuses the element-wise work of
// its loop body: the refill, raytracing_course_2024_tpu/integrator/
// wavefront.py:236-274 (refill), and the restart, :455-500 (restart). In
// the port that work ran as dozens of PyTorch kernels per round, inside the
// round's CUDA graph. The plain PyTorch versions are ops/refill.py:
// refill_plain and restart_plain; the kernels equal them bit for bit.
//
// N2a, over every lane of the (13, b) state (ro3, rd3, thr3, rad3, alive):
// a dead lane flushes its radiance into column work[i] of `done` when it
// holds a work item, its radiance is zeroed, and it takes work item
// counter + rank, where rank is the number of dead lanes before it in lane
// order (the JAX cumsum), if that is below `total`; the counter moves on by
// the items handed out. Every lane's work id (its pixel and sample, int32)
// goes to `wid`, and a taken lane starts a path on its pixel's jittered
// camera ray (draws 0 and 1 of its key) at depth 0.
//
// The rank in lane order is the one thing that crosses lanes. It takes two
// launches:
// * refill_count_kernel: each block counts the dead lanes of its tile of
//   kTileLanes lanes (a ballot per row of 256 lanes) into scan[2 + tile].
//   The last block to finish (a ticket in scan[0], counted up after a
//   __threadfence, the pattern of CUDA's threadFenceReduction sample) turns
//   the counts into exclusive offsets over the tiles, saves the counter's
//   value in scan[1], moves the counter on and puts the ticket back to 0.
//   Only this block writes the counter, after every block has counted.
// * refill_kernel: each block ranks its tile's dead lanes again, row by row
//   (a ballot and popc per warp, a prefix over the block's 8 warps), adds
//   scan[1] + scan[2 + tile] and refills every lane of the tile.
// A decoupled look-back would do it in one launch; two launches keep the
// code short, and on an H100 the count launch is about 0.008 ms of a
// refill's 0.06 ms at 1,048,576 lanes (PERF.md).
//
// N2b, over every lane of the sticky engine (lane l owns pixels l, l + b,
// ...; k[l] paths started of kmax[l]): a dead lane's finished path (k > 0)
// adds its radiance into its owned slot j * b + l of `acc` (j = (k - 1) /
// samples; slots are distinct, so each add is a plain load and store), its
// radiance is zeroed and, if it has paths left, it starts path k + 1 on its
// camera ray at depth 0. The plain version's index_add_ also adds 0.0 into
// a live lane's slot; a slot holds +0.0 or a sum of non-negative radiance,
// never -0.0, so that add changes no bit and the kernel leaves it out.
// Every lane's work id of its current path goes to `wid`.
//
// Arithmetic: the camera ray is common.cuh's camera_ray, ops/camera.py's
// generate_rays_u op for op; the keys and draws are the counter RNG of
// ops/rng.py; integers are int64 as in the plain versions (work ids are
// cut to their low 32 bits, as .to(torch.int32) cuts them). Build with
// --fmad=false (ops/kernels.py): the ray's products and sums round one by
// one, as PyTorch's kernels round them.
//
// What bounds them on an H100: bytes. The bound (chip_smoke.py:
// refill_bytes, restart_bytes) counts what the function must move: every
// lane's alive flag (4 B); on a dead lane its work item or k read (8 B) and
// its work id written (4 B) (a live lane's work item, k and work id stay as
// they are), its radiance zeroed (12 B) and its work item written (N2a,
// 8 B) or kmax read (N2b, 8 B); where it flushes, its radiance read (12 B)
// and written to `done` (N2a, 12 B) or added into its slot (N2b, 24 B); on a
// taken lane its ray, throughput and flag (40 B) and depth (4 B), and N2b
// its k (8 B). The kernels move more: both read every lane's work item or k
// and write every lane's work id, as the plain versions compute them, and
// N2a's count launch reads every flag again. A few hundred fp32 operations
// of the hash and the camera ray per taken lane are far below the byte time.
// What the design does about it: one thread per lane and one pass over each
// row, every access coalesced (a warp reads 32 neighbouring lanes of a row)
// but the flush, the rank from registers and a few words of shared memory.
// The flush is N2a's cost: a dead lane's three values land at its own work
// item, each a 32-byte sector written in part (read, then written), where
// the bound counts 12 B (PERF.md).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 2;  // rows of 256 lanes per tile
constexpr int kTileLanes = kThreads * kItems;  // ops/refill.py: REFILL_TILE_LANES
constexpr unsigned kFull = 0xffffffffu;

// The frame a refill or a restart reads: the camera row (ops/camera.py,
// 128 floats), the frame's size and the pass's pixels [pix_base, pix_base +
// n_pix) and samples from samp_base (bases, two int64 on the device).
struct Frame {
  const float* cam;
  const long long* bases;  // pix_base, samp_base
  long long n_pix, samples, frame_pix;
  int width, height;
};

// Path `(pixl, samp)` of the pass: its work id, and for a path that starts,
// its camera ray, unit throughput, alive flag and depth 0 in lane i. The
// divisions run on 32-bit operands, a few instructions where a 64-bit one
// is a long software routine: the launchers refuse a frame whose pixels or
// work items do not fit (ops/rng.py:check_work_ids keeps a frame's work ids
// below 2^32 already), and the quotients are the same integers.
__device__ __forceinline__ long long path_wid(const Frame& f, uint32_t pixl, uint32_t samp) {
  return (f.bases[1] + samp) * f.frame_pix + f.bases[0] + pixl;
}

__device__ __forceinline__ void start_path(const Frame& f, uint32_t seed, uint32_t pixl,
                                           long long wid, float* state, int* depth, long long b,
                                           long long i) {
  const uint32_t pixg = (uint32_t)(f.bases[0] + pixl);
  uint32_t py = pixg / (uint32_t)f.width;
  if (py > (uint32_t)f.height - 1u) py = (uint32_t)f.height - 1u;
  const uint32_t key = work_key(seed, (uint32_t)wid);
  V3 ro, rd;
  camera_ray(f.cam, (float)(pixg % (uint32_t)f.width), (float)py, f.width, f.height,
             uniform_ctr(key, CTR_JITTER), uniform_ctr(key, CTR_JITTER + 1), ro, rd);
  state[0 * b + i] = ro.x;
  state[1 * b + i] = ro.y;
  state[2 * b + i] = ro.z;
  state[3 * b + i] = rd.x;
  state[4 * b + i] = rd.y;
  state[5 * b + i] = rd.z;
  state[6 * b + i] = 1.0f;
  state[7 * b + i] = 1.0f;
  state[8 * b + i] = 1.0f;
  state[12 * b + i] = 1.0f;
  depth[i] = 0;
}

// torch: dead = state[12] < 0.5
__device__ __forceinline__ bool lane_dead(const float* state, long long b, long long i) {
  return state[12 * b + i] < 0.5f;
}

struct RefillParams {
  float* state;  // (13, b), in place
  long long* work;     // (b,) work item of each lane, -1 for none
  long long* counter;  // 0-dim: work items handed out
  float* done;         // (3, done_cols): column w holds work item w's radiance
  long long done_cols;
  int* depth;  // (b,)
  int* wid;    // (b,)
  const long long* seed_off;  // (2,): the seed (low 32 bits) and 0
  long long* scan;  // (2 + tiles,): ticket, the counter before, the tiles' offsets
  long long b, total;
  Frame f;
};

// Exclusive scan of one int64 per thread over the block; returns the
// thread's offset and leaves the block's total in *total. `warp_sum` holds
// kWarps int64 of shared memory.
__device__ __forceinline__ long long block_scan(long long v, long long* warp_sum,
                                                long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  __syncthreads();  // warp_sum is free
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  long long before = 0, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? warp_sum[w] : 0;
    all += warp_sum[w];
  }
  *total = all;
  return before + incl - v;
}

__global__ void __launch_bounds__(kThreads) refill_count_kernel(RefillParams p) {
  __shared__ long long warp_sum[kWarps];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b = p.b, t0 = (long long)blockIdx.x * kTileLanes;
  int n = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = t0 + k * kThreads + threadIdx.x;
    n += __popc(__ballot_sync(kFull, i < b && lane_dead(p.state, b, i)));
  }
  if (lane == 0) warp_sum[warp] = n;  // a warp's lanes all hold its count
  __syncthreads();
  if (threadIdx.x == 0) {
    long long s = 0;
    for (int w = 0; w < kWarps; ++w) s += warp_sum[w];
    p.scan[2 + blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(reinterpret_cast<unsigned long long*>(&p.scan[0]), 1ull) ==
           gridDim.x - 1ull;
  }
  __syncthreads();
  if (!last) return;
  // The last block: every count has been written and fenced before its
  // ticket. Thread t turns tiles [t per, (t + 1) per) into exclusive
  // offsets: their sum, a block scan of the sums, then the running offsets
  // (the loads of each pass independent of one another).
  const int tiles = gridDim.x;
  const int per = (tiles + kThreads - 1) / kThreads;
  const int first = threadIdx.x * per;
  long long sum = 0;
  for (int j = 0; j < per; ++j)
    if (first + j < tiles) sum += __ldcg(&p.scan[2 + first + j]);
  long long dead;
  long long run = block_scan(sum, warp_sum, &dead);
  for (int j = 0; j < per; ++j) {
    if (first + j >= tiles) break;
    const long long v = __ldcg(&p.scan[2 + first + j]);
    p.scan[2 + first + j] = run;
    run += v;
  }
  if (threadIdx.x == 0) {
    const long long base = *p.counter;
    const long long left = p.total - base;
    p.scan[1] = base;
    *p.counter = base + (dead < left ? dead : left);
    p.scan[0] = 0;  // the ticket, for the next launch
  }
}

__global__ void __launch_bounds__(kThreads) refill_kernel(RefillParams p) {
  __shared__ int warp_cnt[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b = p.b, t0 = (long long)blockIdx.x * kTileLanes;
  const uint32_t seed = (uint32_t)p.seed_off[0];
  long long next = p.scan[1] + p.scan[2 + blockIdx.x];  // the item of the row's first dead lane
  for (int k = 0; k < kItems; ++k) {
    const long long i = t0 + k * kThreads + threadIdx.x;
    const bool in = i < b;
    const bool dead = in && lane_dead(p.state, b, i);
    const unsigned m = __ballot_sync(kFull, dead);
    if (lane == 0) warp_cnt[warp] = __popc(m);
    __syncthreads();
    int before = 0, row = 0;
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? warp_cnt[w] : 0;
      row += warp_cnt[w];
    }
    __syncthreads();  // warp_cnt is written again for the next row
    const long long new_id = next + before + __popc(m & ((1u << lane) - 1u));
    next += row;
    if (!in) continue;
    long long w = p.work[i];
    bool take = false;
    if (dead) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (w >= 0 && w < p.total) p.done[c * p.done_cols + w] = p.state[(9 + c) * b + i];
        p.state[(9 + c) * b + i] = 0.0f;
      }
      take = new_id < p.total;
      w = take ? new_id : -1;
      p.work[i] = w;
    }
    const uint32_t wc = w > 0 ? (uint32_t)w : 0u, n_pix = (uint32_t)p.f.n_pix;
    const uint32_t pixl = wc % n_pix;
    const long long wid = path_wid(p.f, pixl, wc / n_pix);
    p.wid[i] = (int)wid;
    if (take) start_path(p.f, seed, pixl, wid, p.state, p.depth, b, i);
  }
}

struct RestartParams {
  float* state;          // (13, b), in place
  long long* k;          // (b,) paths started
  const long long* kmax;  // (b,) paths owned
  int* depth;            // (b,)
  int* wid;              // (b,)
  float* acc;            // (3, acc_cols): slot j * b + l
  long long acc_cols;
  const long long* seed_off;  // (2,): the seed (low 32 bits) and 0
  long long b;
  Frame f;
};

__global__ void __launch_bounds__(kThreads) restart_kernel(RestartParams p) {
  const long long b = p.b;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= b) return;
  const bool dead = lane_dead(p.state, b, i);
  long long k = p.k[i];
  const uint32_t samples = (uint32_t)p.f.samples;
  if (dead && k > 0) {  // a live lane's add of 0.0 leaves its slot as it is
    const long long slot = (long long)((uint32_t)(k - 1) / samples) * b + i;
#pragma unroll
    for (int c = 0; c < 3; ++c) p.acc[c * p.acc_cols + slot] += p.state[(9 + c) * b + i];
  }
  if (dead) {
#pragma unroll
    for (int c = 0; c < 3; ++c) p.state[(9 + c) * b + i] = 0.0f;
  }
  const bool take = dead && k < p.kmax[i];
  if (take) p.k[i] = ++k;
  const uint32_t cur = k > 1 ? (uint32_t)(k - 1) : 0u;
  long long pixl = i + (long long)(cur / samples) * b;
  if (pixl > p.f.n_pix - 1) pixl = p.f.n_pix - 1;
  const long long wid = path_wid(p.f, (uint32_t)pixl, cur % samples);
  p.wid[i] = (int)wid;
  if (take) start_path(p.f, (uint32_t)p.seed_off[0], pixl, wid, p.state, p.depth, b, i);
}

Frame frame_of(const void* cam, const void* bases, long long n_pix, long long samples, int width,
               int height) {
  return Frame{static_cast<const float*>(cam), static_cast<const long long*>(bases), n_pix,
               samples, (long long)width * height, width, height};
}

// What the kernels refuse: a lane count past int32, a frame whose pixels or
// the pass's work items pass 2^32 (their divisions are 32-bit).
bool bad_frame(long long b, long long n_pix, long long samples, int width, int height) {
  const long long limit = 0xffffffffLL;
  return b < 0 || b > 0x7fffffffLL || n_pix < 1 || samples < 1 || width < 1 || height < 1 ||
         n_pix * samples > limit || (long long)width * height > limit;
}

}  // namespace

// N2a. scan: (scan_len,) int64 on the device, zero on the first launch
// (the kernels leave scan[0] at zero); scan_len >= 2 + tiles. Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue for
// arguments the kernels do not take). Never synchronises.
extern "C" int rt_launch_refill(void* state, long long b, void* work, void* counter, void* done,
                                long long done_cols, void* depth, void* wid,
                                const void* seed_off, const void* cam, const void* bases,
                                long long n_pix, long long samples, int width, int height,
                                void* scan, long long scan_len, void* stream) {
  const long long tiles = (b + kTileLanes - 1) / kTileLanes;
  if (bad_frame(b, n_pix, samples, width, height) || scan_len < 2 + tiles ||
      done_cols < n_pix * samples)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  RefillParams p{};
  p.state = static_cast<float*>(state);
  p.work = static_cast<long long*>(work);
  p.counter = static_cast<long long*>(counter);
  p.done = static_cast<float*>(done);
  p.done_cols = done_cols;
  p.depth = static_cast<int*>(depth);
  p.wid = static_cast<int*>(wid);
  p.seed_off = static_cast<const long long*>(seed_off);
  p.scan = static_cast<long long*>(scan);
  p.b = b;
  p.total = n_pix * samples;
  p.f = frame_of(cam, bases, n_pix, samples, width, height);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  refill_count_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  refill_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// N2b. kmax: (b,) int64; acc: (3, acc_cols) with acc_cols >= jmax * b.
// Returns cudaGetLastError() after the launch. Never synchronises.
extern "C" int rt_launch_restart(void* state, long long b, void* k, const void* kmax, void* depth,
                                 void* wid, void* acc, long long acc_cols, const void* seed_off,
                                 const void* cam, const void* bases, long long n_pix,
                                 long long samples, int width, int height, void* stream) {
  if (bad_frame(b, n_pix, samples, width, height)) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  if (acc_cols < b * ((n_pix + b - 1) / b)) return (int)cudaErrorInvalidValue;  // jmax * b
  RestartParams p{};
  p.state = static_cast<float*>(state);
  p.k = static_cast<long long*>(k);
  p.kmax = static_cast<const long long*>(kmax);
  p.depth = static_cast<int*>(depth);
  p.wid = static_cast<int*>(wid);
  p.acc = static_cast<float*>(acc);
  p.acc_cols = acc_cols;
  p.seed_off = static_cast<const long long*>(seed_off);
  p.b = b;
  p.f = frame_of(cam, bases, n_pix, samples, width, height);
  restart_kernel<<<(unsigned)((b + kThreads - 1) / kThreads), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
