// The lane engines' refill and restart for NVIDIA Hopper (sm_90a),
// hand-written CUDA.
//
// Entry points (plain C interface, bound with ctypes by ops/kernels.py):
//   rt_launch_refill   N2a, the counter wavefront's refill: one launch;
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
// counter + rank, where rank is
// the number of dead lanes before it in lane order (the JAX cumsum), if
// that is below `total`; the counter moves on by the items handed out.
// Every lane's work id (its pixel and sample, int32) goes to `wid`, and a
// taken lane starts a path on its pixel's jittered camera ray (draws 0 and
// 1 of its key) at depth 0.
//
// The rank in lane order is the one thing that crosses lanes. N2a finds it
// in one launch with a decoupled look-back (Merrill and Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA
// 2016), written out here:
// * a block takes its tile from a ticket (scan[0], counted up and never
//   reset): tile = ticket % tiles, epoch = ticket / tiles. Every tile
//   before it has therefore started, and waiting on it cannot stall;
// * its threads load their lanes' flags and work items in one round (each
//   warp owns kItems rows of 32 neighbouring lanes), count the dead lanes
//   with ballots, and the block publishes the count in its status word
//   scan[1 + tile]: flag (aggregate or inclusive prefix), epoch and value in
//   one 64-bit word, so that value and flag become visible together;
// * warp 0 looks back over the tiles before it, 4 x 32 status words per
//   step read together (volatile loads, spinning until each holds this
//   epoch), until it meets an inclusive prefix, and publishes its own;
// * tile 0 starts from the counter: its prefix is *counter + its count. The
//   last tile writes counter = min(its inclusive prefix, total), the plain
//   version's counter += min(dead.sum(), total - counter).
// The words of the previous launch hold the previous epoch and read as not
// ready, so the scratch needs no reset between launches or graph replays.
//
// N2b, over every lane of the sticky engine (lane l owns pixels l, l + b,
// ...; k[l] paths started of kmax[l] = samples * #{j : l + j b < n_pix},
// computed from the lane index): a dead lane's finished path (k > 0) adds
// its radiance into its owned slot j * b + l of `acc` (j = (k - 1) /
// samples; slots are distinct, so each add is a plain load and store), its
// radiance is zeroed and, if it has paths left, it starts path k + 1 on its
// camera ray at depth 0. The plain version's index_add_ also adds 0.0 into
// a live lane's slot; a slot holds +0.0 or a sum of non-negative radiance,
// never -0.0, so that add changes no bit and the kernel leaves it out.
// Every lane's work id of its current path goes to `wid`. A thread loads
// its lanes' flags, k and radiance in one round; only the slots' loads
// wait on k. Above one wave of lanes (restart_whole_lanes) the rows are
// written in whole 32-byte sectors, one lane a thread: in an 8-lane group
// that holds a dead lane every lane writes its radiance (0 or its own),
// and in one that holds a restart every lane writes k, its path rows and
// its flag, a lane that keeps them having read them back beside the slot.
// Up to one wave each lane writes only what changes, two lanes a thread:
// its fewer registers keep the whole grid resident.
//
// Arithmetic: the camera ray is common.cuh's camera_ray, ops/camera.py's
// generate_rays_u op for op; the keys and draws are the counter RNG of
// ops/rng.py; work items and k are int64 as in the plain versions (work
// ids are cut to their low 32 bits, as .to(torch.int32) cuts them), lane
// indices and the divisions 32-bit (the launchers refuse what does not
// fit). Build with --fmad=false (ops/kernels.py): the ray's products and
// sums round one by one, as PyTorch's kernels round them.
//
// What bounds them on an H100: bytes. The bound (chip_smoke.py:
// refill_bytes, restart_bytes) counts what the function must move: every
// lane's alive flag (4 B); on a dead lane its work item or k read (8 B) and
// its work id written (4 B) (a live lane's work item, k and work id stay as
// they are), its radiance zeroed (12 B) and its work item written (N2a,
// 8 B); where it flushes, its radiance read (12 B) and written to `done`
// (N2a, 12 B) or added into its slot (N2b, 24 B); on a taken lane its ray,
// throughput and flag (40 B) and depth (4 B), and N2b its k (8 B). The
// kernels move more: both read every lane's work item or k and write every
// lane's work id, as the plain versions compute them. Above all, a row
// written only on the lanes that restart is written in part in nearly
// every 32-byte sector (about two thirds of the lanes restart, beside live
// ones), and the card reads such a sector before it writes it: N2a's ten
// path rows cost about twice their bytes. On a large state N2b writes whole
// sectors and reads back what the live lanes keep, which is faster
// (kernel_times.py --sector-writes); in N2a the kept rows would have to be
// held in registers across the rank and the look-back, and the lost
// occupancy cost more than the sectors saved (PERF.md). A few hundred
// fp32 operations of the hash and the camera ray per taken lane are far
// below the byte time. What the design does about it: every access
// coalesced (a warp reads 32 neighbouring lanes of a row) but the flush,
// whose three values land at the lane's own work item (a 16-byte record
// per item made that one store and cost the frame's final sum a transpose:
// not kept, PERF.md); each thread's loads in one round; one launch; the
// rank from registers and a few words of shared memory.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                      // rows of 32 lanes per warp of N2a
constexpr int kTileLanes = kThreads * kItems;  // ops/refill.py: REFILL_TILE_LANES
constexpr int kWholeLanes = 1;                 // N2b: lanes per thread, whole sectors
constexpr int kPartLanes = 2;                  // N2b: lanes per thread, sectors in part
constexpr int kLook = 4;                       // look-back: windows of 32 tiles per step
constexpr int kCamFloats = 16;                 // camera_ray reads the row's first 14
constexpr unsigned kFull = 0xffffffffu;

// A tile's status word: flag (2 bits) | epoch (28 bits) | value (34 bits).
// A value is at most total + b < 2^33; a word of another epoch is not ready.
constexpr int kValueBits = 34;
constexpr unsigned long long kValueMask = (1ull << kValueBits) - 1ull;
constexpr unsigned long long kEpochMask = (1ull << 28) - 1ull;
constexpr unsigned long long kAggregate = 1ull << 62, kInclusive = 2ull << 62;

__device__ __forceinline__ unsigned long long status_word(unsigned long long flag,
                                                          unsigned long long epoch,
                                                          long long value) {
  return flag | ((epoch & kEpochMask) << kValueBits) | ((unsigned long long)value & kValueMask);
}

__device__ __forceinline__ bool status_ready(unsigned long long s, unsigned long long epoch) {
  return (s >> 62) != 0ull && ((s >> kValueBits) & kEpochMask) == (epoch & kEpochMask);
}

// The frame a refill or a restart reads: the camera row (ops/camera.py,
// 128 floats), the frame's size and the pass's pixels [pix_base, pix_base +
// n_pix) and samples from samp_base (bases, two int64 on the device).
struct Frame {
  const float* cam;
  const long long* bases;  // pix_base, samp_base
  long long n_pix, samples, frame_pix;
  int width, height;
};

// What every thread reads of the frame once: the bases and the seed. (N2a
// also stages the camera's first kCamFloats floats in shared memory; N2b,
// which has no barrier to wait at, reads them through the cache.)
struct FrameRegs {
  long long pix_base, samp_base;
  uint32_t seed;
};

__device__ __forceinline__ FrameRegs load_frame(const Frame& f, const long long* seed_off) {
  return FrameRegs{__ldg(f.bases), __ldg(f.bases + 1), (uint32_t)__ldg(seed_off)};
}

// Path `(pixl, samp)` of the pass: its work id. The divisions here and in
// the kernels run on 32-bit operands, a few instructions where a 64-bit one
// is a long software routine: the launchers refuse a frame whose pixels or
// work items do not fit (ops/rng.py:check_work_ids keeps a frame's work ids
// below 2^32 already), and the quotients are the same integers.
__device__ __forceinline__ long long path_wid(const Frame& f, const FrameRegs& r, uint32_t pixl,
                                              uint32_t samp) {
  return (r.samp_base + samp) * f.frame_pix + r.pix_base + pixl;
}

// Lane `lane`'s 8-lane group in `m` (a warp's ballot) holds a set bit: its
// 32-byte sector of a row has a writer. Where one does, every lane of the
// group writes the row, its own value where it keeps it, so that the
// sector is written whole: a sector written in part is read from device
// memory first, and on an H100 that costs more than reading the kept
// values back in the kernel (kernel_times.py --sector-writes; PERF.md).
__device__ __forceinline__ bool sector_has(unsigned m, int lane) {
  return ((m >> (lane & 24)) & 0xffu) != 0u;
}

// The rows of a lane's path that a start sets: ray (ro3, rd3), throughput
// and depth.
struct PathRows {
  float v[9];
  int depth;
};

__device__ __forceinline__ void load_path(const float* state, const int* depth, size_t b,
                                          uint32_t i, bool on, PathRows& r) {
#pragma unroll
  for (int c = 0; c < 9; ++c) r.v[c] = on ? state[c * b + i] : 0.0f;
  r.depth = on ? depth[i] : 0;
}

// A path that starts: its camera ray, unit throughput and depth 0.
__device__ __forceinline__ void start_rows(const Frame& f, const FrameRegs& r, const float* cam,
                                           uint32_t pixl, long long wid, PathRows& out) {
  const uint32_t pixg = (uint32_t)(r.pix_base + pixl);
  uint32_t py = pixg / (uint32_t)f.width;
  if (py > (uint32_t)f.height - 1u) py = (uint32_t)f.height - 1u;
  const uint32_t key = work_key(r.seed, (uint32_t)wid);
  V3 ro, rd;
  camera_ray(cam, (float)(pixg % (uint32_t)f.width), (float)py, f.width, f.height,
             uniform_ctr(key, CTR_JITTER), uniform_ctr(key, CTR_JITTER + 1), ro, rd);
  out.v[0] = ro.x;
  out.v[1] = ro.y;
  out.v[2] = ro.z;
  out.v[3] = rd.x;
  out.v[4] = rd.y;
  out.v[5] = rd.z;
  out.v[6] = out.v[7] = out.v[8] = 1.0f;
  out.depth = 0;
}

__device__ __forceinline__ void store_path(float* state, int* depth, size_t b, uint32_t i,
                                           const PathRows& r, float alive) {
#pragma unroll
  for (int c = 0; c < 9; ++c) state[c * b + i] = r.v[c];
  state[12 * b + i] = alive;
  depth[i] = r.depth;
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Warp 0 of tile `tile` > 0: the dead lanes of tiles [0, tile) plus the
// counter, from their status words. Every lane reads kLook words per step,
// the nearest first (word q = 32 m + lane is tile end - 1 - q); a step ends
// at the nearest inclusive prefix, or sums all its aggregates and goes on.
__device__ long long look_back(const unsigned long long* status, int tile,
                               unsigned long long epoch) {
  const int lane = threadIdx.x & 31;
  long long excl = 0;
  for (int end = tile;; end -= 32 * kLook) {
    unsigned long long s[kLook];
    bool ready[kLook];
#pragma unroll
    for (int m = 0; m < kLook; ++m) ready[m] = false;
    for (;;) {
      bool all = true;
#pragma unroll
      for (int m = 0; m < kLook; ++m) {
        if (ready[m]) continue;
        const int t = end - 1 - lane - 32 * m;
        // past tile 0 nothing is summed (tile 0 is an inclusive prefix)
        s[m] = t >= 0 ? *reinterpret_cast<const volatile unsigned long long*>(status + t)
                      : kInclusive;
        ready[m] = t < 0 || status_ready(s[m], epoch);
        all = all && ready[m];
      }
      if (__all_sync(kFull, all)) break;
    }
    int hit = 32 * kLook;  // the nearest inclusive prefix, as q
#pragma unroll
    for (int m = kLook - 1; m >= 0; --m) {
      const unsigned found = __ballot_sync(kFull, (s[m] >> 62) == (kInclusive >> 62));
      if (found) hit = 32 * m + __ffs(found) - 1;
    }
    long long part = 0;
#pragma unroll
    for (int m = 0; m < kLook; ++m)
      if (32 * m + lane <= hit) part += (long long)(s[m] & kValueMask);
    excl += warp_sum(part);
    if (hit < 32 * kLook) return excl;
  }
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
  unsigned long long* scan;  // (1 + tiles,): the ticket, the tiles' status words
  long long b, total;
  Frame f;
};

__global__ void __launch_bounds__(kThreads) refill_kernel(RefillParams p) {
  __shared__ float cam[kCamFloats];
  __shared__ int warp_cnt[kWarps];
  __shared__ unsigned long long ticket_s;
  __shared__ long long tile_base;  // the counter plus the dead lanes before the tile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) ticket_s = atomicAdd(p.scan, 1ull);
  if (threadIdx.x < kCamFloats) cam[threadIdx.x] = __ldg(p.f.cam + threadIdx.x);
  const FrameRegs fr = load_frame(p.f, p.seed_off);
  __syncthreads();
  const unsigned long long ticket = ticket_s;
  const int tiles = (int)gridDim.x;
  const int tile = (int)(ticket % (unsigned long long)tiles);
  const unsigned long long epoch = ticket / (unsigned long long)tiles;
  const size_t b = (size_t)p.b;
  const uint32_t i0 = (uint32_t)tile * kTileLanes + (uint32_t)warp * (32 * kItems) + lane;
  long long counter0 = 0;
  if (tile == 0 && threadIdx.x == 0) counter0 = *p.counter;

  // one round of loads: flags and work items, then a flushing lane's radiance
  float alive[kItems];
  long long w[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const uint32_t i = i0 + 32 * k;
    alive[k] = i < b ? p.state[12 * b + i] : 1.0f;
    w[k] = i < b ? p.work[i] : -1;
  }
  unsigned dead_m[kItems];
  int n = 0;
  float rad[kItems][3];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const uint32_t i = i0 + 32 * k;
    const bool dead = alive[k] < 0.5f;  // torch: state[12] < 0.5
    dead_m[k] = __ballot_sync(kFull, dead);
    n += __popc(dead_m[k]);
    const bool flush = dead && w[k] >= 0 && w[k] < p.total;
#pragma unroll
    for (int c = 0; c < 3; ++c) rad[k][c] = flush ? p.state[(9 + c) * b + i] : 0.0f;
  }
  if (lane == 0) warp_cnt[warp] = n;
  __syncthreads();
  if (warp == 0) {
    const long long agg = warp_sum(lane < kWarps ? warp_cnt[lane] : 0);
    unsigned long long* status = p.scan + 1;
    long long excl = counter0;
    if (tile > 0) {
      if (lane == 0)
        *reinterpret_cast<volatile unsigned long long*>(status + tile) =
            status_word(kAggregate, epoch, agg);
      excl = look_back(status, tile, epoch);
    }
    if (lane == 0) {
      *reinterpret_cast<volatile unsigned long long*>(status + tile) =
          status_word(kInclusive, epoch, excl + agg);
      tile_base = excl;
      if (tile == tiles - 1) *p.counter = min(excl + agg, p.total);
    }
  }
  long long next = 0;  // dead lanes of the warps before this one
  for (int v = 0; v < warp; ++v) next += warp_cnt[v];
  __syncthreads();
  next += tile_base;

  // the writes: each lane its own (a live lane's rows stay as they are; the
  // path rows of the lanes that start are written in part: whole sectors
  // would need the live lanes' rows read back and held, and the registers
  // that takes cost more than the sectors save, PERF.md)
  const uint32_t n_pix = (uint32_t)p.f.n_pix;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const uint32_t i = i0 + 32 * k;
    const long long new_id = next + __popc(dead_m[k] & below);
    next += __popc(dead_m[k]);
    if (i >= b) continue;
    long long wk = w[k];
    bool take = false;
    if ((dead_m[k] >> lane) & 1u) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (wk >= 0 && wk < p.total) p.done[c * p.done_cols + wk] = rad[k][c];
        p.state[(9 + c) * b + i] = 0.0f;
      }
      take = new_id < p.total;
      wk = take ? new_id : -1;
      p.work[i] = wk;
    }
    const uint32_t wc = wk > 0 ? (uint32_t)wk : 0u;
    const uint32_t pixl = wc % n_pix;
    const long long wid = path_wid(p.f, fr, pixl, wc / n_pix);
    p.wid[i] = (int)wid;
    if (take) {
      PathRows out;
      start_rows(p.f, fr, cam, pixl, wid, out);
      store_path(p.state, p.depth, b, i, out, 1.0f);
    }
  }
}

struct RestartParams {
  float* state;          // (13, b), in place
  long long* k;          // (b,) paths started
  int* depth;            // (b,)
  int* wid;              // (b,)
  float* acc;            // (3, acc_cols): slot j * b + l
  long long acc_cols;
  const long long* seed_off;  // (2,): the seed (low 32 bits) and 0
  long long b;
  Frame f;
};

// A lane writes a row where `m` (a warp's ballot of the lanes that change
// it) holds its sector (kWhole: whole sectors) or its own bit.
template <bool kWhole>
__device__ __forceinline__ bool writes(unsigned m, int lane) {
  return kWhole ? sector_has(m, lane) : ((m >> lane) & 1u) != 0u;
}

// kLanes rows of 32 lanes per warp. kWhole: the rows are written in whole
// sectors, the values a lane keeps read back in the second round.
template <bool kWhole, int kLanes>
__global__ void __launch_bounds__(kThreads) restart_kernel(RestartParams p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t b = (size_t)p.b;
  const uint32_t i0 =
      blockIdx.x * (kThreads * kLanes) + (uint32_t)warp * (32 * kLanes) + lane;
  const FrameRegs fr = load_frame(p.f, p.seed_off);
  const uint32_t samples = (uint32_t)p.f.samples, n_pix = (uint32_t)p.f.n_pix;
  // one round of loads: flag, k and radiance (whole sectors: of every lane,
  // for the rows it writes back; in part: of a dead lane only, which waits
  // on its flag, as the slot waits on k)
  float alive[kLanes], rad[kLanes][3];
  long long k[kLanes];
#pragma unroll
  for (int r = 0; r < kLanes; ++r) {
    const uint32_t i = i0 + 32 * r;
    const bool in = i < b;
    alive[r] = in ? p.state[12 * b + i] : 1.0f;
    k[r] = in ? p.k[i] : 0;
    const bool need = in && (kWhole || alive[r] < 0.5f);
#pragma unroll
    for (int c = 0; c < 3; ++c) rad[r][c] = need ? p.state[(9 + c) * b + i] : 0.0f;
  }
  // who restarts: kmax is samples x the owned pixels l + j b < n_pix
  // (ops/refill.py: sticky_kmax); then the second round: the slots that
  // finished paths add into, and the path rows of the lanes that keep
  // theirs in a sector where a lane restarts
  unsigned dead_m[kLanes], take_m[kLanes];
  float slot_v[kLanes][3];
  size_t slot[kLanes];
  PathRows keep[kLanes];
#pragma unroll
  for (int r = 0; r < kLanes; ++r) {
    const uint32_t i = i0 + 32 * r;
    const bool dead = alive[r] < 0.5f;
    const long long kmax =
        i < n_pix ? (long long)((n_pix - 1u - i) / (uint32_t)b + 1u) * samples : 0ll;
    const bool take = dead && k[r] < kmax;
    dead_m[r] = __ballot_sync(kFull, dead);
    take_m[r] = __ballot_sync(kFull, take);
    const bool flush = dead && k[r] > 0;  // a live lane's add of 0.0 is left out
    slot[r] = (size_t)((uint32_t)(k[r] - 1) / samples) * b + i;
#pragma unroll
    for (int c = 0; c < 3; ++c) slot_v[r][c] = flush ? p.acc[c * p.acc_cols + slot[r]] : 0.0f;
    load_path(p.state, p.depth, b, i, kWhole && i < b && !take && sector_has(take_m[r], lane),
              keep[r]);
  }
#pragma unroll
  for (int r = 0; r < kLanes; ++r) {
    const uint32_t i = i0 + 32 * r;
    if (i >= b) continue;
    const bool dead = (dead_m[r] >> lane) & 1u, take = (take_m[r] >> lane) & 1u;
    long long kk = k[r];
    if (dead && kk > 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) p.acc[c * p.acc_cols + slot[r]] = slot_v[r][c] + rad[r][c];
    }
    if (writes<kWhole>(dead_m[r], lane)) {
#pragma unroll
      for (int c = 0; c < 3; ++c) p.state[(9 + c) * b + i] = dead ? 0.0f : rad[r][c];
    }
    if (take) ++kk;
    if (writes<kWhole>(take_m[r], lane)) p.k[i] = kk;
    const uint32_t cur = kk > 1 ? (uint32_t)(kk - 1) : 0u;
    long long pixl = i + (long long)(cur / samples) * (long long)b;
    if (pixl > p.f.n_pix - 1) pixl = p.f.n_pix - 1;
    const long long wid = path_wid(p.f, fr, (uint32_t)pixl, cur % samples);
    p.wid[i] = (int)wid;
    if (writes<kWhole>(take_m[r], lane)) {
      PathRows out = keep[r];
      if (take) start_rows(p.f, fr, p.f.cam, (uint32_t)pixl, wid, out);
      store_path(p.state, p.depth, b, i, out, take ? 1.0f : alive[r]);
    }
  }
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

// The lanes above which N2b writes whole sectors: what its part-sector
// kernel holds resident at once on the current device (SMs x resident
// blocks x lanes per block; asked at every launch, no device work). Up to
// that the part-sector kernel finishes in one wave, and its lower register
// count is worth more than whole sectors; above it the lanes run in waves
// anyway and the sectors' bytes set the time (PERF.md).
long long restart_whole_lanes() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, restart_kernel<false, kPartLanes>,
                                                kThreads, 0);
  return (long long)sms * per_sm * kThreads * kPartLanes;
}

}  // namespace

// N2a. done: (3, done_cols) f32, done_cols >= n_pix * samples; scan:
// (scan_len,) int64 on the device, scan_len >= 1 + tiles (the ticket and
// one status word per tile), zero before its first launch and used by
// launches on b lanes only (the launch leaves it ready for the next).
// *counter must lie in [0, total]. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for arguments the kernel does not take).
// Never synchronises.
extern "C" int rt_launch_refill(void* state, long long b, void* work, void* counter, void* done,
                                long long done_cols, void* depth, void* wid,
                                const void* seed_off, const void* cam, const void* bases,
                                long long n_pix, long long samples, int width, int height,
                                void* scan, long long scan_len, void* stream) {
  const long long tiles = (b + kTileLanes - 1) / kTileLanes;
  if (bad_frame(b, n_pix, samples, width, height) || scan_len < 1 + tiles ||
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
  p.scan = static_cast<unsigned long long*>(scan);
  p.b = b;
  p.total = n_pix * samples;
  p.f = frame_of(cam, bases, n_pix, samples, width, height);
  refill_kernel<<<(unsigned)tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// N2b. acc: (3, acc_cols) with acc_cols >= jmax * b. Each lane's kmax is
// computed from its index; whole sectors above restart_whole_lanes()
// lanes. Returns cudaGetLastError() after the launch. Never synchronises.
extern "C" int rt_launch_restart(void* state, long long b, void* k, void* depth, void* wid,
                                 void* acc, long long acc_cols, const void* seed_off,
                                 const void* cam, const void* bases, long long n_pix,
                                 long long samples, int width, int height, void* stream) {
  if (bad_frame(b, n_pix, samples, width, height)) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  if (acc_cols < b * ((n_pix + b - 1) / b)) return (int)cudaErrorInvalidValue;  // jmax * b
  RestartParams p{};
  p.state = static_cast<float*>(state);
  p.k = static_cast<long long*>(k);
  p.depth = static_cast<int*>(depth);
  p.wid = static_cast<int*>(wid);
  p.acc = static_cast<float*>(acc);
  p.acc_cols = acc_cols;
  p.seed_off = static_cast<const long long*>(seed_off);
  p.b = b;
  p.f = frame_of(cam, bases, n_pix, samples, width, height);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool whole = b > restart_whole_lanes();
  const long long lanes = (long long)kThreads * (whole ? kWholeLanes : kPartLanes);
  const unsigned blocks = (unsigned)((b + lanes - 1) / lanes);
  if (whole)
    restart_kernel<true, kWholeLanes><<<blocks, kThreads, 0, s>>>(p);
  else
    restart_kernel<false, kPartLanes><<<blocks, kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// launch_geometry: the lanes above which N2b writes whole sectors.
extern "C" long long rt_restart_whole_lanes() { return restart_whole_lanes(); }
