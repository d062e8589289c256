// The lane loops' control on the device for NVIDIA Hopper (sm_90a),
// hand-written CUDA.
//
// Entry points (plain C interface, bound with ctypes by ops/kernels.py):
//   rt_launch_round_tail  N5: the tail of a lane round and the loop test,
//                     one launch.
//   rt_if_begin / rt_if_end  an IF node of a CUDA graph under capture: the
//                     work captured between the two runs at replay only when
//                     a 0-dim bool on the device is then true.
//
// No Pallas kernel computes N5. The JAX package runs each lane frame as one
// lax.while_loop under jax.jit (raytracing_course_2024_tpu/integrator/
// wavefront.py:355, :539, :607). The end of its loop body -- the fused
// core's final-depth cap and the parking of the rays of the lanes it leaves
// dead (:141-142, `park` :122-127), the depth step (:291, :513) -- and the
// loop test `cond` (:300, :516, :593), the bounce's path-vertex sum
// (:280-281, :528) and the counter refill's predicate, a lax.cond
// (:311-316), are element-wise work and reductions over the lanes that XLA
// fuses inside the loop, so the loop never leaves the device. Here they are
// one launch per round, whose outputs the IF nodes of the next round read
// (runtime/graphs.py:guard); the host reads the counters only once per
// replay of several rounds. The plain PyTorch version is
// ops/loop.py:round_tail_plain (ops/shade.py:park, the depth step,
// round_test_plain); the tail moves values and counts integers, so the two
// agree exactly.
//
// Tails (`tail`), what a launch does to the lanes before the test:
//   0, none: nothing (the test before a loop's first round);
//   1, depth: depth += 1 on every lane (after the modular core, whose N1a
//      applies the final-depth rule and whose N1b parks);
//   2, fused: after K1 in lane mode, cont = alive > 0.5 && depth < last;
//      alive = cont as f32; the rays of the lanes without cont parked
//      (PARK_ORIGIN in rows 0-2, PARK_DIR in rows 3-5, ops/shade.py);
//      depth += 1.
// Modes (`mode`) of the test, on the alive row the tail leaves:
//   0, the counter wavefront: n = lanes alive; more = counter < total or
//      n > 0; refill = more and lanes - n >= thresh (the refill of the next
//      round); the lanes that enter the next bounce, n plus what the refill
//      hands out, min(lanes - n, total - counter), go to the path vertices;
//   1, the sticky engine: n = lanes alive or with paths left (k < kmax:
//      kmax is samples x the pixels l + j b < n_pix that lane l owns,
//      computed from the lane index as N2b does, or read from memory where
//      the caller gives it); more = n > 0, and the n lanes enter the next
//      bounce.
// Both write the counters and the IF nodes' predicates as loop.cuh's
// write_round does. The sticky engine's K5 loop needs no pass of its own:
// K5's last block ends its round with the same test (persistent.cu).
//
// What bounds N5 on an H100: bytes, and at these sizes the latency of one
// launch as much. The fused tail on 1,048,576 lanes reads the alive and
// depth rows and writes depth back (12 B a lane), writes alive where it
// changes and parks every lane left dead: about 18-20 MB, 6 us at 3.35 TB/s;
// the test alone reads 4 B a lane (1.25 us). What a launch costs beyond its
// bytes is its chain of dependent memory trips: the lanes' loads, the
// block's count, the grid's count, the counters' writes. The design:
// * a thread takes 4 consecutive lanes and starts every load of the pass
//   before it uses one: alive as float4, depth as int4 (scalar only for a
//   ragged last group or a row that is not 16 B aligned);
// * 16 B stores of alive (where a lane of the group changes) and depth;
//   the rays of the lanes that park, and k of a dead lane in sticky mode,
//   by the warp's threads in turn, lane l of the warp's 128 by thread
//   l % 32 (the owners' flags passed by ballots), so that each store and
//   load instruction covers 32 consecutive lanes (whole 128 B lines where
//   every lane of them parks); k is read only where a lane is dead. A
//   lane that entered the round dead is parked already (K1 in place writes
//   a dead lane's rays through unchanged, bounce.cu:pass_dead), but telling
//   it apart costs a read of origin x on every lane: measured slower in
//   the middle of a frame, where no lane enters dead (PERF.md);
// * one wave of 256-thread blocks sized from the lanes, at most what the
//   SMs hold resident; a block sums its count with warp shuffles and shared
//   memory and adds it, with a ticket in its high bits, into one word by
//   one atomic; the block that takes the last ticket has the grid's count
//   in what the atomic returns, writes the counters and the IF predicates
//   from the work counter and the counters it read at its start, and sets
//   the word back to 0 for the next launch (no zeroing launch, no sync, no
//   fence).

#include <cuda_runtime.h>
#include <stdint.h>

#include "loop.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 1;             // 4-lane groups a thread takes per pass
constexpr int kLanes = 4 * kGroups;    // lanes a thread takes per pass (divides 32)
constexpr int kWarpLanes = 32 * kLanes;
constexpr int kWord = 2;               // scratch[2]: the grid's count and ticket, 0 between
                                       // launches
constexpr int kTicketShift = 40;       // the ticket's bits in the word; the count below them
constexpr float kParkOrigin = 1.0e30f;               // ops/shade.py:PARK_ORIGIN
constexpr float kParkDir = 0.5773502691896258f;      // ops/shade.py:PARK_DIR
constexpr unsigned kFull = 0xffffffffu;
enum { kCounter = 0, kSticky = 1 };
enum { kTailNone = 0, kTailDepth = 1, kTailFused = 2 };

struct TailParams {
  float* rows;               // fused: the (13, b) state (rows 0-5 the ray, 12 alive)
  float* alive;              // the alive row (rows + 12 b with a state)
  int* depth;                // tails depth and fused: (b,) int32
  const long long* k;        // sticky: (b,) paths started per lane
  const long long* kmax;     // sticky: (b,) paths per lane, or nullptr: from the index
  long long b;
  uint32_t n_pix, samples;   // sticky without kmax: the frame
  int last;                  // fused: the final depth
  const long long* counter;  // counter: the work items handed out
  long long total, thresh;   // counter: work items, the refill threshold
  LoopOut out;
  bool vec;                  // alive and depth 16 B aligned
};

// The counters read at a launch's start, for the last block's writes.
struct Was {
  long long counter, verts, rounds, refills;
};

// Thread 0 of the last block: the round's test on the grid's count n, the
// counters and the IF predicates written as loop.cuh:write_round writes them.
template <int MODE>
__device__ void finish(const TailParams& p, long long n, const Was& was) {
  bool more, refill = false;
  long long verts = n;
  if (MODE == kCounter) {
    const long long dead = p.b - n, left = p.total - was.counter;
    more = was.counter < p.total || n > 0;
    refill = more && dead >= p.thresh;
    verts = more ? n + (refill ? (dead < left ? dead : left) : 0) : 0;
  } else {
    more = n > 0;
  }
  long long* loop = p.out.loop;
  loop[0] = n;
  loop[1] = more;
  loop[2] = refill;
  loop[3] = was.verts + verts;
  loop[4] = was.rounds + more;
  loop[5] = was.refills + refill;
  p.out.preds[0] = more;
  p.out.preds[1] = refill;
}

// Sticky: the paths lane i owns, samples x its pixels i + j b < n_pix
// (ops/refill.py:sticky_kmax, as N2b computes it).
__device__ __forceinline__ long long kmax_of(const TailParams& p, long long i) {
  return i < p.n_pix
             ? (long long)(((uint32_t)p.n_pix - 1u - (uint32_t)i) / (uint32_t)p.b + 1u) *
                   p.samples
             : 0ll;
}

// Lanes i..i+3 of a row into v (lanes past b read as 0): one 16 B load where
// the row is aligned and the group whole, else lane by lane.
template <typename T, typename T4>
__device__ __forceinline__ void load4(const T* x, long long i, long long b, bool vec, T* v) {
  if (vec && i + 4 <= b) {
    const T4 q = *reinterpret_cast<const T4*>(x + i);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = i + j < b ? x[i + j] : T(0);
}

template <typename T, typename T4>
__device__ __forceinline__ void store4(T* x, long long i, long long b, bool vec, const T* v) {
  if (vec && i + 4 <= b) {
    T4 q;
    q.x = v[0], q.y = v[1], q.z = v[2], q.w = v[3];
    *reinterpret_cast<T4*>(x + i) = q;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (i + j < b) x[i + j] = v[j];
}

// Every thread of a block: the block's sum of v, in thread 0.
__device__ __forceinline__ long long block_sum(long long v, long long* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  long long t = 0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) t += red[w];
  }
  return t;
}

// The owners' flags of the lanes thread `t` of a warp takes in turn, lanes
// t, t + 32, ...: bit q of the result for lane t + 32 q, from ballots[j]
// (bit o: lane j of the thread o).
__device__ __forceinline__ unsigned turn_bits(const unsigned* ballots, int t) {
  unsigned mine = 0;
#pragma unroll
  for (int j = 0; j < kLanes; ++j)
    if (j == t % kLanes) mine = ballots[j];
  unsigned bits = 0;
#pragma unroll
  for (int q = 0; q < kLanes; ++q) bits |= ((mine >> (t / kLanes + q * (32 / kLanes))) & 1u) << q;
  return bits;
}

template <int MODE, int TAIL>
__global__ void __launch_bounds__(kThreads) round_tail_kernel(TailParams p) {
  __shared__ long long red[kThreads / 32];
  const long long b = p.b;
  const int t = threadIdx.x & 31;
  Was was{};
  if (threadIdx.x == 0) {  // for the last block's writes, read while the lanes load
    if (MODE == kCounter) was.counter = *p.counter;
    was.verts = p.out.loop[3];
    was.rounds = p.out.loop[4];
    was.refills = p.out.loop[5];
  }
  long long n = 0;
  const long long warps = (long long)gridDim.x * (kThreads / 32);
  for (long long w0 = ((long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * kWarpLanes;
       w0 < b; w0 += warps * kWarpLanes) {
    const long long i0 = w0 + (long long)t * kLanes;  // the thread's own lanes
    float a[kLanes];
    int d[kLanes];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      load4<float, float4>(p.alive, i0 + 4 * g, b, p.vec, a + 4 * g);
      if (TAIL != kTailNone) load4<int, int4>(p.depth, i0 + 4 * g, b, p.vec, d + 4 * g);
    }
    bool on[kLanes];
    unsigned park_b[kLanes], ask_b[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const bool in = i0 + j < b;
      const bool cont = a[j] > 0.5f && (TAIL != kTailFused || d[j] < p.last);
      on[j] = in && cont;
      n += on[j];
      park_b[j] = __ballot_sync(kFull, TAIL == kTailFused && in && !cont);
      ask_b[j] = __ballot_sync(kFull, MODE == kSticky && in && !cont);
    }
    if (TAIL == kTailFused) {
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        float na[4];
        bool changed = false;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          na[j] = on[4 * g + j] ? 1.0f : 0.0f;
          changed |= i0 + 4 * g + j < b &&
                     __float_as_uint(na[j]) != __float_as_uint(a[4 * g + j]);
        }
        if (changed) store4<float, float4>(p.alive, i0 + 4 * g, b, p.vec, na);
      }
    }
    if (TAIL != kTailNone) {
#pragma unroll
      for (int j = 0; j < kLanes; ++j) d[j] += 1;
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
        store4<int, int4>(p.depth, i0 + 4 * g, b, p.vec, d + 4 * g);
    }
    // the warp's lanes in turn: lane w0 + t + 32 q
    if (TAIL == kTailFused) {
      const unsigned park = turn_bits(park_b, t);
#pragma unroll
      for (int q = 0; q < kLanes; ++q) {
        if (!((park >> q) & 1u)) continue;
        const long long i = w0 + t + 32 * q;
#pragma unroll
        for (int r = 0; r < 6; ++r) p.rows[r * b + i] = r < 3 ? kParkOrigin : kParkDir;
      }
    }
    if (MODE == kSticky) {
      const unsigned ask = turn_bits(ask_b, t);
      long long kk[kLanes], km[kLanes];
#pragma unroll
      for (int q = 0; q < kLanes; ++q) {
        const long long i = w0 + t + 32 * q;
        const bool on_q = (ask >> q) & 1u;
        kk[q] = on_q ? __ldg(p.k + i) : 0;
        km[q] = on_q && p.kmax != nullptr ? __ldg(p.kmax + i) : 0;
      }
#pragma unroll
      for (int q = 0; q < kLanes; ++q)
        if ((ask >> q) & 1u)
          n += kk[q] < (p.kmax != nullptr ? km[q] : kmax_of(p, w0 + t + 32 * q));
    }
  }
  const long long count = block_sum(n, red);
  if (threadIdx.x != 0) return;
  const unsigned long long mine = (1ull << kTicketShift) | (unsigned long long)count;
  const unsigned long long before = atomicAdd(&p.out.scratch[kWord], mine);
  if ((before >> kTicketShift) != gridDim.x - 1) return;
  p.out.scratch[kWord] = 0;
  finish<MODE>(p, (long long)((before + mine) & ((1ull << kTicketShift) - 1)), was);
}

// Sets an IF node's condition from a bool on the device, inside the graph.
__global__ void set_condition_kernel(cudaGraphConditionalHandle h, const bool* pred) {
  cudaGraphSetConditional(h, *pred ? 1u : 0u);
}

template <int MODE, int TAIL>
int launch(const TailParams& p, cudaStream_t stream) {
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, round_tail_kernel<MODE, TAIL>,
                                                kThreads, 0);
  const long long per_block = (long long)kThreads * kLanes;
  long long blocks = (p.b + per_block - 1) / per_block;
  const long long held = (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  if (blocks > held) blocks = held;
  if (blocks < 1) blocks = 1;
  round_tail_kernel<MODE, TAIL><<<(unsigned)blocks, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

bool aligned(const void* x) { return (reinterpret_cast<uintptr_t>(x) & 15u) == 0; }

}  // namespace

// N5. rows: the (13, b) f32 state (tail fused; else nullptr), alive its row
// 12 or a (b,) f32 row; depth (b,) int32 (tails depth and fused); mode 0:
// counter one int64, total, thresh; mode 1: k (b,) int64 and kmax (b,) int64
// or nullptr (then from the lane index, n_pix and samples). loop (6,)
// int64, preds (2,) bool, scratch (3,) int64 at 0 (N5 takes scratch[2]).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take). Never synchronises.
extern "C" int rt_launch_round_tail(int mode, int tail, void* rows, void* alive, void* depth,
                                    const void* k, const void* kmax, long long b,
                                    long long n_pix, long long samples, int last,
                                    const void* counter, long long total, long long thresh,
                                    void* loop, void* preds, void* scratch, void* stream) {
  const long long u32 = 1ll << 32;
  if (mode < 0 || mode > 1 || tail < 0 || tail > 2 || b < 0 || b >= u32 ||
      (b > 0 && alive == nullptr) || (b > 0 && tail > 0 && depth == nullptr) ||
      (tail == 2 && (rows == nullptr || alive != static_cast<float*>(rows) + 12 * b)) ||
      (mode == 0 && counter == nullptr) || (mode == 1 && b > 0 && k == nullptr) ||
      (mode == 1 && kmax == nullptr && (n_pix < 0 || n_pix >= u32 || samples < 0 ||
                                        samples >= u32)))
    return (int)cudaErrorInvalidValue;
  TailParams p{};
  p.rows = static_cast<float*>(rows);
  p.alive = static_cast<float*>(alive);
  p.depth = static_cast<int*>(depth);
  p.k = static_cast<const long long*>(k);
  p.kmax = static_cast<const long long*>(kmax);
  p.b = b;
  p.n_pix = (uint32_t)(mode == 1 ? n_pix : 0);
  p.samples = (uint32_t)(mode == 1 ? samples : 0);
  p.last = last;
  p.counter = static_cast<const long long*>(counter);
  p.total = total;
  p.thresh = thresh;
  p.out = LoopOut{static_cast<long long*>(loop), static_cast<bool*>(preds),
                  static_cast<unsigned long long*>(scratch)};
  p.vec = aligned(alive) && (tail == 0 || aligned(depth));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode * 3 + tail) {
    case 0: return launch<kCounter, kTailNone>(p, s);
    case 1: return launch<kCounter, kTailDepth>(p, s);
    case 2: return launch<kCounter, kTailFused>(p, s);
    case 3: return launch<kSticky, kTailNone>(p, s);
    case 4: return launch<kSticky, kTailDepth>(p, s);
    default: return launch<kSticky, kTailFused>(p, s);
  }
}

// Opens an IF node on `parent`, a stream under capture: a handle, a kernel
// that sets it from `pred` (one bool on the device, read when the graph
// reaches it), the conditional node after the stream's current nodes, the
// stream's next nodes after it; then `child` captures into the node's body
// graph until rt_if_end. The same steps as PyTorch's own
// CUDAGraph::begin_capture_to_if_node, which the card's PyTorch does not
// have. Returns 0 or the CUDA error.
extern "C" int rt_if_begin(void* parent_stream, const void* pred, void* child_stream) {
  cudaStream_t parent = static_cast<cudaStream_t>(parent_stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t e = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorStreamCaptureInvalidated;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return (int)e;
  set_condition_kernel<<<1, 1, 0, parent>>>(handle, static_cast<const bool*>(pred));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies(parent, &node, 1, cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(child_stream),
                                            params.conditional.phGraph_out[0], nullptr, nullptr,
                                            0, cudaStreamCaptureModeThreadLocal);
}

// Closes the IF node that rt_if_begin opened on `child_stream`.
extern "C" int rt_if_end(void* child_stream) {
  cudaGraph_t body;
  return (int)cudaStreamEndCapture(static_cast<cudaStream_t>(child_stream), &body);
}

// A stream of its own for the bodies of IF nodes (non-blocking, never
// destroyed): not one of PyTorch's pooled streams, which another capture
// could be running on. Null on failure.
extern "C" void* rt_stream_create() {
  cudaStream_t s = nullptr;
  return cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking) == cudaSuccess ? s : nullptr;
}
