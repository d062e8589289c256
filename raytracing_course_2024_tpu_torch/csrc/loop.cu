// The lane loops' control on the device for NVIDIA Hopper (sm_90a),
// hand-written CUDA.
//
// Entry points (plain C interface, bound with ctypes by ops/kernels.py):
//   rt_launch_round_test  N5: the loop test of a lane frame, one launch.
//   rt_if_begin / rt_if_end  an IF node of a CUDA graph under capture: the
//                     work captured between the two runs at replay only when
//                     a 0-dim bool on the device is then true.
//
// No Pallas kernel computes N5. The JAX package runs each lane frame as one
// lax.while_loop under jax.jit (raytracing_course_2024_tpu/integrator/
// wavefront.py:355, :539, :607): the loop test `cond` (:300, :516, :593),
// the bounce's path-vertex sum (:280-281, :528) and the counter refill's
// predicate, a lax.cond (:311-316), are reductions over the lanes that XLA
// fuses inside the loop, so the loop never leaves the device. Here they are
// one launch per round, whose outputs the IF nodes of the next round read
// (runtime/graphs.py:guard); the host reads the counters only once per
// replay of several rounds. The plain PyTorch version is
// ops/loop.py:round_test_plain; counts are integers, so the two agree
// exactly.
//
// Modes (`mode`):
//   0, the counter wavefront: n = lanes alive; more = counter < total or
//      n > 0; refill = more and lanes - n >= thresh (the refill of the next
//      round); the lanes that enter the next bounce, n plus what the refill
//      hands out, min(lanes - n, total - counter), go to the path vertices;
//   1, the sticky engine: n = lanes alive or with paths left (k < kmax);
//      more = n > 0, and the n lanes enter the next bounce.
// Both write the counters and the IF nodes' predicates through loop.cuh's
// write_round. The sticky engine's K5 loop needs no pass of its own: K5's
// last block ends its round with the same tail (persistent.cu).
//
// What bounds N5 on an H100: the bytes of its one pass, 4 B a lane (the
// alive row) in mode 0, and the alive row, k and kmax (20 B) where a lane is
// dead in mode 1: 4.2 MB on 1,048,576 lanes, 1.25 us at 3.35 TB/s, against
// a launch of a few microseconds. The design: a grid-stride pass of 256-thread
// blocks, a few blocks per SM, a warp-shuffle block sum, one atomicAdd per
// block into a 64-bit partial count, and the last block to take a ticket
// writes the outputs and leaves the partial count and the ticket at 0 for
// the next launch (no zeroing launch; loop.cuh:last_block_totals).

#include <cuda_runtime.h>

#include "loop.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;
constexpr int kLanesPerThread = 4;  // below this many a thread, fewer blocks

struct LoopParams {
  const float* alive;       // (b,) the state's alive row
  const long long* k;       // mode 1: (b,) paths started per lane
  const long long* kmax;    // mode 1: (b,) paths per lane
  long long b;
  const long long* counter;  // mode 0: the work items handed out
  long long total, thresh;   // mode 0: work items, the refill threshold
  LoopOut out;
  int mode;
};

__device__ void finish(const LoopParams& p, long long n) {
  if (p.mode == 0) {
    const long long c = *p.counter, dead = p.b - n, left = p.total - c;
    const bool more = c < p.total || n > 0, refill = more && dead >= p.thresh;
    const long long enter = n + (refill ? (dead < left ? dead : left) : 0);
    write_round(p.out, n, more, refill, more ? enter : 0);
  } else {
    write_round(p.out, n, n > 0, false, n);
  }
}

__global__ void __launch_bounds__(kThreads) round_test_kernel(LoopParams p) {
  __shared__ int red[kThreads / 32];
  int n = 0;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < p.b; i += stride) {
    bool on = __ldg(p.alive + i) > 0.5f;
    if (p.mode == 1 && !on) on = __ldg(p.k + i) < __ldg(p.kmax + i);
    n += on;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n += __shfl_down_sync(0xffffffffu, n, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = n;
  __syncthreads();
  if (threadIdx.x != 0) return;
  long long total = 0, none = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += red[w];
  if (last_block_totals(p.out, total, none)) finish(p, total);
}

// Sets an IF node's condition from a bool on the device, inside the graph.
__global__ void set_condition_kernel(cudaGraphConditionalHandle h, const bool* pred) {
  cudaGraphSetConditional(h, *pred ? 1u : 0u);
}

}  // namespace

// N5. mode 0: alive (b,) f32, counter one int64, total, thresh; mode 1:
// alive, k and kmax (b,) int64. loop (6,) int64, preds (2,) bool, scratch
// (3,) int64 at 0. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take). Never
// synchronises.
extern "C" int rt_launch_round_test(int mode, const void* alive, const void* k, const void* kmax,
                                    long long b, const void* counter, long long total,
                                    long long thresh, void* loop, void* preds, void* scratch,
                                    void* stream) {
  if (mode < 0 || mode > 1 || b < 0 || (b > 0 && alive == nullptr) ||
      (mode == 0 && counter == nullptr) || (mode == 1 && b > 0 && (k == nullptr || kmax == nullptr)))
    return (int)cudaErrorInvalidValue;
  LoopParams p{};
  p.alive = static_cast<const float*>(alive);
  p.k = static_cast<const long long*>(k);
  p.kmax = static_cast<const long long*>(kmax);
  p.b = b;
  p.counter = static_cast<const long long*>(counter);
  p.total = total;
  p.thresh = thresh;
  p.out = LoopOut{static_cast<long long*>(loop), static_cast<bool*>(preds),
                  static_cast<unsigned long long*>(scratch)};
  p.mode = mode;
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long wanted = (b + (long long)kThreads * kLanesPerThread - 1) /
                           ((long long)kThreads * kLanesPerThread);
  const long long held = (long long)(sms > 0 ? sms : 1) * kBlocksPerSm;
  const unsigned blocks = (unsigned)(wanted < 1 ? 1 : (wanted < held ? wanted : held));
  round_test_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
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
