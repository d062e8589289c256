// Dense triangle nearest-hit for NVIDIA Hopper (sm_90a), hand-written CUDA.
//
// rt_launch_dense_nearest replaces the TPU kernel K4,
// raytracing_course_2024_tpu/ops/pallas_intersect.py:_kernel (via _run,
// API pallas_dense_nearest): for each ray, the nearest Moller-Trumbore hit
// with t > tmin over N <= 128 triangles. Outputs t (+inf on a miss) and the
// triangle index (0 on a miss). With a `live` mask a lane whose flag is 0
// gets the miss and no loop. The plain PyTorch version is
// ops/dense_nearest.py:dense_nearest_plain, which takes the same mask.
//
// Translation from the TPU kernel:
// * The TPU kernel unrolls the triangle loop statically (table reads fold to
//   immediates) over 8192-lane blocks and intersects every lane. Here the
//   table is walked at run time; every thread of a warp reads the same entry
//   from shared memory (staged per block), so the reads are broadcasts.
// * The running min and argmin stay in registers; one write of (t, idx) per
//   ray. The strict t < best_t keeps the lowest index on a tie, as the TPU
//   kernel does.
// * No padding to a block multiple (the TPU kernel padded to 8192 lanes).
// * The arithmetic follows the TPU kernel op by op (1 / det with the 1e-30
//   guard, then products); --fmad=false (ops/kernels.py) keeps the rounding
//   op by op like the plain version.
//
// What bounds it on an H100: per live ray 25 B in and 8 B out against 53 fp32
// operations per triangle (36 triangles: ~1,900 per ray, ~58 per byte), far
// above the fp32 ridge (20 per byte): the instruction rate bounds it, not
// HBM. Without FMA contraction and with an IEEE reciprocal per entry the
// test is ~73 instructions (60 of them fp32), and the loop runs at about
// three quarters of the rate the schedulers allow, so the kernel cannot come
// near the fp32 peak, which counts an FMA as two operations. Little of the
// loop is overhead; the design makes the work itself smaller:
// * A live mask: the integrators read a hit only where the path is alive,
//   half the lanes of a frame on average and a few per cent at its last
//   levels. The live lanes of a chunk of kChunk tiles are ranked into full
//   passes (lane_queue.cuh:walk_chunk), so no warp walks the loop for a few
//   live lanes; a masked lane gets its two stores from the thread that owns
//   it. A lane's arithmetic is untouched, so its result does not depend on
//   its rank or on the mask.
// * A warp vote after the first half of the test (run_rays): camera rays
//   skip the second half of most entries. It is dropped by a pass whose
//   first entries show that it does not pay (the rays of a bounce).
// * 16-byte entry-major records (ops/dense_nearest.py:build_tri_records):
//   [a | e1 | e2], each padded to a float4, read with three 16-byte shared
//   loads at immediate offsets from one pointer per entry, and kRays rays
//   per thread, so that one set of record loads and one loop step serves
//   them and their independent chains fill each other's latencies.
// * One block per chunk, not a persistent grid: the records are 6 KB at
//   most, and timed on an H100 a resident block's warps lost more waiting
//   for each other at the chunk barriers than staging per chunk costs.

#include "common.cuh"
#include "lane_queue.cuh"

namespace {

constexpr int kRays = 2;   // rays per thread and pass
constexpr int kChunk = 2;  // tiles of a block's chunk (lane_queue.cuh:walk_chunk)
// The vote below is tried on a pass's first kProbe entries and kept for the
// rest only if it skipped at least a quarter of them.
constexpr int kProbe = 8;

struct DenseParams {
  const float* ro[3];
  const float* rd[3];
  const float4* rec;    // (n, 3): a, e1, e2
  const uint8_t* live;  // (b,) bool, or nullptr: every lane
  int n;
  long long b;
  float tmin;
  float* t_out;  // (b,)
  int* i_out;    // (b,)
};

// The nearest hit of the m <= kRays rays `lanes[0..m)`. A thread with fewer
// than kRays lanes walks its first lane in the empty slots and stores
// nothing for them.
//
// The vote: a hit needs u >= 0 and u + v <= 1 with v >= 0, so u <= 1 (the
// rounded sum is no smaller than u). Where no ray of the warp has det_ok and
// 0 <= u <= 1, every one of them fails the full test, and the second half of
// the entry (cross, two dots, the compares) is skipped with the same result.
// Camera rays skip most entries that way; the rays of a bounce almost none,
// and the vote then only costs, so a pass drops it after kProbe entries
// unless it paid.
__device__ __forceinline__ void run_rays(const DenseParams& p, const float4* rec,
                                         const int (&lanes)[kRays], int m) {
  V3 ro[kRays], rd[kRays];
  float best_t[kRays];
  int best_i[kRays];
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int i = r < m ? lanes[r] : lanes[0];
    ro[r] = mk(p.ro[0][i], p.ro[1][i], p.ro[2][i]);
    rd[r] = mk(p.rd[0][i], p.rd[1][i], p.rd[2][i]);
    best_t[r] = INFINITY;
    best_i[r] = 0;
  }
  const int n = p.n;
  const float tmin = p.tmin;
  const unsigned active = __activemask();
  bool vote = true;
  int skipped = 0;
  for (int j = 0; j < n; ++j) {
    const V3 a = xyz(rec[3 * j]), e1 = xyz(rec[3 * j + 1]), e2 = xyz(rec[3 * j + 2]);
    if (j == kProbe) vote = 4 * skipped >= kRays * kProbe;
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      const V3 pv = cross(rd[r], e2);
      const float det = dot(e1, pv);
      const bool det_ok = fabsf(det) > 1e-30f;
      const float inv_det = 1.0f / (det_ok ? det : 1e-30f);
      const V3 tv = sub(ro[r], a);
      const float u = dot(tv, pv) * inv_det;
      if (vote && !__any_sync(active, det_ok && u >= 0.0f && u <= 1.0f)) {
        ++skipped;
        continue;
      }
      const V3 qv = cross(tv, e1);
      const float v = dot(rd[r], qv) * inv_det;
      const float t = dot(e2, qv) * inv_det;
      if ((u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && det_ok && (t > tmin) &&
          (t < best_t[r])) {
        best_t[r] = t;
        best_i[r] = j;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    if (r < m) {
      p.t_out[lanes[r]] = best_t[r];
      p.i_out[lanes[r]] = best_i[r];
    }
  }
}

__global__ void __launch_bounds__(kBlock) dense_nearest_kernel(DenseParams p) {
  __shared__ float4 rec_s[3 * MAX_PRIMS];
  __shared__ ChunkQueueT<kChunk> queue;
  // walk_chunk's first barrier comes before any `run`: it orders the staging
  for (int k = threadIdx.x; k < 3 * p.n; k += blockDim.x) rec_s[k] = p.rec[k];
  const long long b = p.b;
  walk_chunk<kChunk, kRays, false>(
      b, queue, [&](long long i) { return i < b && (!p.live || p.live[i] != 0); },
      [&](long long i) {
        p.t_out[i] = INFINITY;
        p.i_out[i] = 0;
      },
      [&](const int(&lanes)[kRays], int m) { run_rays(p, rec_s, lanes, m); });
}

}  // namespace

// rays: host array of 6 device pointers (ro.x, ro.y, ro.z, rd.x, rd.y, rd.z),
// each (b,) f32. rec: (n, 3) float4 records. live: (b,) bool or null. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for arguments
// the kernel does not take). Never synchronises.
extern "C" int rt_launch_dense_nearest(const void* const* rays, const void* rec, int n,
                                       long long b, float tmin, const void* live, void* t_out,
                                       void* i_out, void* stream) {
  if (b < 0 || b > 0x7fffffffLL || n < 1 || n > MAX_PRIMS) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  DenseParams p{};
  for (int c = 0; c < 3; ++c) {
    p.ro[c] = static_cast<const float*>(rays[c]);
    p.rd[c] = static_cast<const float*>(rays[3 + c]);
  }
  p.rec = static_cast<const float4*>(rec);
  p.live = static_cast<const uint8_t*>(live);
  p.n = n;
  p.b = b;
  p.tmin = tmin;
  p.t_out = static_cast<float*>(t_out);
  p.i_out = static_cast<int*>(i_out);
  dense_nearest_kernel<<<chunk_grid<kChunk>(b), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// Launch geometry, for reports: out = {rays per thread, tiles per chunk,
// resident blocks per SM}.
extern "C" void rt_dense_nearest_geometry(int* out) {
  out[0] = kRays;
  out[1] = kChunk;
  out[2] = resident_blocks(dense_nearest_kernel);
}
