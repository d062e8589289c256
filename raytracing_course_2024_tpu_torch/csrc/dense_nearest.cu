// Dense triangle nearest-hit for NVIDIA Hopper (sm_90a), hand-written CUDA.
//
// rt_launch_dense_nearest replaces the TPU kernel K4,
// raytracing_course_2024_tpu/ops/pallas_intersect.py:_kernel (via _run,
// API pallas_dense_nearest): for each ray, the nearest Moller-Trumbore hit
// with t > tmin over N <= 128 triangles given as a (9, N) [a, e1, e2]
// table. Outputs t (+inf on a miss) and the triangle index (0 on a miss).
// The plain PyTorch version is ops/dense_nearest.py:dense_nearest_plain.
//
// Translation from the TPU kernel:
// * The TPU kernel unrolls the triangle loop statically (table reads fold to
//   immediates) over 8192-lane blocks. Here each thread owns one ray and
//   walks the table at run time; every thread of a warp reads the same
//   entry, staged once per block in shared memory (9 x 128 x 4 B = 4.6 KB),
//   so the reads are broadcasts.
// * The running min and argmin stay in registers; one write of (t, idx) per
//   ray. The strict t < best_t keeps the lowest index on a tie, as the TPU
//   kernel does.
// * Blocks of 256 threads with a bounds check: no padding to a block
//   multiple (the TPU kernel padded to 8192 lanes).
// * The arithmetic follows the TPU kernel op by op (1 / det with the 1e-30
//   guard, then products); --fmad=false (ops/kernels.py) keeps the rounding
//   op by op like the plain version.
//
// What bounds it on an H100: per ray 24 B in and 8 B out against about 50
// flops per triangle (36 triangles: ~1,800 flops per ray, ~56 flop/B), well
// above the fp32 ridge (~20 flop/B): fp32 throughput bounds it, not HBM. The
// design keeps everything but the rays and the two outputs out of device
// memory (the XLA sweep it stands beside writes a (B, N) t matrix).

#include "common.cuh"

namespace {

constexpr int TRI_ROWS = 9;  // a, e1, e2

struct DenseParams {
  const float* ro[3];
  const float* rd[3];
  const float* tri;  // (9, n)
  int n;
  long long b;
  float tmin;
  float* t_out;  // (b,)
  int* i_out;    // (b,)
};

__global__ void __launch_bounds__(kThreads) dense_nearest_kernel(DenseParams p) {
  __shared__ float tri_s[TRI_ROWS * MAX_PRIMS];
  for (int k = threadIdx.x; k < TRI_ROWS * p.n; k += blockDim.x) tri_s[k] = p.tri[k];
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.b) return;
  const V3 ro = mk(p.ro[0][i], p.ro[1][i], p.ro[2][i]);
  const V3 rd = mk(p.rd[0][i], p.rd[1][i], p.rd[2][i]);
  const int n = p.n;
  float best_t = INFINITY;
  int best_i = 0;
  for (int j = 0; j < n; ++j) {
    const V3 a = mk(tri_s[0 * n + j], tri_s[1 * n + j], tri_s[2 * n + j]);
    const V3 e1 = mk(tri_s[3 * n + j], tri_s[4 * n + j], tri_s[5 * n + j]);
    const V3 e2 = mk(tri_s[6 * n + j], tri_s[7 * n + j], tri_s[8 * n + j]);
    const V3 pv = cross(rd, e2);
    const float det = dot(e1, pv);
    const bool det_ok = fabsf(det) > 1e-30f;
    const float inv_det = 1.0f / (det_ok ? det : 1e-30f);
    const V3 tv = sub(ro, a);
    const float u = dot(tv, pv) * inv_det;
    const V3 qv = cross(tv, e1);
    const float v = dot(rd, qv) * inv_det;
    const float t = dot(e2, qv) * inv_det;
    if ((u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && det_ok && (t > p.tmin) &&
        (t < best_t)) {
      best_t = t;
      best_i = j;
    }
  }
  p.t_out[i] = best_t;
  p.i_out[i] = best_i;
}

}  // namespace

// rays: host array of 6 device pointers (ro.x, ro.y, ro.z, rd.x, rd.y, rd.z),
// each (b,) f32. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take). Never
// synchronises.
extern "C" int rt_launch_dense_nearest(const void* const* rays, const void* tri, int n,
                                       long long b, float tmin, void* t_out, void* i_out,
                                       void* stream) {
  if (b < 0 || n < 1 || n > MAX_PRIMS) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  DenseParams p{};
  for (int c = 0; c < 3; ++c) {
    p.ro[c] = static_cast<const float*>(rays[c]);
    p.rd[c] = static_cast<const float*>(rays[3 + c]);
  }
  p.tri = static_cast<const float*>(tri);
  p.n = n;
  p.b = b;
  p.tmin = tmin;
  p.t_out = static_cast<float*>(t_out);
  p.i_out = static_cast<int*>(i_out);
  const unsigned grid = (unsigned)((b + kThreads - 1) / kThreads);
  dense_nearest_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
