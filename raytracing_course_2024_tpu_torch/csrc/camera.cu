// The modular route's camera stage for NVIDIA Hopper (sm_90a), hand-written
// CUDA.
//
// Entry point (plain C interface, bound with ctypes by ops/kernels.py):
//   rt_launch_camera  N4: the (13, b) state of fresh paths on their jittered
//                     camera rays, one launch.
// No Pallas kernel computes this. The JAX package generates the camera rays
// inside its jitted sample scan (raytracing_course_2024_tpu/integrator/
// path.py:490 calls ops/camera.py:48 generate_rays) and builds the fresh
// path state in trace_paths (integrator/path.py:304-312); XLA fuses both
// into one pass over the lanes. The plain PyTorch version is
// ops/camera.py:camera_state_plain, about 113 ATen ops; the kernel equals it
// bit for bit.
//
// Per lane i: key = work_key(seed, wid[i] + wid_off) (the seed and the
// work-id offset read from the device pair seed_off, low 32 bits of each, as
// K1, K2, K3 and N1b read them, so that a captured CUDA graph replays the
// launch for any sample), the jitter draws at CTR_JITTER and CTR_JITTER + 1,
// the pinhole ray through (px[i], py[i]) (common.cuh camera_ray), then the
// rows ro 0-2, rd 3-5, throughput 6-8 = 1, radiance 9-11 = 0, alive 12 = 1.
//
// Arithmetic: as the plain version, op for op. Its origin is the camera's
// position plus rd.x * 0 and its zero and one derive from ro.x * 0, as
// generate_rays_u and trace_paths write them, so even the sign of a zero
// agrees. One thread per lane; the camera's 14 floats are staged in shared
// memory; each row is stored as one coalesced row of b floats.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCamFloats = 16;  // camera_ray reads the row's first 14

struct CameraParams {
  const float* px;            // (b,) pixel x
  const float* py;            // (b,) pixel y
  const int* wid;             // (b,) work id per lane
  const long long* seed_off;  // (2,): seed, wid_off (low 32 bits of each)
  const float* cam;           // (128,) camera row (ops/camera.py)
  float* out;                 // (13, b) fresh state
  long long b;
  int width, height;
};

__global__ void __launch_bounds__(kThreads) camera_kernel(CameraParams p) {
  __shared__ float cam[kCamFloats];
  if (threadIdx.x < kCamFloats) cam[threadIdx.x] = __ldg(p.cam + threadIdx.x);
  __syncthreads();
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.b) return;  // the ragged last block
  const uint32_t seed = (uint32_t)__ldg(&p.seed_off[0]);
  const uint32_t wid_off = (uint32_t)__ldg(&p.seed_off[1]);
  const uint32_t key = work_key(seed, (uint32_t)__ldg(p.wid + i) + wid_off);
  V3 pos, rd;
  camera_ray(cam, __ldg(p.px + i), __ldg(p.py + i), p.width, p.height,
             uniform_ctr(key, CTR_JITTER), uniform_ctr(key, CTR_JITTER + 1u), pos, rd);
  const float dz = rd.x * 0.0f;  // generate_rays_u: origin = rd.x * 0 + position
  const V3 ro = mk(dz + pos.x, dz + pos.y, dz + pos.z);
  const float zero = ro.x * 0.0f;  // trace_paths: zeros = ro.x * 0, ones = zeros + 1
  const float one = zero + 1.0f;
  const float row[13] = {ro.x, ro.y, ro.z, rd.x, rd.y, rd.z, one,
                         one,  one,  zero, zero, zero, one};
  float* out = p.out + i;
#pragma unroll
  for (int r = 0; r < 13; ++r) out[r * p.b] = row[r];
}

}  // namespace

// N4. px, py: (b,) f32; wid: (b,) int32; seed_off: two int64 on the device
// (seed, work-id offset); cam: the (128,) camera row; out: (13, b) f32.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take). Never synchronises.
extern "C" int rt_launch_camera(const void* px, const void* py, const void* wid,
                                const void* seed_off, const void* cam, int width, int height,
                                void* out, long long b, void* stream) {
  if (b < 0 || b > 0x7fffffffLL || width < 1 || height < 1) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  CameraParams p{};
  p.px = static_cast<const float*>(px);
  p.py = static_cast<const float*>(py);
  p.wid = static_cast<const int*>(wid);
  p.seed_off = static_cast<const long long*>(seed_off);
  p.cam = static_cast<const float*>(cam);
  p.out = static_cast<float*>(out);
  p.b = b;
  p.width = width;
  p.height = height;
  const unsigned blocks = (unsigned)((b + kThreads - 1) / kThreads);
  camera_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
