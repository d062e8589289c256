// Standalone MIS mixture sampler for NVIDIA Hopper (sm_90a), hand-written
// CUDA.
//
// rt_launch_sampler replaces the TPU kernel K3,
// raytracing_course_2024_tpu/ops/pallas_sampling.py:_kernel (via _run, API
// sample_mixture_pallas; body mixture_body): per lane, max_tries iid
// candidates, each from one uniformly picked component (cosine, GGX-VNDF,
// light surface); the first with l.n_shade > 0 and l.n_geom > 0 is kept and
// the mixture pdf is evaluated for it only. Outputs l, pdf and ok. The
// plain PyTorch version is ops/sampler.py:sampler_plain (the JAX package's
// XLA sample_mixture fed the same draws).
//
// Translation from the TPU kernel:
// * The stage itself is mixture() of common.cuh, the same device code the
//   fused bounce (bounce.cu, K1/K2) runs.
// * The TPU hardware PRNG, seeded per 8192-lane block, has no Hopper
//   counterpart: draw r of candidate t is
//   uniform_ctr(work_key(seed, wid + wid_off), ctr.base + ctr.cand t +
//   ctr.row r) (the batch layout: ctr_base + 2 + 7 t + r), the counter RNG
//   of ops/rng.py, so kernel and plain version see the same numbers and the
//   result does not depend on the lane count.
// * The light table (18 x L <= 32) and its spec are staged in shared memory
//   per block; the TPU kernel took them as a VMEM block.
// * A lane whose `need` flag is 0 (dead, or a MIRROR/DIELECTRIC hit) skips
//   the work and writes l = (0, 0, 1), pdf = 1e-9, ok = 0. The JAX API masks
//   ok with need as well, so only l and pdf of those lanes differ from the
//   plain version, and no caller reads them.
// * 256-thread blocks with a bounds check, no padding.
//
// What bounds it on an H100: per lane 52 B of inputs, a 4 B work id and a
// 1 B need flag in, 16 B + 1 B out (74 B), against a few hundred flops per
// candidate plus the light pdf over every light: fp32 throughput, divergence on
// the component branch and latency bound it rather than HBM.

#include "common.cuh"

namespace {

constexpr int N_IN = 13;  // point3, n_geom3, n_shade3, v3, roughness

struct SamplerParams {
  const float* in[N_IN];
  const uint8_t* need;  // (b,) bool
  const int* wid;       // (b,)
  uint32_t wid_off, seed;
  Ctr ctr;
  const float* lp;   // (LC_COUNT, nl)
  const int* lspec;  // (nl,)
  int nl, num_lights, max_tries;
  long long b;
  float* out;    // (4, b): l.x, l.y, l.z, pdf
  uint8_t* ok;   // (b,) bool
};

__global__ void __launch_bounds__(kThreads) sampler_kernel(SamplerParams p) {
  __shared__ float lp_s[LC_COUNT * MAX_LIGHTS];
  __shared__ int lspec_s[MAX_LIGHTS];
  for (int k = threadIdx.x; k < LC_COUNT * p.nl; k += blockDim.x) lp_s[k] = p.lp[k];
  for (int k = threadIdx.x; k < p.nl; k += blockDim.x) lspec_s[k] = p.lspec[k];
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.b) return;
  const long long b = p.b;
  V3 l = mk(0.0f, 0.0f, 1.0f);
  float pdf = SAFE;
  bool ok = false;
  if (p.need[i]) {
    const Tables T{nullptr, nullptr, 0, lp_s, lspec_s, p.nl, p.num_lights};
    const V3 point = mk(p.in[0][i], p.in[1][i], p.in[2][i]);
    const V3 n = mk(p.in[3][i], p.in[4][i], p.in[5][i]);
    const V3 ns = mk(p.in[6][i], p.in[7][i], p.in[8][i]);
    const V3 v = mk(p.in[9][i], p.in[10][i], p.in[11][i]);
    const float roughness = p.in[12][i];
    const uint32_t key = work_key(p.seed, (uint32_t)p.wid[i] + p.wid_off);
    mixture(T, key, p.ctr, p.max_tries, point, n, ns, v, roughness, l, pdf, ok);
  }
  p.out[0 * b + i] = l.x;
  p.out[1 * b + i] = l.y;
  p.out[2 * b + i] = l.z;
  p.out[3 * b + i] = pdf;
  p.ok[i] = ok ? 1 : 0;
}

}  // namespace

// ins: host array of 13 device pointers, each (b,) f32. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for arguments
// the kernel does not take). Never synchronises.
extern "C" int rt_launch_sampler(const void* const* ins, const void* need, const void* wid,
                                 unsigned wid_off, unsigned seed, unsigned ctr_base,
                                 unsigned ctr_cand, unsigned ctr_row, unsigned ctr_diel,
                                 const void* lp, const void* lspec, int nl, int num_lights,
                                 int max_tries, long long b, void* out, void* ok,
                                 void* stream) {
  if (b < 0 || nl < 1 || nl > MAX_LIGHTS || num_lights < 0 || num_lights > nl ||
      max_tries < 1)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  SamplerParams p{};
  for (int c = 0; c < N_IN; ++c) p.in[c] = static_cast<const float*>(ins[c]);
  p.need = static_cast<const uint8_t*>(need);
  p.wid = static_cast<const int*>(wid);
  p.wid_off = wid_off;
  p.seed = seed;
  p.ctr = Ctr{ctr_base, ctr_cand, ctr_row, ctr_diel};
  p.lp = static_cast<const float*>(lp);
  p.lspec = static_cast<const int*>(lspec);
  p.nl = nl;
  p.num_lights = num_lights;
  p.max_tries = max_tries;
  p.b = b;
  p.out = static_cast<float*>(out);
  p.ok = static_cast<uint8_t*>(ok);
  const unsigned grid = (unsigned)((b + kThreads - 1) / kThreads);
  sampler_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
