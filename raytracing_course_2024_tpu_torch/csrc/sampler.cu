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
// * Lane mode (a per-lane depth pointer): lane i draws at
//   at_depth(ctr, ctr_stride, depth[i]), the lane engines' layout (2 + 64
//   depth + t + 4 r at max_tries 4), as K1's lane mode does (bounce.cu). The
//   JAX package's lane core sampled in XLA (integrator/wavefront.py:167-178,
//   fused by XLA inside its lax.while_loop); in the port's lane rounds this
//   kernel takes its place.
// * seed and wid_off are read from device memory (two int64, their low 32
//   bits), not passed by value: the JAX package traces them as arguments
//   of one compiled frame, and here a captured CUDA graph replays one
//   launch for every seed and sample offset, which it could not if they
//   were frozen into the launch's parameters.
// * The light table (18 x L <= 32) and its spec are staged in shared memory
//   once per block; the TPU kernel took them as a VMEM block. Above 32
//   lights (sampler_many_kernel, rt_launch_sampler_many) the lights are one
//   record each in device memory and the light pdf is an all-hits walk of
//   the lights' own tree (light_tree.cuh); the JAX package, and the plain
//   version here, sum it as one (B, L) sweep over the whole table
//   (ops/sampling.py:_pdf_lights_vectorized).
// * A lane whose `need` flag is 0 (dead, or a MIRROR/DIELECTRIC hit) skips
//   the work and writes l = (0, 0, 1), pdf = 1e-9, ok = 0. The JAX API masks
//   ok with need as well, so only l and pdf of those lanes differ from the
//   plain version, and no caller reads them.
// * No padding to a block multiple.
//
// What bounds it on an H100: per lane that samples 52 B of inputs and a 4 B
// work id, per lane a 1 B need flag in and 16 B + 1 B out, against a few
// hundred fp32 operations per candidate plus the mixture pdf with the light
// pdf over every light (about 70 % of a Cornell lane's operations), most of
// them in long dependent chains of IEEE divisions and square roots at 32
// warps per SM: latency and the instruction rate bound it, not HBM.
// What the design does about it:
// * The lanes that sample are ranked into full passes, a chunk of kChunk
//   tiles at a time (lane_queue.cuh:walk_chunk): deep in a frame they are
//   scattered among dead ones, and with a thread per lane a warp ran the
//   sampler for a few of its lanes. A lane without `need` gets its stores
//   from the thread that owns it. On camera rays, where the lanes that
//   sample are whole image rows, the ranking would give nothing: the walk
//   finds that out with one vote and runs a thread per lane.
// * One block per chunk, not a persistent grid, as for K4
//   (dense_nearest.cu). Timed on an H100 and left out, none of them faster:
//   a triangle light's edges and normal computed once per block, a queue per
//   warp, the block's lanes regrouped by sampler component between the
//   tries, the lanes refused by the first try ranked again (PERF.md has the
//   numbers).
//
// Above 32 lights (sampler_many_kernel) a lane is dear and its cost uneven:
// after the candidate loop its walk of the lights' tree visits ~6 wide nodes
// and tests ~11 lights a direction on practice6_1, with no nearest hit to
// cut it short. In the per-chunk schedule above a warp ran as long as its
// longest walk and idled through every lane's light tests at every visit:
// 46.2 ms of a 1280x720 x 32 spp frame (64 launches, 0.72 ms each, 59 % of
// the device time, 1.7 % of its roofline), and its variants, wider chunks,
// fewer registers, the nodes staged per chunk, were all slower (PERF.md).
// So it takes K6's schedule (bvh_traverse.cu) instead, described in
// light_tree.cuh with what bounds it now: a persistent grid whose warps draw
// chunks of 32 lanes by ticket and refill ended lanes, the tree's nodes
// staged once per resident block, the light tests postponed until most of
// the warp holds leaves, five 16-byte loads a light record. 19.9 ms a
// frame on an H100 (0.25 ms a launch on the frame's round-10 state, against
// 0.57). Each lane runs mixture()'s two pieces (common.cuh mixture_pick,
// then mixture_pdf on the sum with its walk's light pdf), and its terms are
// summed in the same order, so l, pdf and ok are bit for bit the per-chunk
// kernel's. sampler_kernel keeps the per-chunk schedule: its body is short
// and even, as timed above.

#include "common.cuh"
#include "lane_queue.cuh"
#include "light_tree.cuh"

namespace {

constexpr int N_IN = 13;  // point3, n_geom3, n_shade3, v3, roughness
constexpr int kChunk = 1;  // tiles of a block's chunk (lane_queue.cuh:walk_chunk)

struct SamplerParams {
  const float* in[N_IN];
  const uint8_t* need;  // (b,) bool
  const int* wid;       // (b,)
  const long long* seed_off;  // (2,): seed, wid_off (low 32 bits of each)
  Ctr ctr;             // the draws (lane mode: at depth 0)
  const int* depth;    // (b,) per-lane depth in lane mode, else nullptr
  uint32_t ctr_stride;  // counters per depth level in lane mode
  const float* lp;   // (LC_COUNT, nl)
  const int* lspec;  // (nl,)
  int nl, num_lights, max_tries;
  long long b;
  float* out;   // (4, b): l.x, l.y, l.z, pdf
  uint8_t* ok;  // (b,) bool
};

__device__ __forceinline__ void store_lane(const SamplerParams& p, long long i, V3 l, float pdf,
                                           bool ok) {
  const long long b = p.b;
  p.out[0 * b + i] = l.x;
  p.out[1 * b + i] = l.y;
  p.out[2 * b + i] = l.z;
  p.out[3 * b + i] = pdf;
  p.ok[i] = ok ? 1 : 0;
}

// The block's lanes that sample, ranked into full passes; `lights`: the
// Tables of sampler_kernel.
template <int C, class LS>
__device__ __forceinline__ void sample_lanes(const SamplerParams& p, ChunkQueueT<C>& queue,
                                             const LS& lights) {
  const long long b = p.b;
  const uint32_t seed = (uint32_t)__ldg(&p.seed_off[0]);
  const uint32_t wid_off = (uint32_t)__ldg(&p.seed_off[1]);
  walk_chunk<C, 1, true>(
      b, queue, [&](long long i) { return i < b && p.need[i] != 0; },
      [&](long long i) { store_lane(p, i, mk(0.0f, 0.0f, 1.0f), SAFE, false); },
      [&](long long i) {
        const V3 point = mk(p.in[0][i], p.in[1][i], p.in[2][i]);
        const V3 n = mk(p.in[3][i], p.in[4][i], p.in[5][i]);
        const V3 ns = mk(p.in[6][i], p.in[7][i], p.in[8][i]);
        const V3 v = mk(p.in[9][i], p.in[10][i], p.in[11][i]);
        const float roughness = p.in[12][i];
        const uint32_t key = work_key(seed, (uint32_t)p.wid[i] + wid_off);
        const Ctr ctr = p.depth ? at_depth(p.ctr, p.ctr_stride, (uint32_t)p.depth[i]) : p.ctr;
        V3 l;
        float pdf;
        bool ok;
        mixture(lights, key, ctr, p.max_tries, point, n, ns, v, roughness, l, pdf, ok);
        store_lane(p, i, l, pdf, ok);
      });
}

__global__ void __launch_bounds__(kBlock) sampler_kernel(SamplerParams p) {
  __shared__ float lp_s[LC_COUNT * MAX_LIGHTS];
  __shared__ int lspec_s[MAX_LIGHTS];
  __shared__ ChunkQueueT<kChunk> queue;
  // walk_chunk's first barrier comes before any `run`: it orders the staging
  for (int k = threadIdx.x; k < LC_COUNT * p.nl; k += blockDim.x) lp_s[k] = p.lp[k];
  for (int k = threadIdx.x; k < p.nl; k += blockDim.x) lspec_s[k] = p.lspec[k];
  const Tables T{nullptr, nullptr, 0, lp_s, lspec_s, p.nl, p.num_lights};
  sample_lanes(p, queue, T);
}

// K3 above 32 lights: persistent warps that walk the lights' tree
// (light_tree.cuh walk_lights). A lane's candidate loop runs when its warp
// takes it up, its light pdf is its walk's, and the two pieces of
// common.cuh's mixture() meet in its stores.
__global__ void __launch_bounds__(kBlock) sampler_many_kernel(SamplerParams p, LightTree lights,
                                                              int* tick) {
  __shared__ __align__(128) LightShared s;
  const int n_top = lights.n_nodes < kLightTop ? lights.n_nodes : kLightTop;
  stage_top(s.top, &s.bar, lights.nodes, n_top);
  const uint32_t seed = (uint32_t)__ldg(&p.seed_off[0]);
  const uint32_t wid_off = (uint32_t)__ldg(&p.seed_off[1]);
  const int n_comp = mixture_components(lights);
  bool picked = false;  // the lane's, from its take-up to its stores
  float bsdf = 0.0f;    // pdf_cosine + pdf_vndf of the pick
  walk_lights(
      lights, s, n_top, p.b, tick, [&](long long i) { return p.need[i] != 0; },
      [&](long long i) { store_lane(p, i, mk(0.0f, 0.0f, 1.0f), SAFE, false); },
      [&](int i, V3& point, V3& pick) {
        point = mk(p.in[0][i], p.in[1][i], p.in[2][i]);
        const V3 n = mk(p.in[3][i], p.in[4][i], p.in[5][i]);
        const V3 ns = mk(p.in[6][i], p.in[7][i], p.in[8][i]);
        const V3 v = mk(p.in[9][i], p.in[10][i], p.in[11][i]);
        const float roughness = p.in[12][i];
        const uint32_t key = work_key(seed, (uint32_t)p.wid[i] + wid_off);
        const Ctr ctr = p.depth ? at_depth(p.ctr, p.ctr_stride, (uint32_t)p.depth[i]) : p.ctr;
        mixture_pick(lights, key, ctr, p.max_tries, n_comp, point, n, ns, v, roughness, pick,
                     picked);
        bsdf = pdf_cosine(n, pick) + pdf_vndf(n, pick, v, roughness);
      },
      [&](int i, V3 pick, float light) {
        V3 l;
        float pdf;
        bool ok = picked;
        mixture_pdf(bsdf + light, n_comp, pick, l, pdf, ok);
        store_lane(p, i, l, pdf, ok);
      });
  if ((threadIdx.x & 31) == 0 && atomicAdd(&tick[1], 1) == (int)gridDim.x * kWarps - 1) {
    tick[0] = 0;
    tick[1] = 0;
    __threadfence();
  }
}

// The arguments both launchers share; false for values the kernels do not
// take.
bool fill_params(SamplerParams& p, const void* const* ins, const void* need, const void* wid,
                 const void* seed_off, unsigned ctr_base, unsigned ctr_cand, unsigned ctr_row,
                 unsigned ctr_diel, const void* depth, unsigned ctr_stride, int max_tries,
                 long long b, void* out, void* ok) {
  if (b < 0 || b > 0x7fffffffLL || max_tries < 1) return false;
  for (int c = 0; c < N_IN; ++c) p.in[c] = static_cast<const float*>(ins[c]);
  p.need = static_cast<const uint8_t*>(need);
  p.wid = static_cast<const int*>(wid);
  p.seed_off = static_cast<const long long*>(seed_off);
  p.ctr = Ctr{ctr_base, ctr_cand, ctr_row, ctr_diel};
  p.depth = static_cast<const int*>(depth);
  p.ctr_stride = ctr_stride;
  p.max_tries = max_tries;
  p.b = b;
  p.out = static_cast<float*>(out);
  p.ok = static_cast<uint8_t*>(ok);
  return true;
}

}  // namespace

// ins: host array of 13 device pointers, each (b,) f32. seed_off: two
// int64 on the device, the seed and the work-id offset. depth: (b,) int32
// (lane mode) or null. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for arguments
// the kernel does not take). Never synchronises.
extern "C" int rt_launch_sampler(const void* const* ins, const void* need, const void* wid,
                                 const void* seed_off, unsigned ctr_base,
                                 unsigned ctr_cand, unsigned ctr_row, unsigned ctr_diel,
                                 const void* depth, unsigned ctr_stride, const void* lp,
                                 const void* lspec, int nl, int num_lights, int max_tries,
                                 long long b, void* out, void* ok, void* stream) {
  SamplerParams p{};
  if (!fill_params(p, ins, need, wid, seed_off, ctr_base, ctr_cand, ctr_row, ctr_diel, depth,
                   ctr_stride, max_tries, b, out, ok) ||
      nl < 1 || nl > MAX_LIGHTS || num_lights < 0 || num_lights > nl)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  p.lp = static_cast<const float*>(lp);
  p.lspec = static_cast<const int*>(lspec);
  p.nl = nl;
  p.num_lights = num_lights;
  sampler_kernel<<<chunk_grid<kChunk>(b), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// K3 above 32 lights. rec, leaf: (num_lights, 20) f32 light records in light
// order and in the tree's order (ops/bvh.py:light_records), leaf 16-byte
// aligned; nodes: (n_nodes, 8) float4 wide nodes of the lights' tree,
// 16-byte aligned; stack: the entries its walk can need
// (ops/bvh.py:Bvh4.stack); tick: two int32, zero, which the launch leaves
// zero. The other arguments as rt_launch_sampler's.
extern "C" int rt_launch_sampler_many(const void* const* ins, const void* need, const void* wid,
                                      const void* seed_off, unsigned ctr_base,
                                      unsigned ctr_cand, unsigned ctr_row, unsigned ctr_diel,
                                      const void* depth, unsigned ctr_stride, const void* rec,
                                      const void* leaf, int num_lights, const void* nodes,
                                      int n_nodes, int stack, int max_tries, long long b,
                                      void* out, void* ok, void* tick, void* stream) {
  SamplerParams p{};
  if (!fill_params(p, ins, need, wid, seed_off, ctr_base, ctr_cand, ctr_row, ctr_diel, depth,
                   ctr_stride, max_tries, b, out, ok) ||
      num_lights <= MAX_LIGHTS || n_nodes < 1 || stack < 0 || stack > kLightStack ||
      (reinterpret_cast<uintptr_t>(nodes) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(leaf) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  LightTree lights{};
  lights.rec = static_cast<const float*>(rec);
  lights.num_lights = num_lights;
  lights.leaf = static_cast<const float4*>(leaf);
  lights.nodes = static_cast<const float4*>(nodes);
  lights.n_nodes = n_nodes;
  const unsigned grid = grid_for(sampler_many_kernel, (b + kBlock - 1) / kBlock);
  sampler_many_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      p, lights, static_cast<int*>(tick));
  return (int)cudaGetLastError();
}

// Resident blocks per SM of sampler_kernel on the current device.
extern "C" int rt_sampler_resident_blocks() { return resident_blocks(sampler_kernel); }

// Launch geometry of sampler_many_kernel, for reports: out = {stack entries,
// of them in shared memory per thread, wide nodes staged in shared memory,
// shared bytes per block, local bytes per thread, registers per thread,
// resident blocks per SM}.
extern "C" void rt_sampler_many_geometry(int* out) {
  cudaFuncAttributes a{};
  cudaFuncGetAttributes(&a, sampler_many_kernel);
  out[0] = kLightStack;
  out[1] = kLightSharedStack;
  out[2] = kLightTop;
  out[3] = (int)a.sharedSizeBytes;
  out[4] = (int)a.localSizeBytes;
  out[5] = a.numRegs;
  out[6] = resident_blocks(sampler_many_kernel);
}
