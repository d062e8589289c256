// The node of K6's 4-wide tree, its box test, and the staging of the tree's
// top in shared memory and the read of a node from there or from device
// memory, shared by the BVH nearest hit (bvh_traverse.cu, K6) and the light
// pdf's all-hits walk of the lights' own tree (light_tree.cuh, K3 above 32
// lights). The layout is
// ops/bvh.py:build_bvh4_nodes': a wide node is one 128-byte line, eight
// float4: its four children's boxes as structure of arrays (lo.x[4] lo.y[4]
// lo.z[4] hi.x[4] hi.y[4] hi.z[4]), four child words (a wide node's index; a
// leaf as its first row | kLeafBit; an empty slot kLeafBit with count 0) and
// four counts (a leaf's rows). An empty slot's box is +inf on all six bounds,
// so box_entry misses it (every slab is +-inf, none NaN): K6 tests it as any
// other box, K3 skips it by its count.
//
// What a read costs: K6's lanes read different nodes, so each 16-byte load
// of a line costs about one shared-memory or L1 wavefront a lane. On an H100
// that is not what sets K6's time (PERF.md, PR 27): halving the loads of a
// visit with a 64-byte quantized node, or laying the staged top out free of
// bank conflicts, did not make it faster, while each instruction a visit
// issues did cost. So K6 reads a line through one generic pointer
// (line_ptr), which issues each load once for a warp whose lanes read from
// both memories, where node_line's two branches issue both sets.

#pragma once

#include "common.cuh"

namespace {

constexpr int kLine = 8;  // float4 per wide node
constexpr unsigned kLeafBit = 0x80000000u;

struct Line {
  float4 lx, ly, lz, hx, hy, hz, w, c;
};

// A line from shared memory (plain loads) or device memory (read-only).
__device__ __forceinline__ Line line_at(const float4* q) {
  Line l;
  l.lx = q[0], l.ly = q[1], l.lz = q[2], l.hx = q[3];
  l.hy = q[4], l.hz = q[5], l.w = q[6], l.c = q[7];
  return l;
}

__device__ __forceinline__ Line ldg_line(const float4* q) {
  Line l;
  l.lx = __ldg(q), l.ly = __ldg(q + 1), l.lz = __ldg(q + 2), l.hx = __ldg(q + 3);
  l.hy = __ldg(q + 4), l.hz = __ldg(q + 5), l.w = __ldg(q + 6), l.c = __ldg(q + 7);
  return l;
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}

// Copies the first n_top wide nodes of `nodes` (128-byte aligned) into `top`
// (shared memory, 128-byte aligned): one bulk asynchronous copy, completed
// on the mbarrier `bar` (shared memory), that every thread waits for. Every
// thread of the block calls it, once per launch.
__device__ __forceinline__ void stage_top(float4* top, unsigned long long* bar_ptr,
                                          const float4* nodes, int n_top) {
  const uint32_t bar = smem_addr(bar_ptr);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t bytes = (uint32_t)n_top * kLine * 16u;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_addr(top)),
        "l"(reinterpret_cast<uint64_t>(nodes)), "r"(bytes), "r"(bar)
        : "memory");
  }
  uint32_t ready = 0;
  while (!ready) {
    asm volatile(
        "{\n .reg .pred P;\n mbarrier.try_wait.parity.shared::cta.b64 P, [%1], 0;\n"
        " selp.u32 %0, 1, 0, P;\n}\n"
        : "=r"(ready)
        : "r"(bar)
        : "memory");
  }
}

// A wide node: from the block's staged top (its first n_top nodes, in shared
// memory) or device memory.
__device__ __forceinline__ Line node_line(const float4* top, const float4* nodes, int n,
                                          int n_top) {
  if (n < n_top) return line_at(top + kLine * n);
  return ldg_line(nodes + (long long)kLine * n);
}

// A generic pointer to wide node n's line: into the block's staged top (its
// first n_top nodes, in shared memory) or device memory. Loads through it
// take one instruction for the warp wherever each lane's line lies, where
// node_line's two branches issue both sets for a warp that reads from both.
__device__ __forceinline__ const float4* line_ptr(const float4* top, const float4* nodes, int n,
                                                  int n_top) {
  return n < n_top ? top + kLine * n : nodes + (long long)kLine * n;
}

// Entry distance of the ray into the box, or INFINITY where the slab
// interval does not meet [tmin, limit]. An axis whose slab product is NaN
// (origin on the slab plane, direction 0 there) is left out by fminf/fmaxf.
__device__ __forceinline__ float box_entry(float lx, float ly, float lz, float hx, float hy,
                                           float hz, V3 ro, V3 inv, float tmin, float limit) {
  const float x0 = (lx - ro.x) * inv.x, x1 = (hx - ro.x) * inv.x;
  const float y0 = (ly - ro.y) * inv.y, y1 = (hy - ro.y) * inv.y;
  const float z0 = (lz - ro.z) * inv.z, z1 = (hz - ro.z) * inv.z;
  const float near = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fmaxf(fminf(z0, z1), tmin));
  const float far = fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fminf(fmaxf(z0, z1), limit));
  return near <= far ? near : INFINITY;
}

}  // namespace
