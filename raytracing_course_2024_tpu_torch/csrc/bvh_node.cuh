// The node of K6's 4-wide tree and its box test, shared by the BVH nearest
// hit (bvh_traverse.cu, K6) and the light pdf's all-hits walk of the lights'
// own tree (light_tree.cuh, K3 above 32 lights). The layout is
// ops/bvh.py:build_bvh4_nodes': a wide node is one 128-byte line, eight
// float4: its four children's boxes as structure of arrays (lo.x[4] lo.y[4]
// lo.z[4] hi.x[4] hi.y[4] hi.z[4]), four child words (a wide node's index; a
// leaf as its first row | kLeafBit; an empty slot kLeafBit with count 0) and
// four counts (a leaf's rows).

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
