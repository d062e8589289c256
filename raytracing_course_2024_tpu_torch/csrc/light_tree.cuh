// K3's lights above 32 (sampler.cu sampler_many_kernel): the table in device
// memory and the light pdf by an all-hits walk of the lights' own tree.
//
// Up to 32 lights K3 stages the (LC_COUNT, nl) light pack in shared memory
// and sums the light pdf over every light (common.cuh Tables, pdf_lights).
// The course's light-sampling scene (practice6_1) has 1,164 emissive
// triangles: the pack no longer fits a block's share of shared memory, and a
// sum over every light is 1,164 ray tests for each sampled direction, where
// a ray meets a few lights at most. The reference finds those with an
// all-hits walk of a second BVH built over the emissive primitives only
// (SURVEY.md: bvh.rs intersect_with_bvh_all_points, scene.rs
// bvh_light_sources). So does this code:
// * LightRecs: one 80-byte record per light (ops/bvh.py:light_records): its
//   LightCol rows, its spec word and a pad, read through the read-only path.
//   The pick reads light li's record, in light order (the plain sampler's
//   light_packed column li); the walk reads the same records in the tree's
//   order, so a leaf's lights are consecutive records.
// * The tree: ops/bvh.py:build_light_tree, K6's 4-wide layout
//   (bvh_node.cuh) over a binary SAH tree of the lights' padded boxes. A ray
//   meets a light only inside its box, so the walk, which enters every box
//   the ray meets beyond 0 (no nearest hit to cut it short), reaches every
//   light the plain sum would count.
// * The walk: a visit loads one line and tests its four boxes (box_entry,
//   K6's test); an entered leaf's lights add their terms at once
//   (common.cuh add_light_pdf, the terms of pdf_lights); of the entered
//   internal children the first is visited next and the others are pushed.
//   A visit pushes at most three, so the stack holds ops/bvh.py:WIDE_STACK
//   entries like K6's (the launcher refuses a tree whose bound, Bvh4.stack,
//   is larger); it lives in local memory, where only the entries a ray
//   reaches cost. The terms are summed in walk order, the plain sweep's in
//   light order: the two round differently.

#pragma once

#include "bvh_node.cuh"
#include "common.cuh"

namespace {

constexpr int LR_WIDTH = 20;         // floats of a light record (ops/bvh.py:LIGHT_REC)
constexpr int LR_SPEC = LC_COUNT;    // its spec word (ops/bvh.py:LIGHT_REC_SPEC)
constexpr int kLightStack = 3 * 64;  // ops/bvh.py:WIDE_STACK

// Light records in device memory, read as Tables reads its pack.
struct LightRecs {
  const float* rec;  // (L, LR_WIDTH)
  int num_lights;
  __device__ __forceinline__ float L(int row, int j) const {
    return __ldg(rec + (long long)j * LR_WIDTH + row);
  }
  __device__ __forceinline__ V3 L3(int row, int j) const {
    return mk(L(row, j), L(row + 1, j), L(row + 2, j));
  }
  __device__ __forceinline__ int spec(int j) const { return __float_as_int(L(LR_SPEC, j)); }
};

// What mixture() reads of the lights above 32: the pick's records (the base,
// so common.cuh's sample_light_dir reads them), the walk's records and the
// tree.
struct LightTree : LightRecs {
  LightRecs leaf;       // the records in the tree's order
  const float4* nodes;  // (W, kLine) wide nodes, root 0
};

__device__ __forceinline__ float lane_of(float4 v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// The light pdf along (point, l): the terms of every light the ray meets,
// in walk order, over the light count.
__device__ float pdf_lights(const LightTree& T, V3 point, V3 l) {
  const V3 inv = mk(1.0f / l.x, 1.0f / l.y, 1.0f / l.z);
  float total = 0.0f;
  int stack[kLightStack];
  int sp = 0, node = 0;
  for (;;) {
    const Line c = ldg_line(T.nodes + (long long)kLine * node);
    int next = -1;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int w = __float_as_int(lane_of(c.w, k));
      const int count = __float_as_int(lane_of(c.c, k));
      if (w < 0 && count == 0) continue;  // an empty slot
      const float t = box_entry(lane_of(c.lx, k), lane_of(c.ly, k), lane_of(c.lz, k),
                                lane_of(c.hx, k), lane_of(c.hy, k), lane_of(c.hz, k), point, inv,
                                0.0f, INFINITY);
      if (t == INFINITY) continue;
      if (w >= 0) {
        if (next >= 0) stack[sp++] = next;
        next = w;
      } else {
        const int first = (int)((unsigned)w & ~kLeafBit);
#pragma unroll 1
        for (int r = first; r < first + count; ++r) add_light_pdf(T.leaf, r, point, l, total);
      }
    }
    if (next >= 0) {
      node = next;
    } else if (sp > 0) {
      node = stack[--sp];
    } else {
      break;
    }
  }
  return total / (float)max(T.num_lights, 1);
}

}  // namespace
