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
//   LightCol rows, its spec word and a pad. The pick reads light li's
//   record, in light order (the plain sampler's light_packed column li),
//   through the read-only path a float at a time; the walk reads the same
//   records in the tree's order, so a leaf's lights are consecutive records,
//   each as five 16-byte loads (LightRec).
// * The tree: ops/bvh.py:build_light_tree, K6's 4-wide layout
//   (bvh_node.cuh) over a binary SAH tree of the lights' padded boxes. A ray
//   meets a light only inside its box, so the walk, which enters every box
//   the ray meets beyond 0 (no nearest hit to cut it short), reaches every
//   light the plain sum would count.
// * A ray's walk: a visit loads one line and tests its four boxes
//   (box_entry, K6's test); of the entered internal children the last in
//   slot order is visited next and the others are pushed; the entered
//   leaves' lights add their terms (common.cuh add_light_pdf, the terms of
//   pdf_lights, op for op) in slot order, then in record order, before the
//   ray's next visit. So the terms are summed in walk order, the plain
//   sweep's in light order: the two round differently.
//
// The schedule (walk_lights), K6's (bvh_traverse.cu walk_warp) for an
// all-hits walk:
// * A persistent grid (lane_queue.cuh:grid_for): each warp draws chunks of
//   32 lanes from a counter in device memory, gives the lanes that do not
//   sample their stores at once and ranks the others into its own queue in
//   shared memory. Once kLightRefill lanes of the warp have ended their
//   rays, the ended lanes store their results and take the next queued
//   lanes (the candidate loop, then the walk), so a few long walks do not
//   hold 32 lanes. tick[1] counts the warps that are done: the last sets
//   both counters back to 0 for the next launch.
// * Postponed light tests: a lane that enters leaves at a visit holds them
//   until at most kLightLeafWait lanes of its warp are still visiting
//   nodes; then the lanes that hold leaves test their lights together, so
//   lanes do not idle through each other's light tests at every visit (Aila
//   and Laine). A ray's terms still come in its own walk order.
// * The staging: a block first copies the top kLightTop wide nodes (the
//   first levels, contiguous by the breadth-first order; all 187 of
//   practice6_1's tree) into shared memory with one bulk asynchronous copy
//   completed on an mbarrier, once per resident block (3 x 132 copies a
//   launch on an H100); deeper nodes of a larger tree come from device
//   memory.
// * The stack: a visit pushes at most three entries, so a walk needs at most
//   the host's bound (ops/bvh.py:Bvh4.stack; the launcher refuses a tree
//   whose bound passes kLightStack = ops/bvh.py:WIDE_STACK). An entry is a
//   node index. The first kLightSharedStack entries of a thread live in
//   shared memory (practice6_1's bound is 16: all of it); deeper ones spill
//   to local memory, which only the entries a ray reaches cost.
//
// What bounds it on an H100 (PERF.md): 19.9 ms of practice6_1's
// 1280x720 x 32 spp frame, 3.9 % of its byte roofline, at 71 registers, 43 KB
// of shared memory and 3 blocks (24 warps) an SM. Neither peak: the lanes'
// dependent chains (a light test is two divisions and a square root) at that
// occupancy, and the divergence left (walks of different lengths, 1-4
// lights a leaf, the candidate loop run by the lanes taken up only). Timed
// and left out (ms a frame): the tests at every visit 24.0-24.3 (postponing
// them is most of the gain over the per-chunk kernel's 46.2), 64 registers
// and 4 blocks an SM 21.3-21.4 (spills), the nodes read from device memory
// 21.1 (the staging gains 1 %), refills after 8 or 24 ended lanes 20.5-20.6
// and 23.7, tests at 8, 4 or 0 lanes still visiting 20.8, 20.0-20.1, 20.3,
// where 2 gives 19.8-19.9.

#pragma once

#include "bvh_node.cuh"
#include "common.cuh"
#include "lane_queue.cuh"

namespace {

constexpr int LR_WIDTH = 20;         // floats of a light record (ops/bvh.py:LIGHT_REC)
constexpr int LR_SPEC = LC_COUNT;    // its spec word (ops/bvh.py:LIGHT_REC_SPEC)
constexpr int kLightStack = 3 * 64;  // ops/bvh.py:WIDE_STACK
constexpr int kLightSharedStack = 16;  // entries of a thread's stack in shared memory
constexpr int kLightTop = 192;       // wide nodes staged in shared memory (24 KB)
constexpr int kLightQueue = 64;      // a warp's queue: up to 31 waiting + 32 drawn
static_assert(LR_WIDTH % 4 == 0, "a light record is whole 16-byte loads");

// Lanes of a warp that must have ended before the ended ones take new lanes,
// and lanes still visiting nodes at or below which the lanes that hold
// leaves test their lights (walk_lights).
constexpr int kLightRefill = 16;
constexpr int kLightLeafWait = 2;

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

// What K3 reads of the lights above 32: the pick's records (the base, so
// common.cuh's sample_light_dir reads them), the walk's records and the tree.
struct LightTree : LightRecs {
  const float4* leaf;   // (L, LR_WIDTH / 4): the records in the tree's order, 16-byte aligned
  const float4* nodes;  // (W, kLine) wide nodes, root 0, 16-byte aligned
  int n_nodes;
};

__device__ __forceinline__ float lane_of(float4 v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// One light's record in registers, read as LightRecs reads one (the row `j`
// is the record's own): add_light_pdf's rows are constants, so each read
// is a register.
struct LightRec {
  float4 q[LR_WIDTH / 4];
  __device__ __forceinline__ float L(int row, int) const { return lane_of(q[row >> 2], row & 3); }
  __device__ __forceinline__ V3 L3(int row, int j) const {
    return mk(L(row, j), L(row + 1, j), L(row + 2, j));
  }
  __device__ __forceinline__ int spec(int j) const { return __float_as_int(L(LR_SPEC, j)); }
};

__device__ __forceinline__ LightRec ldg_rec(const float4* r) {
  LightRec x;
#pragma unroll
  for (int k = 0; k < LR_WIDTH / 4; ++k) x.q[k] = __ldg(r + k);
  return x;
}

// A block's shared memory: the staged top of the tree, the first entries of
// each thread's stack, each warp's queue, the mbarrier the top's copy
// completes on: 43 KB, under the 48 KB of static shared memory.
struct LightShared {
  float4 top[kLightTop * kLine];
  int stack[kLightSharedStack][kBlock];
  int queue[kWarps][kLightQueue];
  unsigned long long bar;
};

// One warp's share of a batch of `b` lanes, as described at the top. Every
// lane of the warp calls it.
// * flag(i): does lane i sample (false beyond b is not asked);
// * idle(i): the stores of a lane that does not;
// * take(i, point, l): lane i's candidate loop, which gives the point and
//   the direction whose light pdf the walk sums;
// * finish(i, l, light): lane i's stores, given its light pdf (the terms
//   over the light count, as common.cuh pdf_lights returns it).
// Only the schedule across the warp is the warp's: a ray's visits, pushes and
// sum do not depend on its neighbours.
template <class Flag, class Idle, class Take, class Finish>
__device__ __forceinline__ void walk_lights(const LightTree& T, LightShared& s, int n_top,
                                            long long b, int* tick, Flag flag, Idle idle,
                                            Take take, Finish finish) {
  const int lane = threadIdx.x & 31;
  int* q = s.queue[threadIdx.x >> 5];
  int pending = 0;  // lanes in the warp's queue
  bool more = true;
  V3 point = mk(0.0f, 0.0f, 0.0f), l = point, inv = point;
  float total = 0.0f;
  int spill[kLightStack - kLightSharedStack];
  int sp = 0;
  int ray = -1;     // the lane's lane of the batch, -1: none
  int node = -1;    // the node to visit (or whose leaves are held); -1: the walk has ended
  int next = -1;    // the last entered internal child of the last visit
  int leaves = 0;   // the slots of `node` whose leaves wait for the warp's test
  // the go-to step after a visit and its leaves: the kept child, else a pop
  auto advance = [&]() {
    if (next >= 0) {
      node = next;
    } else if (sp > 0) {
      --sp;
      node = sp < kLightSharedStack ? s.stack[sp][threadIdx.x] : spill[sp - kLightSharedStack];
    } else {
      node = -1;
    }
  };
  for (;;) {
    const unsigned ended = __ballot_sync(FULL, node < 0);
    if (ended == FULL || __popc(ended) >= kLightRefill) {
      if (node < 0 && ray >= 0) {
        finish(ray, l, total / (float)max(T.num_lights, 1));
        ray = -1;
      }
      const int want = __popc(ended);
      // draw chunks of 32 lanes until `want` wait or the batch is used up
      while (more && pending < want) {
        int chunk = 0;
        if (lane == 0) chunk = atomicAdd(&tick[0], 1);
        chunk = __shfl_sync(FULL, chunk, 0);
        const long long base = (long long)chunk * 32;
        if (base >= b) {
          more = false;
          break;
        }
        const long long i = base + lane;
        const bool f = i < b && flag(i);
        const unsigned ballot = __ballot_sync(FULL, f);
        if (f) {
          q[pending + __popc(ballot & ((1u << lane) - 1u))] = (int)i;
        } else if (i < b) {
          idle(i);
        }
        pending += __popc(ballot);
        __syncwarp();
      }
      if (pending == 0 && ended == FULL) break;
      const int n_take = pending < want ? pending : want;
      const int rank = __popc(ended & ((1u << lane) - 1u));
      if (node < 0 && rank < n_take) ray = q[pending - 1 - rank];
      pending -= n_take;
      __syncwarp();  // the queue entries are read before the next draw writes
      if (node < 0 && ray >= 0) {
        take(ray, point, l);
        inv = mk(1.0f / l.x, 1.0f / l.y, 1.0f / l.z);
        total = 0.0f;
        sp = 0;
        node = 0;
      }
    }
    if (node >= 0 && leaves == 0) {  // a visit
      const Line c = node_line(s.top, T.nodes, node, n_top);
      next = -1;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int w = __float_as_int(lane_of(c.w, k));
        const int count = __float_as_int(lane_of(c.c, k));
        if (w < 0 && count == 0) continue;  // an empty slot
        const float t = box_entry(lane_of(c.lx, k), lane_of(c.ly, k), lane_of(c.lz, k),
                                  lane_of(c.hx, k), lane_of(c.hy, k), lane_of(c.hz, k), point,
                                  inv, 0.0f, INFINITY);
        if (t == INFINITY) continue;
        if (w >= 0) {
          if (next >= 0) {
            if (sp < kLightSharedStack)
              s.stack[sp][threadIdx.x] = next;
            else
              spill[sp - kLightSharedStack] = next;
            ++sp;
          }
          next = w;
        } else {
          leaves |= 1 << k;
        }
      }
      if (leaves == 0) advance();
    }
    const bool test_now =
        __popc(__ballot_sync(FULL, node >= 0 && leaves == 0)) <= kLightLeafWait;
    if (leaves != 0 && test_now) {
      // the held slots in slot order, each leaf's lights in record order:
      // the leaves' ranges shift down one at a time, so the test has one
      // call site
      const float4 words = node < n_top ? s.top[kLine * node + 6]
                                        : __ldg(T.nodes + (long long)kLine * node + 6);
      const float4 counts = node < n_top ? s.top[kLine * node + 7]
                                         : __ldg(T.nodes + (long long)kLine * node + 7);
      int r = 0, end = 0;
#pragma unroll 1
      for (;;) {
        if (r < end) {
          const LightRec rec = ldg_rec(T.leaf + (long long)r * (LR_WIDTH / 4));
          add_light_pdf(rec, r, point, l, total);
          ++r;
          continue;
        }
        if (leaves == 0) break;
        const int k = __ffs(leaves) - 1;
        leaves &= leaves - 1;
        r = (int)((unsigned)__float_as_int(lane_of(words, k)) & ~kLeafBit);
        end = r + __float_as_int(lane_of(counts, k));
      }
      advance();
    }
  }
}

}  // namespace
