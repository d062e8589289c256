// BVH nearest hit for NVIDIA Hopper (sm_90a), hand-written CUDA: kernel K6.
//
// rt_launch_bvh_nearest takes the place of the JAX package's BVH traversal,
// raytracing_course_2024_tpu/ops/treelet.py:nearest_hit_treelet (reached
// through ops/traverse.py:nearest_hit_bvh). That one is XLA, not Pallas: a
// TPU lane cannot gather per lane, so the JAX package cuts the SAH tree into
// 128-slot treelets and iterates dense tests over them. A GPU thread can walk
// a tree itself, as the reference does (src/bvh.rs:231-297), and that is what
// this kernel does: for each ray the nearest hit with t > tmin over the finite
// table, t (+inf on a miss) and the row of the table (0 on a miss). With a
// `live` mask a lane whose flag is 0 gets the miss and no walk. The plain
// PyTorch version is the chunked sweep over the same table
// (ops/traverse.py:bvh_nearest_plain), which the kernel matches bit for bit:
// t and the row, the lowest row on a tie. ops/traverse.py:walk_reference
// models the walk node for node.
//
// The tree: 4-wide nodes collapsed from the host's binary SAH tree
// (ops/bvh.py:build_bvh4_nodes), in breadth-first order. A wide node is one
// 128-byte line, eight float4: its four children's boxes as structure of
// arrays (lo.x[4] lo.y[4] lo.z[4] hi.x[4] hi.y[4] hi.z[4]), four child words
// (a wide node's index; a leaf as first row | the top bit; an empty slot as
// the top bit with count 0) and four counts (a leaf's rows). An empty slot's
// box is +inf on all six bounds: each of its slabs is +-inf (never NaN: the
// origin is finite), so the box test misses it like any box the ray does
// not meet, and a visit needs no test of the slot. Leaves are the
// binary tree's (at most a few rows, contiguous in table order); primitive
// records are three float4 in that order (ops/bvh.py:build_bvh_records). At
// 81,920 triangles that is ~14k lines (1.8 MB) and 3.9 MB of records, well
// inside the 50 MB L2. The line and its box test live in bvh_node.cuh, which
// K3's walk of the lights' own tree (light_tree.cuh) shares.
//
// The walk, one ray per thread. A visit is seven independent 16-byte loads
// of one line (the boxes and the child words, through one generic pointer
// into shared or device memory, so a warp whose lanes read both issues
// them once), four slab tests against [tmin, best] and a 4-element
// sorting network of integer min/max on keys that pack each child's entry
// distance and its slot into 32 bits (slot_key). The entered internal children are
// pushed farthest first and the nearest is kept; the entered leaves are
// tested at once, nearest first, each while its entry is still <= best (a
// leaf's count lives in the parent's line, read when its leaves are tested,
// so a leaf is never pushed); then
// the kept child is entered if its entry is still <= best, else the stack is
// popped until an entry is <= best. So a pop loads only the node it goes to.
// The result does not depend on the order: a box is entered when its entry is
// <= the best t (equality included, so of equal t the lowest row wins, as in
// the sweep), every leaf uses common.cuh:test_entry op for op, and a hit
// replaces the best when t < best or t == best and its row is lower. The
// boxes are padded by 1e-4 (ops/bvh.py:AABB_EPS), so a box that holds a hit
// at t never starts beyond t by rounding.
//
// The stack: a wide node pushes at most 3 entries, so a walk needs at most
// the host's bound (ops/bvh.py:Bvh4.stack: the most, over root-to-leaf paths,
// of the sum of children - 1), which is at most 3 per binary level: kStack =
// 3 x 64 entries take every binary tree that ops/bvh.py:attach_bvh accepts.
// An entry is 8 bytes (entry t, node). The first kSharedStack of a thread
// live in shared memory; deeper ones spill to local memory, which only the
// entries a ray actually reaches cost.
//
// The grid: persistent, SMs x resident blocks (lane_queue.cuh:grid_for). A
// block first stages the top kTop wide nodes (the first levels, contiguous
// by the breadth-first order) in shared memory with one bulk asynchronous
// copy completed on an mbarrier; reads of those nodes come from there. Each
// warp then draws chunks of 32 lanes from a counter in device memory
// (atomicAdd, one per warp and chunk), ranks their live lanes into its own
// queue in shared memory (ballot and popc, as lane_queue.cuh ranks a tile)
// and gives the masked lanes their (inf, 0). No warp waits at a block
// barrier for another warp's rays (walk_warp): a lane that ends its ray
// takes the next queued one once kRefill lanes of its warp have ended, and
// lanes that enter leaves hold them until at most kLeafWait lanes are still
// visiting nodes, then test them together (Aila and Laine's dynamic fetch
// and postponed leaf tests; a ray's own steps stay those above). tick[1]
// counts the warps that are done: the last sets both counters back to 0 for
// the next launch.
//
// What bounds it on an H100: per live ray 24 B in and 8 B out against, on
// the binary walk's yardstick (chip_smoke.py), 51 fp32 operations per
// internal node and 54 per primitive tested: a camera ray of the
// 81,920-triangle scene visits ~12 internal nodes and tests ~3.5 primitives,
// ~800 operations, so the operations are far above the bytes (the bound is
// ~0.011 ms for 921,600 rays), and K6 runs at 4-5 % of it. The wide walk
// visits ~6.7 wide nodes per camera ray (8.6 on bounce-1 rays); a visit is
// ~250 instructions a lane (96 of them the slab tests, the rest the keys,
// the network, the pushes and the pops), a primitive test ~120 with its
// record's loads. Neither peak sets the time, nor the bytes a visit reads:
// the lanes of a warp visit different nodes and do different work (visits,
// leaf tests, pops), so the warp issues each path's instructions for a few
// lanes at a time, and the instructions a warp issues per visit set K6's
// time. Timed on an H100 (PERF.md, PR 27): a 64-byte quantized node (four
// loads a visit in place of eight, ~50 more instructions to decode its
// boxes) made K6 10-12 % slower whatever part of the tree was staged (21,
// 85 or 341 nodes, laid out by node or by field); a staged top free of bank
// conflicts moved it by under 1 %; taking out the empty-slot test, the
// +inf case of the key and one of the two predicated copies of the loads
// made it 2-6 % faster. The wide nodes alone were slower than the binary
// walk; the postponed leaf tests and the refill are what brought the
// bounce rays below it.

#include "bvh_node.cuh"
#include "common.cuh"
#include "lane_queue.cuh"

namespace {

constexpr int kStack = 3 * 64;     // ops/bvh.py:WIDE_STACK
constexpr int kSharedStack = 8;    // entries of a thread's stack in shared memory
constexpr int kTop = 85;           // wide nodes staged in shared memory: 1 + 4 + 16 + 64
constexpr int kQueue = 64;         // a warp's queue: up to 31 waiting + 32 drawn

struct BvhParams {
  const float* ro[3];
  const float* rd[3];
  const float4* nodes;  // (n_nodes, 8)
  int n_nodes;
  const float4* rec;    // (n, 3)
  const uint8_t* live;  // (b,) bool, or nullptr: every lane
  long long b;
  float tmin;
  float* t_out;  // (b,)
  int* i_out;    // (b,)
  int* tick;     // 2 int32, zero between launches
};

struct BvhShared {
  float4 top[kTop * kLine];
  unsigned long long stack[kSharedStack][kBlock];
  int queue[kWarps][kQueue];
  unsigned long long bar;  // the mbarrier the top's copy completes on
};

// A child's sort key: its entry distance's bits with the slot in the low two
// (t >= 0, so the bits order as t does; the slot makes keys unique and the
// order of equal entries the slot order). A box the ray does not enter has
// t = +inf, whose bits are kMiss, so its key is kMiss | slot. Dropping t's
// two low bits lowers it by at most 3 ulp, which only lets a box in a little
// earlier: the walk compares that t with the best.
constexpr unsigned kMiss = 0x7f800000u;  // the bits of +inf: no entered key reaches it

__device__ __forceinline__ unsigned slot_key(float t, unsigned slot) {
  return (__float_as_uint(t) & 0x7ffffffcu) | slot;
}

__device__ __forceinline__ float key_t(unsigned key) { return __uint_as_float(key & ~3u); }

template <class T>
__device__ __forceinline__ T pick(unsigned slot, T a, T b, T c, T d) {
  return (slot & 2u) ? ((slot & 1u) ? d : c) : ((slot & 1u) ? b : a);
}

__device__ __forceinline__ void order(unsigned& a, unsigned& b) {
  const unsigned lo = min(a, b), hi = max(a, b);
  a = lo;
  b = hi;
}

// Lanes of a warp that must have ended before the ended ones take new rays,
// and lanes still visiting nodes at or below which the lanes that hold leaves
// test them (walk_warp).
constexpr int kRefill = 16;
constexpr int kLeafWait = 8;

// Draws chunks of 32 lanes from the launch's counter until `want` rays wait
// in the warp's queue `q` (holding `pending`) or the batch is used up
// (`more` false). A chunk's live lanes are ranked into the queue; its masked
// lanes get their (inf, 0) at once. Every lane of the warp calls it.
__device__ __forceinline__ void draw(const BvhParams& p, int* q, int& pending, bool& more,
                                     int want) {
  const int lane = threadIdx.x & 31;
  while (more && pending < want) {
    int chunk = 0;
    if (lane == 0) chunk = atomicAdd(&p.tick[0], 1);
    chunk = __shfl_sync(FULL, chunk, 0);
    const long long base = (long long)chunk * 32;
    if (base >= p.b) {
      more = false;
      break;
    }
    const long long i = base + lane;
    const bool flag = i < p.b && (!p.live || p.live[i] != 0);
    const unsigned ballot = __ballot_sync(FULL, flag);
    if (flag) {
      q[pending + __popc(ballot & ((1u << lane) - 1u))] = (int)i;
    } else if (i < p.b) {
      p.t_out[i] = INFINITY;
      p.i_out[i] = 0;
    }
    pending += __popc(ballot);
    __syncwarp();
  }
}

// One warp's share of the batch: each lane walks one ray at a time, as
// described at the top. Only the schedule across the warp is the warp's, so
// a ray's steps and result do not depend on its neighbours:
// * a lane that enters leaves at a visit holds them (and the child it would
//   go to next) until at most kLeafWait lanes are still visiting nodes; then
//   the holding lanes test their leaves together (Aila and Laine's postponed
//   leaf tests), so lanes do not idle through each other's primitive tests
//   at every visit;
// * once kRefill lanes have ended their rays (or all have), the ended lanes
//   store their results and take the next rays of the warp's queue, which
//   draws chunks as it runs dry, so a few long rays do not hold 32 lanes.
// Every lane of the warp calls it.
__device__ __forceinline__ void walk_warp(const BvhParams& p, BvhShared& s, int n_top) {
  const int lane = threadIdx.x & 31;
  int* q = s.queue[threadIdx.x >> 5];
  int pending = 0;  // rays in the warp's queue
  bool more = true;
  const float tmin = p.tmin;
  V3 ro = mk(0.0f, 0.0f, 0.0f), rd = ro, inv = ro;
  float best_t = INFINITY;
  int best_i = 0;
  unsigned long long spill[kStack - kSharedStack];
  int sp = 0;
  auto push = [&](int n, float t) {
    const unsigned long long e =
        ((unsigned long long)__float_as_uint(t) << 32) | (unsigned long long)(unsigned)n;
    if (sp < kSharedStack)
      s.stack[sp][threadIdx.x] = e;
    else
      spill[sp - kSharedStack] = e;
    ++sp;
  };
  int ray = -1;                // the lane's ray, -1: none
  int node = -1;               // the node to visit; -1: the ray has ended
  int next = -1;               // the nearest entered internal child of the last visit
  float t_next = INFINITY;
  // the go-to step after a visit and its leaves: the kept child if its entry
  // is still <= best, else the nearest pending node that can still hold a hit
  auto advance = [&]() {
    if (next >= 0 && t_next <= best_t) {
      node = next;
      return;
    }
    node = -1;
    while (sp > 0) {
      --sp;
      const unsigned long long e =
          sp < kSharedStack ? s.stack[sp][threadIdx.x] : spill[sp - kSharedStack];
      if (__uint_as_float((unsigned)(e >> 32)) <= best_t) {
        node = (int)(unsigned)e;
        return;
      }
    }
  };
  bool held = false;  // leaves entered at the last visit wait for the warp
  int w0 = 0, w1 = 0, w2 = 0, w3 = 0;
  unsigned k[4] = {0u, 0u, 0u, 0u};
  for (;;) {
    const unsigned ended = __ballot_sync(FULL, node < 0);
    if (ended == FULL || __popc(ended) >= kRefill) {
      if (node < 0 && ray >= 0) {
        p.t_out[ray] = best_t;
        p.i_out[ray] = best_i;
        ray = -1;
      }
      const int want = __popc(ended);
      draw(p, q, pending, more, want);
      if (pending == 0 && ended == FULL) break;
      const int take = pending < want ? pending : want;
      const int rank = __popc(ended & ((1u << lane) - 1u));
      if (node < 0 && rank < take) ray = q[pending - 1 - rank];
      pending -= take;
      __syncwarp();  // the queue entries are read before the next draw writes
      if (node < 0 && ray >= 0) {
        ro = mk(p.ro[0][ray], p.ro[1][ray], p.ro[2][ray]);
        rd = mk(p.rd[0][ray], p.rd[1][ray], p.rd[2][ray]);
        inv = mk(1.0f / rd.x, 1.0f / rd.y, 1.0f / rd.z);
        best_t = INFINITY;
        best_i = 0;
        sp = 0;
        node = 0;
      }
    }
    if (node >= 0 && !held) {  // a visit
      const float4* ln = line_ptr(s.top, p.nodes, node, n_top);
      const float4 lx = ln[0], ly = ln[1], lz = ln[2], hx = ln[3], hy = ln[4], hz = ln[5];
      const float4 wd = ln[6];
      w0 = __float_as_int(wd.x), w1 = __float_as_int(wd.y);
      w2 = __float_as_int(wd.z), w3 = __float_as_int(wd.w);
      // an empty slot's box lies at +inf: its key is a miss like any other
      k[0] = slot_key(box_entry(lx.x, ly.x, lz.x, hx.x, hy.x, hz.x, ro, inv, tmin, best_t), 0u);
      k[1] = slot_key(box_entry(lx.y, ly.y, lz.y, hx.y, hy.y, hz.y, ro, inv, tmin, best_t), 1u);
      k[2] = slot_key(box_entry(lx.z, ly.z, lz.z, hx.z, hy.z, hz.z, ro, inv, tmin, best_t), 2u);
      k[3] = slot_key(box_entry(lx.w, ly.w, lz.w, hx.w, hy.w, hz.w, ro, inv, tmin, best_t), 3u);
      order(k[0], k[1]);
      order(k[2], k[3]);
      order(k[0], k[2]);
      order(k[1], k[3]);
      order(k[1], k[2]);
      // entered internal children, farthest first: pushed, the nearest kept
      next = -1;
      t_next = INFINITY;
#pragma unroll
      for (int j = 3; j >= 0; --j) {
        const int w = pick(k[j] & 3u, w0, w1, w2, w3);
        if (k[j] < kMiss && w >= 0) {
          if (next >= 0) push(next, t_next);
          next = w;
          t_next = key_t(k[j]);
        }
        held = held || (k[j] < kMiss && w < 0);
      }
      if (!held) advance();
    }
    const bool test_now = __popc(__ballot_sync(FULL, node >= 0 && !held)) <= kLeafWait;
    if (held && test_now) {
      // entered leaves, nearest first, while their entry is <= best: the
      // keys shift down one at a time, so the test has one call site; the
      // counts from the visited node's line (node still names it)
      const float4 c = line_ptr(s.top, p.nodes, node, n_top)[7];
      int row = 0, end = 0;
#pragma unroll 1
      for (;;) {
        if (row < end) {
          float t, u, v;
          Facing f;
          if (test_entry<false>(p.rec, row, ro, rd, t, u, v, f, tmin) &&
              (t < best_t || (t == best_t && row < best_i))) {
            best_t = t;
            best_i = row;
          }
          ++row;
          continue;
        }
        if (k[0] >= kMiss) break;  // sorted: no entered child is left
        const unsigned slot = k[0] & 3u;
        const int w = pick(slot, w0, w1, w2, w3);
        if (w < 0 && key_t(k[0]) <= best_t) {
          row = (int)((unsigned)w & ~kLeafBit);
          end = row + __float_as_int(pick(slot, c.x, c.y, c.z, c.w));
        }
        k[0] = k[1], k[1] = k[2], k[2] = k[3], k[3] = 0xffffffffu;
      }
      held = false;
      advance();
    }
  }
}

__global__ void __launch_bounds__(kBlock) bvh_nearest_kernel(BvhParams p) {
  __shared__ __align__(128) BvhShared s;
  const int lane = threadIdx.x & 31;
  const int n_top = p.n_nodes < kTop ? p.n_nodes : kTop;
  stage_top(s.top, &s.bar, p.nodes, n_top);  // the top of the tree, in shared memory
  walk_warp(p, s, n_top);
  if (lane == 0 && atomicAdd(&p.tick[1], 1) == (int)gridDim.x * kWarps - 1) {
    p.tick[0] = 0;
    p.tick[1] = 0;
    __threadfence();
  }
}

}  // namespace

// rays: host array of 6 device pointers (ro.x, ro.y, ro.z, rd.x, rd.y, rd.z),
// each (b,) f32. nodes: (n_nodes, 8) float4 wide nodes, 128-byte aligned;
// stack: the entries the walk can need (ops/bvh.py:Bvh4.stack); rec:
// (n_prims, 3) float4 records; live: (b,) bool or null; tick: two int32,
// zero, which the launch leaves zero. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for arguments the kernel does not take, among
// them a walk that needs more than kStack entries). Never synchronises.
extern "C" int rt_launch_bvh_nearest(const void* const* rays, const void* nodes, int n_nodes,
                                     int stack, const void* rec, int n_prims, long long b,
                                     float tmin, const void* live, void* t_out, void* i_out,
                                     void* tick, void* stream) {
  if (b < 0 || b > 0x7fffffffLL || n_nodes < 1 || n_prims < 1 || stack < 0 || stack > kStack ||
      (reinterpret_cast<uintptr_t>(nodes) & 127) != 0)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  BvhParams p{};
  for (int c = 0; c < 3; ++c) {
    p.ro[c] = static_cast<const float*>(rays[c]);
    p.rd[c] = static_cast<const float*>(rays[3 + c]);
  }
  p.nodes = static_cast<const float4*>(nodes);
  p.n_nodes = n_nodes;
  p.rec = static_cast<const float4*>(rec);
  p.live = static_cast<const uint8_t*>(live);
  p.b = b;
  p.tmin = tmin;
  p.t_out = static_cast<float*>(t_out);
  p.i_out = static_cast<int*>(i_out);
  p.tick = static_cast<int*>(tick);
  const unsigned grid = grid_for(bvh_nearest_kernel, (b + kBlock - 1) / kBlock);
  bvh_nearest_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// Launch geometry, for reports: out = {stack entries, of them in shared
// memory per thread, wide nodes staged in shared memory, shared bytes per
// block, local bytes per thread, registers per thread, resident blocks per
// SM}.
extern "C" void rt_bvh_nearest_geometry(int* out) {
  cudaFuncAttributes a{};
  cudaFuncGetAttributes(&a, bvh_nearest_kernel);
  out[0] = kStack;
  out[1] = kSharedStack;
  out[2] = kTop;
  out[3] = (int)a.sharedSizeBytes;
  out[4] = (int)a.localSizeBytes;
  out[5] = a.numRegs;
  out[6] = resident_blocks(bvh_nearest_kernel);
}
