// BVH nearest hit for NVIDIA Hopper (sm_90a), hand-written CUDA: kernel K6.
//
// rt_launch_bvh_nearest takes the place of the JAX package's BVH traversal,
// raytracing_course_2024_tpu/ops/treelet.py:nearest_hit_treelet (reached
// through ops/traverse.py:nearest_hit_bvh). That one is XLA, not Pallas: a
// TPU lane cannot gather per lane, so the JAX package cuts the SAH tree into
// 128-slot treelets and iterates dense tests over them. A GPU thread can walk
// the binary tree itself, which is what the reference does
// (src/bvh.rs:231-297), and what this kernel does: for each ray the nearest
// hit with t > tmin over the finite table, t (+inf on a miss) and the row of
// the table (0 on a miss). With a `live` mask a lane whose flag is 0 gets the
// miss and no walk. The plain PyTorch version is the chunked sweep over the
// same table (ops/traverse.py:bvh_nearest_plain), which the kernel matches bit
// for bit: t and the row, the lowest row on a tie.
//
// The walk, one ray per thread:
// * A stack walk of the host's binary SAH tree (ops/bvh.py), nearest child
//   first: at an internal node both children's boxes are tested, the nearer
//   one is entered and the farther one pushed with its entry distance. A
//   popped node whose entry lies beyond the best hit so far is dropped (the
//   reference's rule, src/bvh.rs:258-262). The stack has kStack entries, one
//   per level below the root at most; the host refuses a deeper tree
//   (ops/bvh.py:attach_bvh) and the launcher a depth above kStack, so the
//   walk never runs out of it.
// * Boxes are entered where their slab interval meets [tmin, best]: an entry
//   equal to the best hit is still entered, so that of primitives at equal t
//   the lowest row wins, as in the sweep. The boxes are padded by 1e-4
//   (ops/bvh.py:AABB_EPS), so a box that holds a primitive at t never starts
//   beyond t by rounding.
// * A leaf tests its primitives (rows start .. start + count) with the shape
//   tests of the fused kernels (common.cuh:test_entry): the same arithmetic
//   as the plain versions, op for op (--fmad=false, ops/kernels.py).
// * Nodes are 32 bytes, two float4: (min.xyz, a) (max.xyz, b), a = left
//   child | first row, b = right child | count with the top bit set for a
//   leaf (ops/bvh.py:build_bvh_nodes). Primitive records are three float4 in
//   table order (ops/bvh.py:build_bvh_records). At 81,920 triangles that is
//   about 5 MB of nodes and records, well inside the H100's 50 MB L2.
// * The batch walk is lane_queue.cuh:walk_chunk: the live lanes of a chunk
//   of kChunk tiles are ranked into full passes, so no warp walks the tree
//   for a few live lanes; a masked lane gets its two stores from the thread
//   that owns it.
//
// What bounds it on an H100: per live ray 24 B in and 8 B out, against ~40
// fp32 operations per visited node (two slab tests) and 53 per triangle
// tested. A ray of the 81,920-triangle scene visits some tens of nodes, so
// the operations are far above the bytes; but the walk is a chain of
// dependent loads and branches that diverge between the rays of a warp, so
// latency and divergence set its time, not either peak. This first version
// is the simple walk; wider nodes, ray reordering and persistent threads are
// left for later.

#include "common.cuh"
#include "lane_queue.cuh"

namespace {

constexpr int kStack = 64;  // ops/bvh.py:BVH_STACK
constexpr int kChunk = 2;   // tiles of a block's chunk (lane_queue.cuh:walk_chunk)

struct BvhParams {
  const float* ro[3];
  const float* rd[3];
  const float4* nodes;  // (m, 2)
  const float4* rec;    // (n, 3)
  const uint8_t* live;  // (b,) bool, or nullptr: every lane
  long long b;
  float tmin;
  float* t_out;  // (b,)
  int* i_out;    // (b,)
};

// Entry distance of the ray into the box, or INFINITY where the slab
// interval does not meet [tmin, limit]. An axis whose slab product is NaN
// (origin on the slab plane, direction 0 there) is left out by fminf/fmaxf.
__device__ __forceinline__ float box_entry(float4 lo, float4 hi, V3 ro, V3 inv, float tmin,
                                           float limit) {
  const float x0 = (lo.x - ro.x) * inv.x, x1 = (hi.x - ro.x) * inv.x;
  const float y0 = (lo.y - ro.y) * inv.y, y1 = (hi.y - ro.y) * inv.y;
  const float z0 = (lo.z - ro.z) * inv.z, z1 = (hi.z - ro.z) * inv.z;
  const float near = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fmaxf(fminf(z0, z1), tmin));
  const float far = fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fminf(fmaxf(z0, z1), limit));
  return near <= far ? near : INFINITY;
}

__device__ __forceinline__ void walk(const BvhParams& p, int i) {
  const V3 ro = mk(p.ro[0][i], p.ro[1][i], p.ro[2][i]);
  const V3 rd = mk(p.rd[0][i], p.rd[1][i], p.rd[2][i]);
  const V3 inv = mk(1.0f / rd.x, 1.0f / rd.y, 1.0f / rd.z);
  const float tmin = p.tmin;
  const float4* nodes = p.nodes;
  float best_t = INFINITY;
  int best_i = 0;
  int stack_node[kStack];
  float stack_t[kStack];
  int sp = 0;
  float4 lo = __ldg(&nodes[0]), hi = __ldg(&nodes[1]);
  bool go = box_entry(lo, hi, ro, inv, tmin, best_t) != INFINITY;
  while (go) {
    const int a = __float_as_int(lo.w), b = __float_as_int(hi.w);
    if (b < 0) {  // a leaf: rows a .. a + count
      const int end = a + (b & 0x7fffffff);
      for (int k = a; k < end; ++k) {
        float t, u, v;
        Facing f;
        if (test_entry<false>(p.rec, k, ro, rd, t, u, v, f, tmin) &&
            (t < best_t || (t == best_t && k < best_i))) {
          best_t = t;
          best_i = k;
        }
      }
    } else {  // both children: enter the nearer, push the farther
      const float4 llo = __ldg(&nodes[2 * a]), lhi = __ldg(&nodes[2 * a + 1]);
      const float4 rlo = __ldg(&nodes[2 * b]), rhi = __ldg(&nodes[2 * b + 1]);
      const float tl = box_entry(llo, lhi, ro, inv, tmin, best_t);
      const float tr = box_entry(rlo, rhi, ro, inv, tmin, best_t);
      if (tl != INFINITY || tr != INFINITY) {
        const bool left = tl <= tr;
        const float t_far = left ? tr : tl;
        if (t_far != INFINITY) {
          stack_node[sp] = left ? b : a;
          stack_t[sp] = t_far;
          ++sp;
        }
        lo = left ? llo : rlo;
        hi = left ? lhi : rhi;
        continue;
      }
    }
    go = false;  // pop the nearest pending node that can still hold a hit
    while (sp > 0) {
      --sp;
      if (stack_t[sp] <= best_t) {
        const int n = stack_node[sp];
        lo = __ldg(&nodes[2 * n]);
        hi = __ldg(&nodes[2 * n + 1]);
        go = true;
        break;
      }
    }
  }
  p.t_out[i] = best_t;
  p.i_out[i] = best_i;
}

__global__ void __launch_bounds__(kBlock) bvh_nearest_kernel(BvhParams p) {
  __shared__ ChunkQueueT<kChunk> queue;
  const long long b = p.b;
  walk_chunk<kChunk, 1, true>(
      b, queue, [&](long long i) { return i < b && (!p.live || p.live[i] != 0); },
      [&](long long i) {
        p.t_out[i] = INFINITY;
        p.i_out[i] = 0;
      },
      [&](int i) { walk(p, i); });
}

}  // namespace

// rays: host array of 6 device pointers (ro.x, ro.y, ro.z, rd.x, rd.y, rd.z),
// each (b,) f32. nodes: (n_nodes, 2) float4; depth: levels below the root on
// the tree's deepest path; rec: (n_prims, 3) float4 records; live: (b,) bool
// or null. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernel does not take, among them
// a tree deeper than its stack). Never synchronises.
extern "C" int rt_launch_bvh_nearest(const void* const* rays, const void* nodes, int n_nodes,
                                     int depth, const void* rec, int n_prims, long long b,
                                     float tmin, const void* live, void* t_out, void* i_out,
                                     void* stream) {
  if (b < 0 || b > 0x7fffffffLL || n_nodes < 1 || n_prims < 1 || depth < 0 || depth > kStack)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  BvhParams p{};
  for (int c = 0; c < 3; ++c) {
    p.ro[c] = static_cast<const float*>(rays[c]);
    p.rd[c] = static_cast<const float*>(rays[3 + c]);
  }
  p.nodes = static_cast<const float4*>(nodes);
  p.rec = static_cast<const float4*>(rec);
  p.live = static_cast<const uint8_t*>(live);
  p.b = b;
  p.tmin = tmin;
  p.t_out = static_cast<float*>(t_out);
  p.i_out = static_cast<int*>(i_out);
  bvh_nearest_kernel<<<chunk_grid<kChunk>(b), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// Launch geometry, for reports: out = {stack entries, tiles per chunk,
// resident blocks per SM}.
extern "C" void rt_bvh_nearest_geometry(int* out) {
  out[0] = kStack;
  out[1] = kChunk;
  out[2] = resident_blocks(bvh_nearest_kernel);
}
