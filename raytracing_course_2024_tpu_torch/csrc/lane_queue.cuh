// The persistent grid and the queue of flagged lanes that every kernel of the
// port walks its batch with: the bounce kernels K1/K2 (bounce.cu) and the
// persistent round K5 (persistent.cu) through bounce_body.cuh, the dense
// nearest hit K4 (dense_nearest.cu) and the mixture sampler K3 (sampler.cu).
//
// * A persistent grid (K1, K2, K5): as many blocks as the card holds at once
//   (SM count x resident blocks, asked of the runtime by grid_for), each
//   drawing tiles of kTile lanes from a counter until none is left
//   (walk_tiles). A kernel's tables are staged once per block, not once per
//   256 lanes, and the blocks end together whatever share of their tiles had
//   nothing to do. K3 and K4, whose bodies are short, take one block per
//   chunk of tiles instead (walk_chunk): timed on an H100, their warps lost
//   more at a persistent block's barriers than staging their small tables
//   once per chunk costs.
// * Compaction of the flagged lanes (push_tile, walk_tiles): every thread
//   reads the flag of its own lane of a tile (alive, `need`, `live`), a
//   ballot and a prefix over the warps' counts give each flagged lane a dense
//   rank, and the lanes go to the block's queue in shared memory. Whenever a
//   block's worth of lanes waits, every thread takes one and runs the
//   kernel's body, so no warp walks the body for one flagged lane
//   (walk_chunk: a thread takes R lanes of its chunk's queue a pass). An
//   unflagged lane gets its few stores from the thread that owns it. A
//   lane's arithmetic is untouched, so its result does not depend on its
//   rank.
// Everything sits in an anonymous namespace: each translation unit that
// includes this header gets its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Threads per block, and lanes per tile: a thread owns one lane of a tile.
constexpr int kBlock = 256;
constexpr int kTile = kBlock;
constexpr int kWarps = kBlock / 32;
constexpr unsigned FULL = 0xffffffffu;
static_assert(kBlock % 32 == 0 && kWarps <= 32, "one warp scans the tile's warp counts");

// A tile is kTile consecutive lanes; thread t owns lane t of it. The block's
// queue holds the lanes (indices into the batch) that wait for the body: a
// tile's flagged lanes are appended in ascending order, and whenever kBlock
// or more wait, the last kBlock of them are taken, one per thread.
struct LaneQueue {
  int lane[kBlock + kTile];
  int count[kWarps];  // flagged lanes of each warp
  int ticket[2];      // the block's next ticket, double-buffered
};

// Appends the flagged lanes of the tile at `base` to the queue, which holds
// `len` lanes, and returns how many they are. Every thread of the block calls
// it (two block barriers). A thread reads the queue entry it takes before it
// runs the body, so the first barrier of the next call also orders those
// reads before this call's writes.
__device__ __forceinline__ int push_tile(bool flag, long long base, int len, LaneQueue& q) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(FULL, flag);
  if (lane == 0) q.count[warp] = __popc(ballot);
  __syncthreads();
  const int mine = lane < kWarps ? q.count[lane] : 0;
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int below = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += below;
  }
  const int first = __shfl_sync(FULL, incl - mine, warp);
  if (flag)
    q.lane[len + first + __popc(ballot & ((1u << lane) - 1u))] = (int)(base + threadIdx.x);
  const int n = __shfl_sync(FULL, incl, 31);
  __syncthreads();
  return n;
}

// Sum of `v` over the block, in thread 0 (one block barrier).
__device__ __forceinline__ int block_sum(int v, int* red) {
  v = __reduce_add_sync(FULL, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) total += red[w];
  return total;
}

// The walk K1 and K5 share (bounce.cu, persistent.cu). The block takes tiles of the batch's `b` lanes
// until none is left. Of each tile every thread asks `flag(i)` of its own
// lanes (is there a body to run for lane i; false beyond b), gives an
// unflagged lane its `idle(i)` at once, and the flagged lanes go through the
// queue to `run(i)`, so every pass over the body but the block's last runs
// with all threads busy, however few of a tile's lanes are live. `run` is
// called from one place only: the body is some thousand instructions, and a
// second copy of it in the loop cost more in instruction fetch than the walk
// saved. The two barriers per tile also keep the block's warps in step
// through that code; warps that walked on their own, without barriers,
// drifted apart and ran slower.
//
// The block's first tile is its own index. The others are handed out in
// order by a counter in device memory: ticket t = atomicAdd(tick[0]) is tile
// gridDim.x + t, so a block that drew cheap tiles (dead lanes) takes more of
// them and the blocks end together; a fixed tile-to-block map left some
// blocks a third more live lanes than others. Thread 0 draws a ticket one
// tile before the block needs it, so the atomic is in flight while the body
// runs, and the next tile's flags are read before the body too. tick[1]
// counts the blocks that are done: the last one sets both back to 0 for the
// next launch on the stream. Returns how many of this thread's own lanes were
// flagged. Every thread of the block must call it.
template <class Flag, class Idle, class Run>
__device__ __forceinline__ int walk_tiles(long long b, int* tick, LaneQueue& q, Flag flag,
                                          Idle idle, Run run) {
  const long long n_tiles = (b + kTile - 1) / kTile;
  int slot = 0, waiting = 0, flagged = 0;
  long long tile = blockIdx.x;
  int drawn = 0;  // thread 0: the ticket of the tile after `tile`
  if (threadIdx.x == 0 && tile < n_tiles) drawn = atomicAdd(&tick[0], 1);
  bool next = flag(tile * kTile + threadIdx.x);
  for (;;) {
    if (tile < n_tiles && waiting < kBlock) {
      const long long i = tile * kTile + threadIdx.x;
      const bool cur = next;
      flagged += cur;
      if (threadIdx.x == 0) q.ticket[slot] = drawn;
      waiting += push_tile(cur, tile * kTile, waiting, q);
      tile = (long long)gridDim.x + q.ticket[slot];
      slot ^= 1;  // a thread still reading this ticket is not overtaken by the next
      if (threadIdx.x == 0 && tile < n_tiles) drawn = atomicAdd(&tick[0], 1);
      next = flag(tile * kTile + threadIdx.x);
      if (i < b && !cur) idle(i);
    }
    const int take = waiting >= kBlock ? kBlock : (tile >= n_tiles ? waiting : 0);
    if (take > 0) {
      waiting -= take;
      if ((int)threadIdx.x < take) run(q.lane[waiting + threadIdx.x]);
    } else if (tile >= n_tiles) {
      break;
    }
  }
  if (threadIdx.x == 0 && atomicAdd(&tick[1], 1) == (int)gridDim.x - 1) {
    tick[0] = 0;
    tick[1] = 0;
    __threadfence();
  }
  return flagged;
}

// The walk for a body short enough that a block need not stay resident (K4's
// loop, K3's sampler): one block per chunk of C tiles (C x kTile lanes), as
// many blocks as the batch has chunks, so that the card's block scheduler
// balances the chunks and no warp waits at a barrier for another warp's
// body. The block ranks its chunk's flagged lanes at once (each thread owns
// C lanes of it; C ballots and one prefix over the C x kWarps counts) into
// its queue, gives an unflagged lane its `idle(i)`, and then every thread
// takes its lanes of the queue, R a pass, with no barrier between the
// passes; a warp whose entries have run out is done. Where every warp's tiles
// are all flagged or all idle (camera rays: whole image rows) the ranking
// would change nothing: one vote at the first barrier finds that out, and
// every thread runs its own lanes as a kernel without ranking would. The
// first barrier comes before any `run`, so it also orders what the caller
// staged in shared memory before the call. `flag`, `idle` and `run` as for
// walk_tiles. With ONE_CALL (R = 1) `run(i)` is called from one place, for a
// body that must not be copied (a second copy of K3's sampler in the kernel
// cost a third of its speed); without, the ranked and the unranked case each
// have their loop (K4: its loop is short, and the shared loop cost it 9 %).
// Every thread of the block must call it.
template <int C>
struct ChunkQueueT {
  int lane[C * kTile];
  int count[C * kWarps];  // flagged lanes of each warp, tile by tile
};

template <int C, int R, bool ONE_CALL, class Flag, class Idle, class Run>
__device__ __forceinline__ void walk_chunk(long long b, ChunkQueueT<C>& q, Flag flag, Idle idle,
                                           Run run) {
  static_assert(C * kWarps <= 32, "one warp scans the chunk's warp counts");
  static_assert(C % R == 0, "a thread's own lanes go in groups of R");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x * (C * kTile) + threadIdx.x;
  unsigned ballot[C];
  bool whole = true;  // each of this warp's tiles is all flagged or all idle
#pragma unroll
  for (int c = 0; c < C; ++c) {
    ballot[c] = __ballot_sync(FULL, flag(base + c * kTile));
    if (lane == 0) q.count[c * kWarps + warp] = __popc(ballot[c]);
    whole = whole && (ballot[c] == 0 || ballot[c] == FULL);
  }
  // The first barrier. Where every warp's tiles are whole, ranking would put
  // each lane where it is: every thread keeps its own lanes.
  const bool ranked = !__syncthreads_and(whole);
  int total = C * kTile;
  if (ranked) {
    const int mine = lane < C * kWarps ? q.count[lane] : 0;
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int below = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += below;
    }
    total = __shfl_sync(FULL, incl, 31);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int first = __shfl_sync(FULL, incl - mine, c * kWarps + warp);
      if ((ballot[c] >> lane) & 1u)
        q.lane[first + __popc(ballot[c] & ((1u << lane) - 1u))] = (int)(base + c * kTile);
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (!((ballot[c] >> lane) & 1u) && base + c * kTile < b) idle(base + c * kTile);
  if (ranked) __syncthreads();
  if constexpr (ONE_CALL) {
    // one loop for both cases: slot k of a pass is queue entry k, or without
    // ranking this thread's own lane of tile k / kBlock
    static_assert(R == 1, "the shared loop takes a lane per thread and pass");
    unsigned own = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) own |= ((ballot[c] >> lane) & 1u) << c;
#pragma unroll 1
    for (int k = threadIdx.x; k < total; k += kBlock) {
      int i = -1;
      if (ranked)
        i = q.lane[k];
      else if ((own >> (k / kBlock)) & 1u)
        i = (int)(blockIdx.x * (C * kTile) + k);
      if (i >= 0) run(i);
    }
  } else if (ranked) {
    for (int k = threadIdx.x; k < total; k += R * kBlock) {
      int lanes[R], m = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        lanes[r] = k + r * kBlock < total ? q.lane[k + r * kBlock] : -1;
        m += k + r * kBlock < total;
      }
      run(lanes, m);
    }
  } else {
#pragma unroll
    for (int g = 0; g < C; g += R) {
      int lanes[R], m = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        lanes[r] = -1;
        if (ballot[g + r] != 0) lanes[m++] = (int)(base + (g + r) * kTile);
      }
      if (m > 0) run(lanes, m);
    }
  }
}

// Blocks of a launch whose blocks take one chunk of C tiles each.
template <int C>
unsigned chunk_grid(long long b) {
  return (unsigned)((b + C * kTile - 1) / (C * kTile));
}

// Resident blocks per SM of a kernel at kBlock threads, and the card's SMs.
template <typename Kernel>
int resident_blocks(Kernel kernel) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock, 0);
  return per_sm;
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Blocks to launch when `wanted` blocks would cover the batch once: what the
// current device holds at once (its SMs x the kernel's resident blocks), or
// fewer when fewer do. Asked of the runtime at every launch (two attribute
// reads, no device work), so the answer is always the current device's.
template <typename Kernel>
unsigned grid_for(Kernel kernel, long long wanted) {
  const int sms = sm_count(), per_sm = resident_blocks(kernel);
  const long long held = (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  return (unsigned)(wanted < held ? wanted : held);
}

}  // namespace
