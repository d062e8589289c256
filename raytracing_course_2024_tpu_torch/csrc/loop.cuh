// The lane loops' counters on the device (ops/loop.py:LoopState) and the
// tail that ends a round test: N5 (loop.cu) after its pass over the lanes,
// K5 (persistent.cu) after its round.
//
// loop (6,) int64: n, more, refill, path vertices, rounds, refills;
// preds (2,) bool: the IF nodes' predicates more, refill;
// scratch (3,) int64: two partial counts and a block ticket, 0 between
// launches (the last block leaves them so).
#pragma once

#include <stdint.h>

struct LoopOut {
  long long* loop;
  bool* preds;
  unsigned long long* scratch;
};

// Thread 0 of each block: adds the block's two counts into the partial
// counts and takes a ticket. True in the last block of the grid, which then
// holds both totals in `a` and `b` and has set the scratch back to 0.
__device__ __forceinline__ bool last_block_totals(const LoopOut& o, long long& a, long long& b) {
  if (a) atomicAdd(&o.scratch[0], (unsigned long long)a);
  if (b) atomicAdd(&o.scratch[1], (unsigned long long)b);
  __threadfence();
  if (atomicAdd(&o.scratch[2], 1ull) != gridDim.x - 1) return false;
  __threadfence();
  a = (long long)atomicExch(&o.scratch[0], 0ull);
  b = (long long)atomicExch(&o.scratch[1], 0ull);
  o.scratch[2] = 0;
  return true;
}

// Writes a round test's outcome: n, more and refill, `verts` added to the
// path vertices, a round counted when the test admits one (so the count is
// the rounds run once the test says stop), a refill counted when it says
// refill, and the IF nodes' predicates.
__device__ __forceinline__ void write_round(const LoopOut& o, long long n, bool more,
                                            bool refill, long long verts) {
  o.loop[0] = n;
  o.loop[1] = more;
  o.loop[2] = refill;
  o.loop[3] += verts;
  o.loop[4] += more;
  o.loop[5] += refill;
  o.preds[0] = more;
  o.preds[1] = refill;
}
