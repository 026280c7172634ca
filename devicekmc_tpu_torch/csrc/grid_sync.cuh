// A barrier of the whole grid of a cooperative launch (every block resident
// at once), for the kernels that finish a reduction and go on in the same
// launch (csrc/boundary_cg.cu, csrc/transport_cg.cu).
#pragma once

#include <cuda_runtime.h>

// reads of the barrier's counter before a waiting block gives up (a trap):
// seconds, where a barrier takes microseconds
constexpr long long kGridBarrierMaxPolls = 1LL << 24;

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned atom_add_release(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.add.release.gpu.global.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// A barrier of the whole grid on one counter: block 0 adds 2^31 - (blocks -
// 1), every other block 1, so the counter's top bit flips when the last
// block arrives and its low bits come back to where they were; each block
// waits until the bit differs from what it saw at its own arrival.  One
// atomic a block, no release step after the last arrival: thread 0's
// arrival releases the block's writes (after the opening __syncthreads),
// its poll acquires everyone's, and the block's threads read them past L1
// (__ldcg) after the closing __syncthreads.  Every block must be resident
// (a cooperative launch); a block that waits kGridBarrierMaxPolls reads
// traps, so that a fault ends the launch with an error instead of hanging
// the card.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    const unsigned old = atom_add_release(bar, add);
    for (long long polls = 0; ((old ^ ld_acquire(bar)) & 0x80000000u) == 0; ++polls)
      if (polls == kGridBarrierMaxPolls) __trap();
  }
  __syncthreads();
}
