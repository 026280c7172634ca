// One launch, same bits: the integer ticket shared by the kernels that sum
// partial results of several blocks (csrc/wkb_fly.cu, csrc/pairwise.cu).
//
// Blocks run in no order, so every block writes its partial sums to a
// scratch slot that no other block writes and then takes a ticket of the
// output strip they belong to; the block that draws the strip's last ticket
// adds the strip's slots in ascending order.  No float atomics: two calls on
// the same input give the same bits.
#pragma once

#include <cuda_runtime.h>

// Takes a ticket of `strip` after this block's slots were written; true in
// every thread of the block that drew the last of `expected` tickets, which
// may then read all slots of the strip (with __ldcg: they were written by
// other blocks).  The last block sets the ticket back to 0, ready for the
// next call on this stream.
__device__ __forceinline__ bool last_ticket(int* cnt, int strip, int expected,
                                            int* s_flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(&cnt[strip], 1) == expected - 1;
    if (last) cnt[strip] = 0;
    *s_flag = last;
  }
  __syncthreads();
  const bool last = *s_flag != 0;
  if (last) __threadfence();
  return last;
}
