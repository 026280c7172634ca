// One launch, same bits: the integer ticket shared by the kernels that sum
// partial results of several blocks (csrc/wkb_fly.cu, csrc/pairwise.cu,
// csrc/transport_cg.cu, csrc/heat.cu).
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

// The same ticket drawn by thread 0 alone, right after it wrote the block's
// slot: one atomic with release and acquire semantics at the card's scope
// orders that slot before the ticket, and the other blocks' slots before the
// reads after it, so no fence waits for the block's other stores, which may
// go out while the atomic is in flight.  True where thread 0 drew the last
// of `expected` tickets (the ticket is then set back to 0); the caller hands
// the answer to its block through shared memory and a barrier.  Drawn
// before a block's scattered stores it is 0.6 us a launch faster than
// last_ticket there, whose fences and barriers wait for the atomic's round
// trip (tools/probe_cg_events.py --parts transport, transport_refine).
__device__ __forceinline__ bool last_ticket_acq_rel(int* cnt, int strip, int expected) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;"
               : "=r"(old) : "l"(cnt + strip) : "memory");
  const bool last = old == expected - 1;
  if (last) cnt[strip] = 0;
  return last;
}
