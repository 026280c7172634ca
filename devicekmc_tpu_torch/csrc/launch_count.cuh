// A launch counted on the card: the kernels of a captured superstep add one
// to their counter (ops/_build.py launch_counts) each time they run, so that
// the launches of a graph's replays are measured where they happen, not
// inferred from the host calls made while it was captured.
#pragma once

#include <cuda_runtime.h>

// The first thread of the grid's first block adds one to *count; no count
// when it is null.
__device__ __forceinline__ void count_launch(unsigned long long* count) {
  if (count != nullptr && threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0
      && blockIdx.z == 0)
    atomicAdd(count, 1ULL);
}
