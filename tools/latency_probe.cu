// Latency probes of an NVIDIA Hopper card (sm_90a), for the latency bound of
// the KMC event loop (devicekmc_tpu_torch/csrc/kmc_events.cu): a chain of
// dependent loads, a run of block barriers, and a round of loads after
// another warp's stores.  Built and timed by chip_smoke.py (latencies) and
// tools/probe_cg_events.py; the package does not use it.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//     -Xcompiler -fPIC -o liblatency_probe.so tools/latency_probe.cu

#include <cuda_runtime.h>

namespace {

constexpr int kLoopThreads = 512;  // the event loop's block (kmc_events.cu kThreads)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRawLines = 7 * 32;

// The latency of one dependent load: one thread follows the chain next[] (a
// cycle through lines of 128 bytes, ld.global.cg past L1) for `hops` steps;
// the launch timed by the caller, over hops.
__global__ void chase_kernel(const int* __restrict__ next, int hops, int* sink) {
  int j = 0;
  for (int h = 0; h < hops; ++h) j = __ldcg(next + j);
  *sink = j;
}

// The latency of one __syncthreads of the event loop's block: `n` barriers
// in a row, the launch timed by the caller, over n.
__global__ void __launch_bounds__(kLoopThreads, 1) barrier_kernel(int n, int* sink) {
  __shared__ int s;
  if (threadIdx.x == 0) s = 0;
  for (int k = 0; k < n; ++k) {
    __syncthreads();
    if (threadIdx.x == (k & (kLoopThreads - 1))) s += k;
  }
  __syncthreads();
  if (threadIdx.x == 0) *sink = s;
}

// Read after write across the warps of one block: warp 0 stores one int to
// each of kRawLines lines of buf (a line every 32 ints), a barrier, then warp
// 1 loads those lines (cg: ld.global.cg, past L1), and then kRawLines lines
// that nothing stored; clock64() around each round of loads, into out[0]
// and out[1].
__global__ void raw_kernel(int* buf, int cg, long long* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0)
#pragma unroll
    for (int k = 0; k < kRawLines / 32; ++k) buf[(size_t)(k * 32 + lane) * 32] = k;
  __syncthreads();
  if (warp == 1) {
    int v[kRawLines / 32], acc = 0;
    const long long t0 = clock64();
#pragma unroll
    for (int k = 0; k < kRawLines / 32; ++k) {
      const int* a = buf + (size_t)(k * 32 + lane) * 32;
      v[k] = cg ? __ldcg(a) : *a;
    }
#pragma unroll
    for (int k = 0; k < kRawLines / 32; ++k) acc += v[k];
    acc = __reduce_add_sync(kFull, acc);
    const long long t1 = clock64();
#pragma unroll
    for (int k = 0; k < kRawLines / 32; ++k) {
      const int* a = buf + (size_t)(kRawLines + k * 32 + lane) * 32;
      v[k] = cg ? __ldcg(a) : *a;
    }
#pragma unroll
    for (int k = 0; k < kRawLines / 32; ++k) acc += v[k];
    acc = __reduce_add_sync(kFull, acc);
    const long long t2 = clock64();
    if (lane == 0) {
      out[0] = t1 - t0;
      out[1] = t2 - t1;
      out[2] = acc;
    }
  }
}

}  // namespace

// next [n] (int32; a cycle), sink [1]: `hops` dependent loads of the chain
// in one thread.  Returns the cudaError_t of the launch.
extern "C" int dkmc_chase(const void* next, int hops, void* sink, void* stream) {
  if (hops <= 0) return (int)cudaErrorInvalidValue;
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(next), hops, static_cast<int*>(sink));
  return (int)cudaGetLastError();
}

// n barriers of one block of the event loop's threads; sink [1].
extern "C" int dkmc_barriers(int n, void* sink, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  barrier_kernel<<<1, kLoopThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<int*>(sink));
  return (int)cudaGetLastError();
}

// buf: at least 2 * kRawLines * 32 int32 on the card, out: 3 int64.
extern "C" int dkmc_raw_probe(void* buf, int cg, void* out, void* stream) {
  raw_kernel<<<1, 64, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(buf), cg, static_cast<long long*>(out));
  return (int)cudaGetLastError();
}
