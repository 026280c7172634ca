// Static band product of the blocked transport operator, for NVIDIA Hopper
// (sm_90a), from the band's nonzeros.
//
// Replaces the TPU kernel devicekmc_tpu/ops/banded_pallas.py:
// banded_matvec_pallas (_kernel):
//
//   y[r*B + b] = sum_{k < m_pad, j < B} C4[r, k, b, j] * xw[(r + k)*B + j]
//
// C4 [R, m_pad, B, B] (the JAX package's dense band blocks) holds the static
// neighbour conductances of x-sorted atoms: 0.22 % of its entries at the
// crossbar's width (17.83 a row of 8,192), so this kernel reads only the
// nonzeros (ops/banded.py, BandSlots): row i = r*B + b has slots (o, v), o =
// k*B + j its window offset (a uint16: m_pad*B <= 65,536) and v the value,
// f32 or bf16 (transport_bf16_inner), in ascending offset order.  xw
// [(R + m_pad - 1)*B] is the padded, permuted f32 vector; the sums are f32.
//
// Bound on this card: bytes, but few of them (the slots' 6 or 4 bytes, the
// window once, the output: about 9 MB at the crossbar, under 3 us); what a
// launch costs is its latency.  Layout: a sliced ELL.  Rows go in slices of
// 32, a warp a slice and a lane a row; a slice is padded to its longest row,
// rounded up to kGroup slots (pads: offset 0, value 0), and stored
// slot-group-major, so that a lane's kGroup slots are contiguous (one 8-byte
// load of offsets, one 16- or 8-byte load of values) and the warp's loads of
// a group are one contiguous run.  The vector is gathered straight from xw,
// which stays in L1 and L2 (343 KB at the crossbar; a row's neighbours lie
// within its 32 KB window, and the slice's rows share it), rather than
// staged in shared memory: the staged form took 0.0062-0.0063 ms at the
// crossbar's band against the direct gather's 0.0056
// (tools/probe_cg_events.py --parts transport, BAND_VARIANTS; PERF.md).
//
// Sum order: each row sums its slots in ascending order, a multiply then an
// add, each rounded (__fmul_rn, __fadd_rn: no fused multiply-add), pads
// included; ops/banded.py banded_matvec_plain does the same arithmetic, so
// the two are bit-equal.  No atomics: the result repeats run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_count.cuh"

namespace {

constexpr int kThreads = 256;  // rows a block
constexpr int kSlice = 32;     // rows a slice: a warp
constexpr int kGroup = 4;      // slots a lane loads at once

__device__ __forceinline__ void load_vals(const float* p, float (&v)[kGroup]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load_vals(const __nv_bfloat16* p, float (&v)[kGroup]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  v[0] = __bfloat162float(a.x); v[1] = __bfloat162float(a.y);
  v[2] = __bfloat162float(b.x); v[3] = __bfloat162float(b.y);
}

__device__ __forceinline__ void load_offs(const uint16_t* p, int (&o)[kGroup]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  o[0] = q.x & 0xffff; o[1] = q.x >> 16; o[2] = q.y & 0xffff; o[3] = q.y >> 16;
}

// n_rows = R*B rows (B a multiple of 32); start [n_rows / 32 + 1]: the
// first element of each slice, a multiple of 32 * kGroup
template <typename TV>
__global__ void __launch_bounds__(kThreads)
banded_slots_kernel(const uint16_t* __restrict__ off, const TV* __restrict__ val,
                    const int* __restrict__ start, const float* __restrict__ xw,
                    int n_rows, int B, float* __restrict__ y, unsigned long long* count) {
  count_launch(count);
  const int row = (int)blockIdx.x * kThreads + (int)threadIdx.x;
  const float* x = xw + (int64_t)(row / B) * B;
  if (row >= n_rows) return;
  const int s = row / kSlice, lane = row % kSlice;
  const int e0 = start[s], groups = (start[s + 1] - e0) / (kSlice * kGroup);
  const uint16_t* o = off + e0 + lane * kGroup;
  const TV* v = val + e0 + lane * kGroup;
  float acc = 0.f;
#pragma unroll 4
  for (int g = 0; g < groups; ++g) {
    int oi[kGroup];
    float vi[kGroup];
    load_offs(o + g * kSlice * kGroup, oi);
    load_vals(v + g * kSlice * kGroup, vi);
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      acc = __fadd_rn(acc, __fmul_rn(vi[q], __ldg(x + oi[q])));
    }
  }
  y[row] = acc;
}

template <typename TV>
int launch(const void* off, const void* val, const void* start, const void* xw, int R,
           int m_pad, int B, void* y, unsigned long long* count, cudaStream_t st) {
  const int n_rows = R * B;
  banded_slots_kernel<TV><<<(n_rows + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const uint16_t*>(off), static_cast<const TV*>(val),
      static_cast<const int*>(start), static_cast<const float*>(xw), n_rows, B,
      static_cast<float*>(y), count);
  return (int)cudaGetLastError();
}

}  // namespace

// y [R*B] f32 from the band's slots (off: uint16 window offsets, val: f32,
// or bf16 if v_bf16, start: int32 [R*B/32 + 1]) and the f32 window xw
// [(R + m_pad - 1)*B].  B % 32 == 0, m_pad*B <= 65,536.  count: the launch
// counter on the card (null: none).  Returns the cudaError_t of the launch
// (0 on success).
extern "C" int dkmc_banded_matvec_out(const void* off, const void* val, const void* start,
                                      const void* xw, int R, int m_pad, int B, int v_bf16,
                                      void* y, void* count, void* stream) {
  if (R <= 0 || m_pad <= 0 || B <= 0 || B % kSlice != 0 || (int64_t)m_pad * B > 65536)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* cnt = static_cast<unsigned long long*>(count);
  return v_bf16 ? launch<__nv_bfloat16>(off, val, start, xw, R, m_pad, B, y, cnt, st)
                : launch<float>(off, val, start, xw, R, m_pad, B, y, cnt, st);
}

extern "C" int dkmc_banded_matvec(const void* off, const void* val, const void* start,
                                  const void* xw, int R, int m_pad, int B, int v_bf16,
                                  void* y, void* stream) {
  return dkmc_banded_matvec_out(off, val, start, xw, R, m_pad, B, v_bf16, y, nullptr, stream);
}
