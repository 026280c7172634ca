// Static banded-dense matvec of the blocked transport operator, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel devicekmc_tpu/ops/banded_pallas.py:
// banded_matvec_pallas (_kernel):
//
//   y[r, b] = sum_{k < m_pad, j < B} C4[r, k, b, j] * xp2[r + k, j]
//
// C4 [R, m_pad, B, B] holds the neighbour conductances of x-sorted atoms as
// zero-padded band blocks, stored f32 or bf16; xp2 [R + m_pad - 1, B] is the
// padded, permuted vector, f32 or in C4's type; the sum is taken in f32.
// transport_bf16_inner takes a bf16 C4 with an f32 vector: rounding the
// vector too would make the inner operator nonlinear noise of 2^-9 of the
// metal rows' 1e5 conductances, and its CG stall.
//
// Bound on this card: bytes.  C4 is read once (about 2 GB at crossbar width)
// against 2 operations per element; x and y are a few hundred KB.
// Design: one block per row block r.  The window xp2[r .. r+m_pad-1, :] is
// staged in shared memory as f32 once (m_pad * B * 4 bytes).  A warp takes
// one output row b at a time and walks k: its 32 lanes read 128 consecutive
// elements of C4[r, k, b, :] as one 16-byte (f32) or 8-byte (bf16) load
// each, so every request is a full coalesced line, multiply with the staged
// window and keep a partial sum per lane; one shuffle reduction per output
// row.  The k loop is unrolled so that several loads are in flight.  Blocks
// share nothing and every sum has a fixed order: the result repeats from run
// to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_count.cuh"

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  v[0] = __bfloat162float(a.x); v[1] = __bfloat162float(a.y);
  v[2] = __bfloat162float(b.x); v[3] = __bfloat162float(b.y);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// B is a multiple of 128: a lane owns elements j = 128*c + 4*lane .. +3
template <typename TC, typename TX>
__global__ void __launch_bounds__(kWarps * 32)
banded_matvec_kernel(const TC* __restrict__ C4, const TX* __restrict__ xp2, int m_pad,
                     int B, float* __restrict__ y, unsigned long long* count) {
  count_launch(count);
  extern __shared__ __align__(16) float xs[];  // [m_pad * B]
  const int r = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t win = (int64_t)m_pad * B;
  const TX* xw = xp2 + (int64_t)r * B;
  for (int64_t e = tid; e < win; e += blockDim.x) xs[e] = to_float(xw[e]);
  __syncthreads();
  const TC* Cr = C4 + (int64_t)r * m_pad * B * B;
  for (int b = warp; b < B; b += kWarps) {
    float acc = 0.f;
    for (int c = 0; c < B; c += 128) {
      const int j = c + 4 * lane;
#pragma unroll 4
      for (int k = 0; k < m_pad; ++k) {
        float v[4];
        load4(Cr + ((int64_t)k * B + b) * B + j, v);
        const float4 xk = *reinterpret_cast<const float4*>(xs + (int64_t)k * B + j);
        acc = fmaf(v[0], xk.x, acc);
        acc = fmaf(v[1], xk.y, acc);
        acc = fmaf(v[2], xk.z, acc);
        acc = fmaf(v[3], xk.w, acc);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) y[(int64_t)r * B + b] = acc;
  }
}

template <typename TC, typename TX>
int launch(const void* C4, const void* xp2, int R, int m_pad, int B, void* y,
           unsigned long long* count, cudaStream_t st) {
  const size_t smem = (size_t)m_pad * B * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(banded_matvec_kernel<TC, TX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  banded_matvec_kernel<TC, TX><<<R, kWarps * 32, smem, st>>>(
      static_cast<const TC*>(C4), static_cast<const TX*>(xp2), m_pad, B,
      static_cast<float*>(y), count);
  return (int)cudaGetLastError();
}

}  // namespace

// y [R, B] f32.  c_bf16, x_bf16: storage types of C4 and xp2 (f32 C4 with
// a bf16 xp2 is refused).  B % 128 == 0.  count: the launch counter on the
// card (null: none).  Returns the cudaError_t of the launch (0 on success).
extern "C" int dkmc_banded_matvec_out(const void* C4, const void* xp2, int R, int m_pad,
                                      int B, int c_bf16, int x_bf16, void* y, void* count,
                                      void* stream) {
  if (R <= 0 || m_pad <= 0 || B <= 0 || B % 128 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* cnt = static_cast<unsigned long long*>(count);
  if (!c_bf16) {
    return x_bf16 ? (int)cudaErrorInvalidValue
                  : launch<float, float>(C4, xp2, R, m_pad, B, y, cnt, st);
  }
  return x_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(C4, xp2, R, m_pad, B, y, cnt, st)
                : launch<__nv_bfloat16, float>(C4, xp2, R, m_pad, B, y, cnt, st);
}

extern "C" int dkmc_banded_matvec(const void* C4, const void* xp2, int R, int m_pad,
                                  int B, int c_bf16, int x_bf16, void* y, void* stream) {
  return dkmc_banded_matvec_out(C4, xp2, R, m_pad, B, c_bf16, x_bf16, y, nullptr, stream);
}
