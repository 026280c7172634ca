// Gridless-Poisson pair sweep for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel devicekmc_tpu/ops/pairwise_pallas.py:
// poisson_pairwise_pallas (_kernel):
//
//   V_i = sum_c q_c * erfc(r_ic / (sigma*sqrt2)) * k*e / r_ic
//
//   * minimum image in y and z under PBC (d - rintf(d * (1/l)) * l, the
//     product and the subtraction rounded apart), x open;
//   * a pair whose squared distance is 0 contributes 0.  That is the TPU
//     kernel's rule, (charged index == i) or r <= 0: the self pair has
//     x - x = 0 in every coordinate, and the minimum image of 0 is 0, so the
//     index test adds nothing.  (A subnormal squared distance, a separation
//     under 1.1e-19 Angstrom, counts as 0, as on hardware that flushes
//     subnormals.)
//   * erfc by Abramowitz & Stegun 7.1.26 (|err| <= 1.5e-7).
//
// Two bounds.  The data-sheet bound counts about 30 FP32 operations a pair
// (38 under PBC) against the card's 67 TFLOP/s; the bytes (16 a row, 8 a
// charged site) never bind.  The issue bound is what the arithmetic allows:
// the compiled loop's instructions a pair against 4 warp instructions a
// clock an SM, and its three special-function instructions (a reciprocal
// square root, a reciprocal, an exp2) against 16 lanes a clock an SM;
// tools/fly_sass.py counts both from the compiled loop.
//
// What the design does about it.
//
//   * A short pair: one rsqrt.approx of the squared distance gives 1/r and
//     r = d2 * (1/r), so there is no square root and no division by r; the
//     1e-10 (Angstrom to metres), 1/(sigma sqrt2) and A&S p scales are one
//     constant, t = rcp.approx(1 + c_r r); exp(-x^2) is one ex2.approx of
//     d2 times -(1e-10/(sigma sqrt2))^2 log2(e); k e is folded into the
//     charge when the tile is staged.  About 23 instructions and three
//     special-function instructions a pair, each approximation within 2
//     ulp (built without --use_fast_math; the PTX names each one).
//   * One 16-byte shared load a pair: the charged set is staged as float4
//     {x, y, z, q k e}; no index is kept (the rule above).
//   * Two rows a thread, so every shared value serves two pairs and two
//     independent chains interleave.
//   * The charged set is split over the blocks of a row block where rows
//     alone do not fill the card (poisson_grid in ops/pairwise.py); each
//     split writes its partial sums to a slot of its own and the block that
//     draws the row block's last ticket adds them in ascending order
//     (csrc/ticket.cuh): one launch a call, two calls bit-equal.
//   * The next tile's gather (index, then coordinates) is loaded into
//     registers while the current tile is used, and tiles alternate between
//     two shared buffers: one __syncthreads a tile.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "ticket.cuh"

namespace {

constexpr int kThreads = 128;  // threads a block == charged sites a tile
constexpr int kRows = 2;       // rows a thread
constexpr int kBlockRows = kThreads * kRows;

// A&S 7.1.26
constexpr float kA0 = 0.254829592f, kA1 = -0.284496736f, kA2 = 1.421413741f,
                kA3 = -1.453152027f, kA4 = 1.061405429f;

struct Scal {
  float c_r;   // p / (sigma sqrt2) * 1e-10: t = 1 / (1 + c_r r), r in Angstrom
  float c_e;   // -(1e-10 / (sigma sqrt2))^2 * log2(e): exp(-x^2) = 2^(c_e d2)
  float kq;    // k e * 1e10: 1 / r in metres is 1e10 / r in Angstrom
  float ly, lz, ily, ilz;
};

__device__ __forceinline__ float rsqrt_approx(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ float ex2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// c: the charged site as (x, y, z, q k e 1e10)
template <bool PBC>
__device__ __forceinline__ float pair(float xr, float yr, float zr, const float4 c,
                                      const Scal& sc) {
  const float dx = c.x - xr;
  float dy = c.y - yr;
  float dz = c.z - zr;
  if (PBC) {
    dy = __fsub_rn(dy, __fmul_rn(rintf(dy * sc.ily), sc.ly));
    dz = __fsub_rn(dz, __fmul_rn(rintf(dz * sc.ilz), sc.lz));
  }
  const float d2 = fmaf(dx, dx, fmaf(dy, dy, dz * dz));
  // 1/r, and 0 for a dead pair: its contribution is then 0 * (finite)
  const float ri = d2 >= FLT_MIN ? rsqrt_approx(d2) : 0.f;
  const float t = rcp_approx(fmaf(sc.c_r, d2 * ri, 1.f));
  const float poly = t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, kA4, kA3), kA2), kA1), kA0);
  return c.w * (poly * ex2_approx(sc.c_e * d2)) * ri;
}

// The charged site c as staged: its coordinates by its index, its charge
// times k e 1e10.
__device__ __forceinline__ float4 load_site(const float* __restrict__ coords,
                                            const int32_t* __restrict__ cidx,
                                            const float* __restrict__ cq, int c, float kq) {
  const int64_t ci = cidx[c];
  return make_float4(coords[3 * ci], coords[3 * ci + 1], coords[3 * ci + 2], cq[c] * kq);
}

// Grid (row blocks, splits of the charged set); split s takes the charged
// sites [s * chunk, min(n_c, (s + 1) * chunk)).  part: [splits][row blocks
// * kBlockRows] slots, cnt: a ticket a row block.
template <bool PBC>
__global__ void __launch_bounds__(kThreads)
poisson_pairwise_kernel(const float* __restrict__ coords, int n,
                        const int32_t* __restrict__ cidx, const float* __restrict__ cq,
                        int n_c, int chunk, Scal sc, float* part, int* cnt,
                        float* __restrict__ out) {
  __shared__ float4 buf[2][kThreads];
  __shared__ int s_flag;
  const int tid = threadIdx.x;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int row0 = blockIdx.x * kBlockRows;
  float xr[kRows], yr[kRows], zr[kRows], acc[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int i = row0 + j * kThreads + tid;
    xr[j] = yr[j] = zr[j] = 0.f;
    if (i < n) {
      xr[j] = coords[3 * (int64_t)i];
      yr[j] = coords[3 * (int64_t)i + 1];
      zr[j] = coords[3 * (int64_t)i + 2];
    }
    acc[j] = 0.f;
  }
  const int c0 = split * chunk, c1 = min(n_c, c0 + chunk);
  float4 next = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c0 + tid < c1) next = load_site(coords, cidx, cq, c0 + tid, sc.kq);
  int b = 0;
  for (int t0 = c0; t0 < c1; t0 += kThreads) {
    buf[b][tid] = next;
    __syncthreads();
    // the next tile's gather is in flight while this one is used; the other
    // buffer is free: every thread passed this tile's barrier after it
    // finished the tile before
    if (t0 + kThreads + tid < c1) {
      next = load_site(coords, cidx, cq, t0 + kThreads + tid, sc.kq);
    }
    const int m = min(kThreads, c1 - t0);
#pragma unroll 4
    for (int k = 0; k < m; ++k) {
      const float4 c = buf[b][k];
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[j] += pair<PBC>(xr[j], yr[j], zr[j], c, sc);
    }
    b ^= 1;
  }
  const int64_t n_pad = (int64_t)gridDim.x * kBlockRows;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    part[split * n_pad + row0 + j * kThreads + tid] = acc[j];
  }
  if (last_ticket(cnt, blockIdx.x, n_split, &s_flag)) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int i = row0 + j * kThreads + tid;
      if (i < n) {
        float v = 0.f;
        for (int s = 0; s < n_split; ++s) v += __ldcg(part + s * n_pad + i);
        out[i] = v;
      }
    }
  }
}

}  // namespace

// V [n] of the charged sites cidx [n_c] (int32) with charges cq [n_c] (f32)
// over the rows coords [n, 3] (f32).  inv_s = 1 / (sigma sqrt2) [1/m], kq =
// k e; n_split splits of ceil(n_c / n_split) charged sites each.  part:
// scratch of n_split * ceil(n / 256) * 256 floats and cnt: ceil(n / 256)
// int32 tickets that are 0 before the call and 0 again after it.  Returns
// the cudaError_t of the launch.
extern "C" int dkmc_poisson_pairwise(const void* coords, int n, const void* cidx,
                                     const void* cq, int n_c, float inv_s,
                                     float kq, float lat_y, float lat_z, int pbc,
                                     int n_split, void* part, void* cnt, void* out,
                                     void* stream) {
  if (n <= 0 || n_c < 0 || n_split <= 0 || n_split > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const double s = 1e-10 * (double)inv_s;
  Scal sc;
  sc.c_r = (float)(0.3275911 * s);
  sc.c_e = (float)(-s * s * 1.4426950408889634);
  sc.kq = (float)((double)kq * 1e10);
  sc.ly = lat_y;
  sc.lz = lat_z;
  sc.ily = 1.0f / lat_y;
  sc.ilz = 1.0f / lat_z;
  const int chunk = (n_c + n_split - 1) / n_split;
  const dim3 grid((unsigned)((n + kBlockRows - 1) / kBlockRows), (unsigned)n_split);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(coords);
  const int32_t* ci = static_cast<const int32_t*>(cidx);
  const float* q = static_cast<const float*>(cq);
  float* pt = static_cast<float*>(part);
  int* ct = static_cast<int*>(cnt);
  float* o = static_cast<float*>(out);
  if (pbc) {
    poisson_pairwise_kernel<true><<<grid, kThreads, 0, st>>>(c, n, ci, q, n_c, chunk, sc,
                                                             pt, ct, o);
  } else {
    poisson_pairwise_kernel<false><<<grid, kThreads, 0, st>>>(c, n, ci, q, n_c, chunk, sc,
                                                              pt, ct, o);
  }
  return (int)cudaGetLastError();
}
