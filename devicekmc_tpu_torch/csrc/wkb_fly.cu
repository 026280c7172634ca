// On-the-fly WKB tunnel block products for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of devicekmc_tpu/ops/wkb_pallas.py:
//   wkb_fly_matvec (_mv_kernel and the symmetric _mv_sym_kernel),
//   wkb_fly_matmat (_mm_kernel) and wkb_fly_pdisp (_pdisp_kernel).
//
// y = T x, Y = T X and the forward-current dissipation row sums
//   row[i] = sum_j [fwd_ij] (-T_ij dM_ij) (-dM_ij),  dM_ij = ms_i - ms_j,
//   fwd_ij = (T_ij dM_ij < 0 and Vd > 0) or (T_ij dM_ij > 0 and Vd < 0),
// for the metal x metal tunnel block T [n, n], whose
// entries are never stored: each is re-derived from the two atoms' positions
// and conduction-band edges by pair_val(), the arithmetic of the TPU
// kernels' _pair_vals in f32:
//
//   * y/z minimum image under PBC with rintf (round half to even);
//   * a pair is eligible when |dE| > ctol and it is not a neighbour pair
//     (dist < nn, which also excludes the self pair);
//   * trapezoidal barrier when qV0 - |dE| > 0, triangular when < 0, with
//     x^1.5 spelled x*sqrtf(x); the entry is the negated transmission;
//   * built without --use_fast_math: expf, sqrtf and the division are the
//     full-accuracy versions (nvcc may fuse a multiply and an add into an
//     FMA).
//
// Bound on this card: operations.  A pair costs about 30 FP32 operations
// (38 under PBC) with one expf, two sqrtf and one division, against 20
// bytes per atom read once; n^2 pairs (half of them in the symmetric form).
//
// Design.  The TPU kernels lean on a sequential grid with an accumulator
// carried in VMEM; on Hopper blocks run in no order, so every block owns one
// 128 x 128 tile of T, a thread per row, the column atoms staged in shared
// memory, and writes its partial sums to a scratch buffer slot that no other
// block writes.  A second kernel adds the slots of each row in a fixed
// order, so results (and with them CG iteration counts) repeat from run to
// run; no float atomics anywhere.
//
//   * matvec, plain form: tile (rt, ct) writes its 128 row sums to
//     part[ct][rt*128 + i].
//   * matvec, symmetric form: only tiles with ct >= rt run.  Each entry is
//     computed once and used for the row sum and, off the diagonal tiles,
//     for the column sum: the loop is skewed (thread i visits column
//     (i + s) mod 128 at step s) so that the lanes of a warp always hold 32
//     different columns and add into a per-warp column accumulator in shared
//     memory without conflicts; the four warps' accumulators are then added
//     in order.  Row sums go to part[ct][rt rows], column sums to
//     part[rt][ct rows]: every slot of part [nt, nt*128] is written once.
//   * matmat: the column tiles are dealt to `nsplit` blocks per row tile; a
//     thread keeps KB accumulators in registers, computes each pair value
//     once per group of KB columns and contracts with FP32 FMAs (never
//     TF32 tensor cores); part[split][row][col].  KB = 24 covers the
//     deflation basis of 24 columns in one sweep over the pairs.
//   * pdisp: the plain matvec's tiling with the column atoms' ms staged
//     beside them; tile (rt, ct) writes its 128 partial row sums to
//     part[ct][rt*128 + i].  Every pair adds to exactly one of rows i and j
//     (the sign of dM decides), so an upper-triangle form exists; this one
//     visits all n^2 pairs.  About 8 more FP32 operations a pair than the
//     matvec (dM, the product, two comparisons, select, negations, the
//     multiply-add): still bound by operations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;  // rows and columns per tile == threads per block

struct Scal {
  float prefac, qV0, ctol, nn, ly, lz;
  int pbc;
};

__device__ __forceinline__ float pair_val(float pxr, float pyr, float pzr, float cbr,
                                          float pxc, float pyc, float pzc, float cbc,
                                          const Scal& sc) {
  const float dx = pxr - pxc;
  float dy = pyr - pyc;
  float dz = pzr - pzc;
  if (sc.pbc) {
    dy = dy - rintf(dy / sc.ly) * sc.ly;
    dz = dz - rintf(dz / sc.lz) * sc.lz;
  }
  const float dist = sqrtf(dx * dx + dy * dy + dz * dz);
  const float abs_dE = fabsf(cbr - cbc);
  const bool elig = (abs_dE > sc.ctol) && !(dist < sc.nn);
  const float safe = elig ? abs_dE : 1.0f;
  const float s = sc.prefac * (dist * 1e-10f) / safe;
  const float E2 = sc.qV0 - safe;
  const float e15 = sc.qV0 * sqrtf(sc.qV0);
  const float E2p = E2 > 0.f ? E2 : 0.f;
  float T;
  if (E2 > 0.f) {
    T = expf(s * (e15 - E2p * sqrtf(E2p)));
  } else if (E2 < 0.f) {
    T = expf(s * e15);
  } else {
    T = 0.f;
  }
  return elig ? -T : 0.f;
}

template <bool SYM>
__global__ void __launch_bounds__(kTile)
fly_matvec_tiles(const float* __restrict__ pos, const float* __restrict__ cb,
                 const float* __restrict__ x, int n, Scal sc,
                 float* __restrict__ part, int n_pad) {
  const int rt = blockIdx.y, ct = blockIdx.x;
  if (SYM && ct < rt) return;
  __shared__ float sx[kTile], sy[kTile], sz[kTile], scb[kTile], sxv[kTile];
  __shared__ float scol[kTile / 32][kTile];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int c = ct * kTile + tid;
  if (c < n) {
    sx[tid] = pos[3 * (int64_t)c];
    sy[tid] = pos[3 * (int64_t)c + 1];
    sz[tid] = pos[3 * (int64_t)c + 2];
    scb[tid] = cb[c];
    sxv[tid] = x[c];
  } else {
    sx[tid] = sy[tid] = sz[tid] = scb[tid] = sxv[tid] = 0.f;
  }
  const bool col_part = SYM && ct > rt;
  if (col_part) {
    for (int w = 0; w < kTile / 32; ++w) scol[w][tid] = 0.f;
  }
  const int i = rt * kTile + tid;
  const bool row_ok = i < n;
  float pxr = 0.f, pyr = 0.f, pzr = 0.f, cbr = 0.f, xr = 0.f;
  if (row_ok) {
    pxr = pos[3 * (int64_t)i];
    pyr = pos[3 * (int64_t)i + 1];
    pzr = pos[3 * (int64_t)i + 2];
    cbr = cb[i];
    xr = x[i];
  }
  __syncthreads();
  const int n_cols = min(kTile, n - ct * kTile);
  float acc = 0.f;
  for (int s = 0; s < kTile; ++s) {
    const int k = SYM ? ((tid + s) & (kTile - 1)) : s;
    float v = 0.f;
    if (row_ok && k < n_cols) {
      v = pair_val(pxr, pyr, pzr, cbr, sx[k], sy[k], sz[k], scb[k], sc);
    }
    acc += v * sxv[k];
    if (col_part) {
      // the 32 lanes of a warp hold 32 different columns at every step
      scol[warp][k] += v * xr;
      __syncwarp();
    }
  }
  part[(int64_t)ct * n_pad + i] = acc;
  if (col_part) {
    __syncthreads();
    float cs = 0.f;
    for (int w = 0; w < kTile / 32; ++w) cs += scol[w][tid];
    part[(int64_t)rt * n_pad + ct * kTile + tid] = cs;
  }
}

// Forward-current dissipation partial row sums of one 128 x 128 tile.  vsgn
// is the sign of the bias (0 gives all zeros: neither clause holds).  Rows
// and columns beyond n are left out by index.
__global__ void __launch_bounds__(kTile)
fly_pdisp_tiles(const float* __restrict__ pos, const float* __restrict__ cb,
                const float* __restrict__ ms, int n, Scal sc, float vsgn,
                float* __restrict__ part, int n_pad) {
  const int rt = blockIdx.y, ct = blockIdx.x;
  __shared__ float sx[kTile], sy[kTile], sz[kTile], scb[kTile], sms[kTile];
  const int tid = threadIdx.x;
  const int c = ct * kTile + tid;
  if (c < n) {
    sx[tid] = pos[3 * (int64_t)c];
    sy[tid] = pos[3 * (int64_t)c + 1];
    sz[tid] = pos[3 * (int64_t)c + 2];
    scb[tid] = cb[c];
    sms[tid] = ms[c];
  } else {
    sx[tid] = sy[tid] = sz[tid] = scb[tid] = sms[tid] = 0.f;
  }
  const int i = rt * kTile + tid;
  const bool row_ok = i < n;
  float pxr = 0.f, pyr = 0.f, pzr = 0.f, cbr = 0.f, msr = 0.f;
  if (row_ok) {
    pxr = pos[3 * (int64_t)i];
    pyr = pos[3 * (int64_t)i + 1];
    pzr = pos[3 * (int64_t)i + 2];
    cbr = cb[i];
    msr = ms[i];
  }
  __syncthreads();
  const int n_cols = min(kTile, n - ct * kTile);
  const bool pos_bias = vsgn > 0.f, neg_bias = vsgn < 0.f;
  float acc = 0.f;
  if (row_ok) {
    for (int k = 0; k < n_cols; ++k) {
      const float v = pair_val(pxr, pyr, pzr, cbr, sx[k], sy[k], sz[k], scb[k], sc);
      const float dM = msr - sms[k];
      const float I_cal = v * dM;
      const bool fwd = (I_cal < 0.f && pos_bias) || (I_cal > 0.f && neg_bias);
      acc += fwd ? (-I_cal) * (-dM) : 0.f;
    }
  }
  part[(int64_t)ct * n_pad + i] = acc;
}

// out[e] = sum over s (ascending) of part[s * stride + e], e < count
__global__ void reduce_slots(const float* __restrict__ part, int n_slots,
                             int64_t stride, int64_t count,
                             float* __restrict__ out) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float acc = 0.f;
  for (int s = 0; s < n_slots; ++s) acc += part[(int64_t)s * stride + e];
  out[e] = acc;
}

template <int KB>
__global__ void __launch_bounds__(kTile)
fly_matmat_tiles(const float* __restrict__ pos, const float* __restrict__ cb,
                 const float* __restrict__ X, int n, int K, Scal sc, int n_tiles,
                 float* __restrict__ part) {
  const int rt = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int k0 = blockIdx.z * KB;
  __shared__ float sx[kTile], sy[kTile], sz[kTile], scb[kTile];
  __shared__ float sX[kTile][KB];
  const int tid = threadIdx.x;
  const int i = rt * kTile + tid;
  const bool row_ok = i < n;
  float pxr = 0.f, pyr = 0.f, pzr = 0.f, cbr = 0.f;
  if (row_ok) {
    pxr = pos[3 * (int64_t)i];
    pyr = pos[3 * (int64_t)i + 1];
    pzr = pos[3 * (int64_t)i + 2];
    cbr = cb[i];
  }
  float acc[KB];
#pragma unroll
  for (int q = 0; q < KB; ++q) acc[q] = 0.f;
  for (int ct = split; ct < n_tiles; ct += n_split) {
    const int c = ct * kTile + tid;
    if (c < n) {
      sx[tid] = pos[3 * (int64_t)c];
      sy[tid] = pos[3 * (int64_t)c + 1];
      sz[tid] = pos[3 * (int64_t)c + 2];
      scb[tid] = cb[c];
#pragma unroll
      for (int q = 0; q < KB; ++q) {
        sX[tid][q] = (k0 + q < K) ? X[(int64_t)c * K + k0 + q] : 0.f;
      }
    }
    __syncthreads();
    const int n_cols = min(kTile, n - ct * kTile);
    if (row_ok) {
      for (int k = 0; k < n_cols; ++k) {
        const float v = pair_val(pxr, pyr, pzr, cbr, sx[k], sy[k], sz[k], scb[k], sc);
#pragma unroll
        for (int q = 0; q < KB; ++q) acc[q] = fmaf(v, sX[k][q], acc[q]);
      }
    }
    __syncthreads();
  }
  if (row_ok) {
#pragma unroll
    for (int q = 0; q < KB; ++q) {
      if (k0 + q < K) part[((int64_t)split * n + i) * K + k0 + q] = acc[q];
    }
  }
}

template <int KB>
int launch_matmat(const float* pos, const float* cb, const float* X, int n, int K,
                  const Scal& sc, int n_tiles, int n_split, float* part,
                  cudaStream_t st) {
  dim3 grid(n_tiles, n_split, (K + KB - 1) / KB);
  fly_matmat_tiles<KB><<<grid, kTile, 0, st>>>(pos, cb, X, n, K, sc, n_tiles, part);
  return (int)cudaGetLastError();
}

}  // namespace

// y [n] = T x.  part: scratch of n_tiles * n_tiles * 128 floats, n_tiles =
// ceil(n / 128).  Returns the cudaError_t of the launches (0 on success).
extern "C" int dkmc_wkb_fly_matvec(const void* pos, const void* cb, const void* x,
                                   int n, float prefac, float qV0, float ctol,
                                   float nn, float ly, float lz, int pbc,
                                   int symmetric, void* part, void* y,
                                   void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int nt = (n + kTile - 1) / kTile;
  if (nt > 65535) return (int)cudaErrorInvalidValue;
  const int n_pad = nt * kTile;
  const Scal sc{prefac, qV0, ctol, nn, ly, lz, pbc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(nt, nt);
  if (symmetric) {
    fly_matvec_tiles<true><<<grid, kTile, 0, st>>>(
        static_cast<const float*>(pos), static_cast<const float*>(cb),
        static_cast<const float*>(x), n, sc, static_cast<float*>(part), n_pad);
  } else {
    fly_matvec_tiles<false><<<grid, kTile, 0, st>>>(
        static_cast<const float*>(pos), static_cast<const float*>(cb),
        static_cast<const float*>(x), n, sc, static_cast<float*>(part), n_pad);
  }
  int err = (int)cudaGetLastError();
  if (err) return err;
  reduce_slots<<<(n + 255) / 256, 256, 0, st>>>(static_cast<const float*>(part), nt,
                                               (int64_t)n_pad, (int64_t)n,
                                               static_cast<float*>(y));
  return (int)cudaGetLastError();
}

// row [n] = forward-current dissipation row sums for the atoms' scaled
// potentials ms [n]; vsgn: the sign of the bias (-1, 0 or 1).  part: scratch
// of n_tiles * n_tiles * 128 floats.  Returns the cudaError_t of the launches.
extern "C" int dkmc_wkb_fly_pdisp(const void* pos, const void* cb, const void* ms,
                                  int n, float prefac, float qV0, float ctol,
                                  float nn, float ly, float lz, int pbc,
                                  float vsgn, void* part, void* row, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int nt = (n + kTile - 1) / kTile;
  if (nt > 65535) return (int)cudaErrorInvalidValue;
  const int n_pad = nt * kTile;
  const Scal sc{prefac, qV0, ctol, nn, ly, lz, pbc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(nt, nt);
  fly_pdisp_tiles<<<grid, kTile, 0, st>>>(
      static_cast<const float*>(pos), static_cast<const float*>(cb),
      static_cast<const float*>(ms), n, sc, vsgn, static_cast<float*>(part), n_pad);
  int err = (int)cudaGetLastError();
  if (err) return err;
  reduce_slots<<<(n + 255) / 256, 256, 0, st>>>(static_cast<const float*>(part), nt,
                                               (int64_t)n_pad, (int64_t)n,
                                               static_cast<float*>(row));
  return (int)cudaGetLastError();
}

// Y [n, K] = T X for X [n, K] row-major.  part: scratch of n_split * n * K
// floats.  KB in {4, 8, 24}; ceil(K / KB) sweeps over the pairs.
extern "C" int dkmc_wkb_fly_matmat(const void* pos, const void* cb, const void* X,
                                   int n, int K, int KB, float prefac, float qV0,
                                   float ctol, float nn, float ly, float lz, int pbc,
                                   int n_split, void* part, void* Y, void* stream) {
  if (n <= 0 || K <= 0 || n_split <= 0 || n_split > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int nt = (n + kTile - 1) / kTile;
  const Scal sc{prefac, qV0, ctol, nn, ly, lz, pbc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pos);
  const float* c = static_cast<const float*>(cb);
  const float* xx = static_cast<const float*>(X);
  float* pt = static_cast<float*>(part);
  int err;
  switch (KB) {
    case 4: err = launch_matmat<4>(p, c, xx, n, K, sc, nt, n_split, pt, st); break;
    case 8: err = launch_matmat<8>(p, c, xx, n, K, sc, nt, n_split, pt, st); break;
    case 24: err = launch_matmat<24>(p, c, xx, n, K, sc, nt, n_split, pt, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  const int64_t count = (int64_t)n * K;
  reduce_slots<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(
      pt, n_split, count, count, static_cast<float*>(Y));
  return (int)cudaGetLastError();
}
