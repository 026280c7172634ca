// On-the-fly WKB tunnel block products for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of devicekmc_tpu/ops/wkb_pallas.py:
//   wkb_fly_matvec (_mv_kernel and the symmetric _mv_sym_kernel),
//   wkb_fly_matmat (_mm_kernel) and wkb_fly_pdisp (_pdisp_kernel).
//
// y = T x, Y = T X and the forward-current dissipation row sums
//   row[i] = sum_j [fwd_ij] (-T_ij dM_ij) (-dM_ij),  dM_ij = ms_i - ms_j,
//   fwd_ij = (T_ij dM_ij < 0 and Vd > 0) or (T_ij dM_ij > 0 and Vd < 0),
// for the metal x metal tunnel block T [n, n], whose entries are never
// stored: each is re-derived from the two atoms' positions and
// conduction-band edges by pair_val(), the arithmetic of the TPU kernels'
// _pair_vals in f32:
//
//   * y/z minimum image under PBC with rintf (round half to even);
//   * a pair is eligible when |dE| > ctol and it is not a neighbour pair
//     (dist < nn, which also excludes the self pair); an ineligible pair is
//     an exact 0;
//   * trapezoidal barrier when qV0 - |dE| > 0, triangular when < 0 (one
//     expression: the clamped E2 is 0 there), an exact 0 when == 0; the
//     entry is the negated transmission.
//
// Two bounds.  The data-sheet bound counts about 30 FP32 operations a pair
// (38 under PBC) against the card's 67 TFLOP/s; the bytes (20 an atom) never
// bind.  The issue bound is what the arithmetic itself allows: the inner
// loop's instructions a pair against 4 warp instructions a clock an SM, and
// its special-function instructions (two square roots, a reciprocal, an
// exp2) against 16 lanes a clock an SM; tools/fly_sass.py counts both from
// the compiled loop.
//
// What the design does about it.
//
//   * The pair value is most of the cost, so it is made short: everything
//     that depends on the launch only (prefac * 1e-10, qV0^1.5, 1/ly, 1/lz,
//     the squared neighbour threshold) comes in with the scalars; the two
//     square roots of the value are sqrt.approx and its division is a
//     product with rcp.approx (each within 2 ulp; the exp stays expf, the
//     file is built without --use_fast_math); the two barrier branches are
//     one expression.  Loops are unrolled so that several independent pair
//     chains are in flight in a thread.
//   * Which entries are exact zeros is decided as the plain version decides
//     it, bit for bit: the squared distance is summed in its order without
//     FMA contraction and compared with a threshold nn2 chosen on the host
//     so that d2 < nn2 iff sqrtf(d2) < nn; the minimum image rounds d * (1/l)
//     and falls back to the true quotient where that product lies too near
//     a half-integer to decide.
//   * Work that is provably zero is not done.  Atoms deep in one contact
//     share their CB edge to within ctol, so all their pairs are ineligible.
//     Columns are handled in chunks of 32 with the chunk's smallest and
//     largest CB edge beside them; a row whose edge is within ctol of both
//     has only exact zeros in that chunk (rounding is monotone: fl(a - b) <=
//     fl(a - min) <= ctol), and a warp leaves a chunk that all its 32 rows
//     skip (chunk_skip_plain in ops/wkb_fly.py is the same test in PyTorch).
//   * One launch a call, and the same bits every time (csrc/ticket.cuh):
//     every block writes its partial sums to a scratch slot of its own and
//     takes an integer ticket of the output strip they belong to; the block
//     that draws the last ticket adds the strip's slots in ascending order.
//     No float atomics: results, and with them CG iteration counts, repeat
//     from run to run.
//   * matvec and pdisp: one tile loop (tile_sweep), whose per-pair step is
//     a functor (MatvecOp multiplies by x, PdispOp routes the dissipation
//     term); a block owns one 128 x 128 tile with 4 * S warps (S = 1 or 4,
//     chosen from n so that the card is full at small n too); warp
//     (rg, seg) owns rows rg*32.. and the column chunks seg, seg+S, ...  In
//     a chunk lane l visits column (l + s) mod 32 at step s, so the lanes
//     read 32 different shared-memory banks.  Symmetric form: only tiles
//     with ct >= rt are in the grid (one-dimensional, decoded to (rt, ct));
//     every value is used for its row sum and its column sum.  The column
//     sums need no shared memory and no synchronisation in the loop: the
//     partial sum of column (l + s) sits in lane l's register and moves one
//     lane on after every step (one __shfl_sync and one FMA a pair), so that
//     after 32 steps lane l holds the whole sum of column l.  On the
//     diagonal tile chunks below the diagonal are left out, the diagonal
//     chunks give row sums only and the column sums join the row sums.
//     Row sums go to part[ct][rt rows], column sums to part[rt][ct rows]:
//     each of the nt slots of a strip is written once.
//   * matmat: a thread per row keeps KB accumulators in registers and
//     contracts with FP32 FMAs (never TF32 tensor cores); the X tile sits in
//     shared memory as float4, so 24 FMAs take 6 broadcast loads; the column
//     tiles are dealt to n_split blocks a row tile (16 where there are as
//     many: enough blocks at n = 3,527, balanced skips at 24,768).
//     It visits ordered pairs: a form that uses every value twice would need
//     a scratch slot of K floats per column and row *tile* (nt * n * K
//     floats, 461 MB at n = 24,768) for the column sums, and its 2 K FMAs a
//     pair value stay; the chunk skip gives the larger saving.
//   * pdisp runs the symmetric form: each unordered pair once, its term
//     routed to the row, the column or neither by the sign of the current
//     it carries (PdispOp), so that it computes half the pair values of a
//     sweep over all n^2 ordered pairs and no term changes, only the order
//     of the sums.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch_count.cuh"
#include "ticket.cuh"

namespace {

constexpr int kTile = 128;   // rows and columns per tile
constexpr int kChunk = 32;   // columns per skip chunk == lanes of a warp
constexpr int kChunks = kTile / kChunk;
constexpr unsigned kFull = 0xffffffffu;

struct Scal {
  float ps;    // prefac * 1e-10 (positions are in Angstrom)
  float qV0;
  float e15;   // qV0^1.5
  float ctol;
  float nn2;   // the least float whose correctly rounded square root is >= nn
  float ly, lz, ily, ilz;
  int pbc;
};

// Approximate square root and reciprocal (each within 2 ulp) for the pair's
// *value* only; what decides whether an entry is an exact 0 (the minimum
// image, the distance test, |dE| > ctol, E2 != 0) is computed with the
// correctly rounded operations of the plain version, in its order.
__device__ __forceinline__ float fly_sqrt(float x) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
// b is 1 or an energy difference above ctol: never subnormal
__device__ __forceinline__ float fly_div(float a, float b) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(b));
  return a * r;
}

// How far q is from deciding rintf(d / l) when q = d * fl(1 / l): q is within
// 3 * 2^-24 |q| of the correctly rounded quotient, so the two round to
// different integers only if q lies that near a half-integer; positive when
// q is safely away from one (q - rintf(q) is exact).
__device__ __forceinline__ float half_margin(float q, float r) {
  return fabsf(fabsf(q - r) - 0.5f) - 1e-6f * (1.0f + fabsf(q));
}

// c: the column atom as (x, y, z, CB edge)
__device__ __forceinline__ float pair_val(float pxr, float pyr, float pzr, float cbr,
                                          const float4 c, const Scal& sc) {
  const float cbc = c.w;
  const float dx = pxr - c.x;
  float dy = pyr - c.y;
  float dz = pzr - c.z;
  if (sc.pbc) {
    // d - rintf(d / l) * l with the quotient taken as a product; the true
    // division only where the product cannot decide the rounding
    const float qy = dy * sc.ily, qz = dz * sc.ilz;
    float ry = rintf(qy);
    float rz = rintf(qz);
    if (fminf(half_margin(qy, ry), half_margin(qz, rz)) <= 0.f) {
      ry = rintf(__fdiv_rn(dy, sc.ly));
      rz = rintf(__fdiv_rn(dz, sc.lz));
    }
    dy = __fsub_rn(dy, __fmul_rn(ry, sc.ly));
    dz = __fsub_rn(dz, __fmul_rn(rz, sc.lz));
  }
  // (dx dx + dy dy) + dz dz with every product and sum rounded, as the plain
  // version does: the neighbour test must see the same squared distance
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz));
  const float abs_dE = fabsf(cbr - cbc);
  // d2 < nn2 exactly when sqrtf(d2) < nn (Scal::nn2)
  const bool elig = (abs_dE > sc.ctol) && !(d2 < sc.nn2);
  const float safe = elig ? abs_dE : 1.0f;
  const float s = fly_div(sc.ps * fly_sqrt(d2), safe);
  const float E2 = sc.qV0 - safe;
  const float E2p = fmaxf(E2, 0.f);
  const float T = expf(s * (sc.e15 - E2p * fly_sqrt(E2p)));
  return (elig && E2 != 0.f) ? -T : 0.f;
}

// The column atoms of tile ct, staged by threads 0..127 of the block (warp w
// stages chunk w and leaves its smallest and largest CB edge).  Columns
// beyond n sit at the origin with the operand entry `pad` (a finite pair
// value meets it and adds nothing) and do not enter the chunk's range.
struct ColTile {
  float4 p[kTile];   // x, y, z, CB edge: one 16-byte load a pair
  float v[kTile];    // the operand's entry
  float cmin[kChunks], cmax[kChunks];
};

__device__ __forceinline__ void stage_cols(ColTile& t, const float* __restrict__ pos,
                                           const float* __restrict__ cb,
                                           const float* __restrict__ v, float pad, int n,
                                           int ct, int tid) {
  const int c = ct * kTile + tid;
  const bool ok = c < n;
  float lo = INFINITY, hi = -INFINITY;
  if (ok) {
    lo = hi = cb[c];
    t.p[tid] = make_float4(pos[3 * (int64_t)c], pos[3 * (int64_t)c + 1],
                           pos[3 * (int64_t)c + 2], lo);
    t.v[tid] = v ? v[c] : 0.f;
  } else {
    t.p[tid] = make_float4(0.f, 0.f, 0.f, 0.f);
    t.v[tid] = pad;
  }
#pragma unroll
  for (int off = kChunk / 2; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(kFull, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, off));
  }
  if ((tid & (kChunk - 1)) == 0) {
    t.cmin[tid / kChunk] = lo;
    t.cmax[tid / kChunk] = hi;
  }
}

// True when every pair of this warp's rows with the chunk's columns is
// ineligible by its CB edges alone (an exact 0): the whole warp votes.
__device__ __forceinline__ bool chunk_skip(const ColTile& t, int cg, float cbr,
                                           bool row_ok, float ctol) {
  const bool mine = !row_ok ||
      ((cbr - t.cmin[cg] <= ctol) && (t.cmax[cg] - cbr <= ctol));
  return __all_sync(kFull, mine);
}

// out[e] = sum over s (ascending) of part[s * stride + e] for the 128
// elements of one strip, by threads 0..127.
__device__ __forceinline__ void add_strip(const float* part, int n_slots, int64_t stride,
                                          int strip, int n, float* __restrict__ out,
                                          int tid) {
  const int e = strip * kTile + tid;
  if (tid < kTile && e < n) {
    float acc = 0.f;
    // unrolled so that several loads are in flight; the adds keep their order
#pragma unroll 8
    for (int s = 0; s < n_slots; ++s) acc += __ldcg(part + (int64_t)s * stride + e);
    out[e] = acc;
  }
}

// Index of the first upper-triangle tile of row q, rows first: row q holds
// the tiles (q, q) .. (q, nt - 1).
__device__ __forceinline__ int64_t tri_first(int q, int nt) {
  return (int64_t)q * nt - (int64_t)q * (q - 1) / 2;
}

// (rt, ct) of the t-th upper-triangle tile.
__device__ __forceinline__ void tri_decode(int t, int nt, int& rt, int& ct) {
  const double b = 2.0 * nt + 1.0;
  int r = (int)((b - sqrt(b * b - 8.0 * t)) * 0.5);
  r = max(0, min(r, nt - 1));
  while (r + 1 < nt && tri_first(r + 1, nt) <= t) ++r;
  while (r > 0 && tri_first(r, nt) > t) --r;
  rt = r;
  ct = r + (int)(t - tri_first(r, nt));
}

// What a pair adds to its row's sum and to its column's sum, for the
// matvec: the pair value times the column's and the row's entry of x.
// Rows and columns beyond n take pad() as their entry.
struct MatvecOp {
  __device__ __forceinline__ static float pad() { return 0.f; }
  __device__ __forceinline__ void operator()(float v, float r, float c, float& acc,
                                             float& cacc) const {
    acc = fmaf(v, c, acc);
    cacc = fmaf(v, r, cacc);
  }
};

// The dissipation sweep: r and c are the row's and the column's scaled
// potentials ms.  With dM = r - c and I = v dM, the term t = I dM is the
// TPU kernel's (-I)(-dM) bit for bit (negation is exact); the pair in the
// other order has dM and I negated exactly and so the same t.  t goes to the
// row when (i, j) carries forward current, fwd(I): I vsgn < 0, and to the
// column when (j, i) does, fwd(-I): I vsgn > 0; to neither when I or the
// bias is 0.  Beyond n the entry is a NaN: every comparison with it fails,
// so pad rows and columns add nothing either way.
struct PdispOp {
  __device__ __forceinline__ static float pad() { return __int_as_float(0x7fc00000); }
  float vsgn;
  __device__ __forceinline__ void operator()(float v, float r, float c, float& acc,
                                             float& cacc) const {
    const float dM = r - c;
    const float I = v * dM;
    const float t = I * dM;
    const float Is = I * vsgn;
    acc += Is < 0.f ? t : 0.f;
    cacc += Is > 0.f ? t : 0.f;
  }
};

// One 128 x 128 tile of a sweep over the pairs, out = the row sums of
// op's terms (the column sums too in the symmetric form).  v: the operand
// (x of the matvec, ms of the dissipation sweep).
template <bool SYM, int S, class Op>
__device__ __forceinline__ void tile_sweep(const float* __restrict__ pos,
                                           const float* __restrict__ cb,
                                           const float* __restrict__ v, int n,
                                           const Scal& sc, int nt, float* part, int* cnt,
                                           float* __restrict__ out, const Op op) {
  int rt, ct;
  if (SYM) {
    tri_decode(blockIdx.x, nt, rt, ct);
  } else {
    rt = blockIdx.y;
    ct = blockIdx.x;
  }
  __shared__ ColTile col;
  __shared__ float srow[S][kTile];
  __shared__ float scol[kChunks][kTile];
  __shared__ int s_flag;
  const int tid = threadIdx.x;
  const int lane = tid & (kChunk - 1);
  const int warp = tid / kChunk;
  const int rg = warp % kChunks, seg = warp / kChunks;
  const int n_pad = nt * kTile;
  if (tid < kTile) stage_cols(col, pos, cb, v, Op::pad(), n, ct, tid);
  const int i = rt * kTile + rg * kChunk + lane;
  const bool row_ok = i < n;
  float pxr = 0.f, pyr = 0.f, pzr = 0.f, cbr = 0.f, vr = Op::pad();
  if (row_ok) {
    pxr = pos[3 * (int64_t)i];
    pyr = pos[3 * (int64_t)i + 1];
    pzr = pos[3 * (int64_t)i + 2];
    cbr = cb[i];
    vr = v[i];
  }
  __syncthreads();
  const bool diag = SYM && rt == ct;
  float acc = 0.f;
  for (int cg = seg; cg < kChunks; cg += S) {
    float cacc = 0.f;
    const bool below = diag && cg < rg;
    if (!below && !chunk_skip(col, cg, cbr, row_ok, sc.ctol)) {
      const int base = cg * kChunk;
#pragma unroll 4
      for (int s = 0; s < kChunk; ++s) {
        const int k = base + ((lane + s) & (kChunk - 1));
        const float val = pair_val(pxr, pyr, pzr, cbr, col.p[k], sc);
        op(val, vr, col.v[k], acc, cacc);
        // lane l holds the partial sum of column (l + s); hand it one lane on
        if (SYM) cacc = __shfl_sync(kFull, cacc, (lane + 1) & (kChunk - 1));
      }
    }
    if (SYM) scol[rg][cg * kChunk + lane] = (diag && cg == rg) ? 0.f : cacc;
  }
  srow[seg][rg * kChunk + lane] = acc;
  __syncthreads();
  if (tid < kTile) {
    float r = 0.f;
#pragma unroll
    for (int g = 0; g < S; ++g) r += srow[g][tid];
    if (SYM) {
      float c = 0.f;
#pragma unroll
      for (int g = 0; g < kChunks; ++g) c += scol[g][tid];
      // on the diagonal tile rows and columns are the same atoms
      if (diag) r += c; else part[(int64_t)rt * n_pad + ct * kTile + tid] = c;
    }
    part[(int64_t)ct * n_pad + rt * kTile + tid] = r;
  }
  if (last_ticket(cnt, rt, nt, &s_flag)) add_strip(part, nt, n_pad, rt, n, out, tid);
  if (SYM && ct > rt) {
    if (last_ticket(cnt, ct, nt, &s_flag)) add_strip(part, nt, n_pad, ct, n, out, tid);
  }
}

template <bool SYM, int S>
__global__ void __launch_bounds__(kTile * S)
fly_matvec_tiles(const float* __restrict__ pos, const float* __restrict__ cb,
                 const float* __restrict__ x, int n, Scal sc, int nt,
                 float* part, int* cnt, float* __restrict__ y, unsigned long long* count) {
  count_launch(count);
  tile_sweep<SYM, S>(pos, cb, x, n, sc, nt, part, cnt, y, MatvecOp{});
}

// Forward-current dissipation row sums over the upper-triangle tiles, each
// unordered pair once; vsgn is the sign of the bias (0 gives all zeros).
template <int S>
__global__ void __launch_bounds__(kTile * S)
fly_pdisp_tiles(const float* __restrict__ pos, const float* __restrict__ cb,
                const float* __restrict__ ms, int n, Scal sc, float vsgn, int nt,
                float* part, int* cnt, float* __restrict__ row) {
  tile_sweep<true, S>(pos, cb, ms, n, sc, nt, part, cnt, row, PdispOp{vsgn});
}

template <int KB>
__global__ void __launch_bounds__(kTile)
fly_matmat_tiles(const float* __restrict__ pos, const float* __restrict__ cb,
                 const float* __restrict__ X, int n, int K, Scal sc, int nt,
                 float* part, int* cnt, float* __restrict__ Y) {
  constexpr int KQ = KB / 4;
  const int rt = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int k0 = blockIdx.z * KB;
  __shared__ ColTile col;
  __shared__ float4 sX[kTile][KQ];
  __shared__ int s_flag;
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
  float4 acc[KQ];
#pragma unroll
  for (int q = 0; q < KQ; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  float* sXf = reinterpret_cast<float*>(&sX[0][0]);
  for (int ct = split; ct < nt; ct += n_split) {
    stage_cols(col, pos, cb, nullptr, 0.f, n, ct, tid);
    // consecutive threads read consecutive floats of X (one run when KB == K)
    for (int e = tid; e < kTile * KB; e += kTile) {
      const int c = ct * kTile + e / KB, q = k0 + e % KB;
      sXf[e] = (c < n && q < K) ? X[(int64_t)c * K + q] : 0.f;
    }
    __syncthreads();
    for (int cg = 0; cg < kChunks; ++cg) {
      if (chunk_skip(col, cg, cbr, row_ok, sc.ctol)) continue;
#pragma unroll 2
      for (int k = cg * kChunk; k < (cg + 1) * kChunk; ++k) {
        const float v = pair_val(pxr, pyr, pzr, cbr, col.p[k], sc);
#pragma unroll
        for (int q = 0; q < KQ; ++q) {
          const float4 xv = sX[k][q];
          acc[q].x = fmaf(v, xv.x, acc[q].x);
          acc[q].y = fmaf(v, xv.y, acc[q].y);
          acc[q].z = fmaf(v, xv.z, acc[q].z);
          acc[q].w = fmaf(v, xv.w, acc[q].w);
        }
      }
    }
    __syncthreads();
  }
  // part [n_split][nt * 128][gridDim.z * KB]: the block's own tile of it
  const int n_pad = nt * kTile, k_pad = gridDim.z * KB;
  float4* mine = reinterpret_cast<float4*>(
      part + ((int64_t)split * n_pad + i) * k_pad + k0);
#pragma unroll
  for (int q = 0; q < KQ; ++q) mine[q] = acc[q];
  if (last_ticket(cnt, rt * gridDim.z + blockIdx.z, n_split, &s_flag)) {
    // thread t adds elements t, t + 128, ... of the tile's [128][KB] block,
    // slot after slot: KB independent loads in flight, the adds in order
    float sum[KB];
#pragma unroll
    for (int j = 0; j < KB; ++j) sum[j] = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float* slot = part + ((int64_t)s * n_pad + rt * kTile) * k_pad + k0;
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        const int e = tid + j * kTile;
        sum[j] += __ldcg(slot + (int64_t)(e / KB) * k_pad + e % KB);
      }
    }
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      const int e = tid + j * kTile;
      const int r = rt * kTile + e / KB, q = k0 + e % KB;
      if (r < n && q < K) Y[(int64_t)r * K + q] = sum[j];
    }
  }
}

template <int KB>
int launch_matmat(const float* pos, const float* cb, const float* X, int n, int K,
                  const Scal& sc, int nt, int n_split, float* part, int* cnt, float* Y,
                  cudaStream_t st) {
  dim3 grid(nt, n_split, (K + KB - 1) / KB);
  fly_matmat_tiles<KB><<<grid, kTile, 0, st>>>(pos, cb, X, n, K, sc, nt, part, cnt, Y);
  return (int)cudaGetLastError();
}

template <bool SYM>
int launch_matvec(const float* pos, const float* cb, const float* x, int n,
                  const Scal& sc, int nt, int col_split, float* part, int* cnt, float* y,
                  unsigned long long* count, cudaStream_t st) {
  const dim3 grid = SYM ? dim3((unsigned)((int64_t)nt * (nt + 1) / 2)) : dim3(nt, nt);
  switch (col_split) {
    case 1:
      fly_matvec_tiles<SYM, 1><<<grid, kTile, 0, st>>>(pos, cb, x, n, sc, nt, part, cnt, y,
                                                        count);
      break;
    case 4:
      fly_matvec_tiles<SYM, 4><<<grid, 4 * kTile, 0, st>>>(pos, cb, x, n, sc, nt, part, cnt,
                                                            y, count);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The least float t with sqrtf(t) >= nn (0 when no distance is below nn): the
// correctly rounded square root is monotone, so sqrtf(d2) < nn iff d2 < t,
// and the kernels compare squared distances.
float nn_squared(float nn) {
  if (!(nn > 0.f)) return 0.f;
  float t = nn * nn;
  while (t > 0.f && sqrtf(t) >= nn) t = nextafterf(t, 0.f);
  while (sqrtf(t) < nn) t = nextafterf(t, INFINITY);
  return t;
}

Scal scalars(float prefac, float qV0, float ctol, float nn, float ly, float lz, int pbc) {
  Scal sc;
  sc.ps = (float)((double)prefac * 1e-10);
  sc.qV0 = qV0;
  sc.e15 = qV0 * sqrtf(qV0);
  sc.ctol = ctol;
  sc.nn2 = nn_squared(nn);
  sc.ly = ly;
  sc.lz = lz;
  sc.ily = 1.0f / ly;
  sc.ilz = 1.0f / lz;
  sc.pbc = pbc;
  return sc;
}

}  // namespace

// All three functions launch one kernel on `stream` and return its
// cudaError_t (0 on success).  n_tiles = ceil(n / 128).  `cnt` holds int32
// tickets that are 0 before the call and 0 again after it; calls that share
// it must be ordered on one stream.

// y [n] = T x.  part: scratch of n_tiles * n_tiles * 128 floats; cnt: n_tiles
// tickets; col_split in {1, 4}: 128 * col_split threads a tile; count: the
// launch counter on the card (null: none).
extern "C" int dkmc_wkb_fly_matvec_out(const void* pos, const void* cb, const void* x,
                                       int n, float prefac, float qV0, float ctol,
                                       float nn, float ly, float lz, int pbc,
                                       int symmetric, int col_split, void* part, void* cnt,
                                       void* y, void* count, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int nt = (n + kTile - 1) / kTile;
  if (nt > 65535) return (int)cudaErrorInvalidValue;
  const Scal sc = scalars(prefac, qV0, ctol, nn, ly, lz, pbc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pos);
  const float* c = static_cast<const float*>(cb);
  const float* xx = static_cast<const float*>(x);
  float* pt = static_cast<float*>(part);
  int* ct = static_cast<int*>(cnt);
  float* yy = static_cast<float*>(y);
  auto* cn = static_cast<unsigned long long*>(count);
  return symmetric ? launch_matvec<true>(p, c, xx, n, sc, nt, col_split, pt, ct, yy, cn, st)
                   : launch_matvec<false>(p, c, xx, n, sc, nt, col_split, pt, ct, yy, cn, st);
}

extern "C" int dkmc_wkb_fly_matvec(const void* pos, const void* cb, const void* x,
                                   int n, float prefac, float qV0, float ctol,
                                   float nn, float ly, float lz, int pbc,
                                   int symmetric, int col_split, void* part, void* cnt,
                                   void* y, void* stream) {
  return dkmc_wkb_fly_matvec_out(pos, cb, x, n, prefac, qV0, ctol, nn, ly, lz, pbc, symmetric,
                                 col_split, part, cnt, y, nullptr, stream);
}

// row [n] = forward-current dissipation row sums for the atoms' scaled
// potentials ms [n]; vsgn: the sign of the bias (-1, 0 or 1).  part, cnt
// and col_split as for the matvec.
extern "C" int dkmc_wkb_fly_pdisp(const void* pos, const void* cb, const void* ms,
                                  int n, float prefac, float qV0, float ctol,
                                  float nn, float ly, float lz, int pbc,
                                  float vsgn, int col_split, void* part, void* cnt,
                                  void* row, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int nt = (n + kTile - 1) / kTile;
  if (nt > 65535) return (int)cudaErrorInvalidValue;
  const Scal sc = scalars(prefac, qV0, ctol, nn, ly, lz, pbc);
  const dim3 grid((unsigned)((int64_t)nt * (nt + 1) / 2));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pos);
  const float* c = static_cast<const float*>(cb);
  const float* m = static_cast<const float*>(ms);
  float* pt = static_cast<float*>(part);
  int* ct = static_cast<int*>(cnt);
  float* r = static_cast<float*>(row);
  switch (col_split) {
    case 1:
      fly_pdisp_tiles<1><<<grid, kTile, 0, st>>>(p, c, m, n, sc, vsgn, nt, pt, ct, r);
      break;
    case 4:
      fly_pdisp_tiles<4><<<grid, 4 * kTile, 0, st>>>(p, c, m, n, sc, vsgn, nt, pt, ct, r);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Y [n, K] = T X for X [n, K] row-major.  KB in {4, 8, 24}: ceil(K / KB)
// column groups, each a sweep over the pairs (grid z).  part: scratch of
// n_split * n_tiles * 128 * ceil(K / KB) * KB floats; cnt: n_tiles *
// ceil(K / KB) tickets.
extern "C" int dkmc_wkb_fly_matmat(const void* pos, const void* cb, const void* X,
                                   int n, int K, int KB, float prefac, float qV0,
                                   float ctol, float nn, float ly, float lz, int pbc,
                                   int n_split, void* part, void* cnt, void* Y,
                                   void* stream) {
  if (n <= 0 || K <= 0 || n_split <= 0 || n_split > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int nt = (n + kTile - 1) / kTile;
  const Scal sc = scalars(prefac, qV0, ctol, nn, ly, lz, pbc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pos);
  const float* c = static_cast<const float*>(cb);
  const float* xx = static_cast<const float*>(X);
  float* pt = static_cast<float*>(part);
  int* ct = static_cast<int*>(cnt);
  float* yy = static_cast<float*>(Y);
  switch (KB) {
    case 4: return launch_matmat<4>(p, c, xx, n, K, sc, nt, n_split, pt, ct, yy, st);
    case 8: return launch_matmat<8>(p, c, xx, n, K, sc, nt, n_split, pt, ct, yy, st);
    case 24: return launch_matmat<24>(p, c, xx, n, K, sc, nt, n_split, pt, ct, yy, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
