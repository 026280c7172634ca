// Exact-erfc gridless-Poisson pair sweep for NVIDIA Hopper (sm_90a), in f32
// and f64: what poisson_kernel = "jnp" (the default) computes.
//
// Replaces no Pallas kernel.  The JAX package runs this sweep as XLA-fused
// jnp code inside jit: devicekmc_tpu/physics/potential.py:438
// _poisson_rows_compact (with :386 _pairwise_dist), which
// poisson_gridless_compact (:473) calls for poisson_kernel = "jnp".  For
// each row i of [row0, row0 + n_rows) and replica b, in T (float for the
// mixed and f32 precisions, double for f64):
//
//   V_i = sum_{c < min(count_b, cap)} q_c * erfc(r_ic * inv_s) * k * Q_C / r_ic
//
//   * r_ic = sqrt(dx^2 + dy^2 + dz^2) * 1e-10, d = row - source; under PBC
//     y and z take the minimum image d - rint(d / l) * l (half to even);
//   * a pair contributes exactly 0 when the source's site id is the row's
//     or r <= 0;
//   * erfc is libdevice's erfcf / erfc (the A&S 7.1.26 form is
//     csrc/pairwise.cu, poisson_kernel = "pallas").
//
// Each operation of a pair is one IEEE operation rounded to nearest, in the
// order the plain version (ops/pairwise.py poisson_exact_plain) takes them,
// with no contraction into FMAs: a pair's value is the plain version's but
// for erfc's last ulps (libdevice's against PyTorch's); the sums take
// another order.
//
// Bound: operations.  Rows, sources and the output are a few bytes a row
// and a source; each pair is about 27 arithmetic operations (erfc counted
// once) in T, against 67 TFLOP/s in FP32 and 34 in FP64.  The compiled
// loop's issue bound (tools/fly_sass.py) counts what erfc, the square root
// and the division cost in instructions.
//
// Design (a simple kernel, the structure of csrc/pairwise.cu's batched
// sweep):
//
//   * grid (row blocks of 256 rows, splits of the source list, replicas);
//     128 threads, two rows a thread, so a staged source serves two pairs;
//   * each replica's count is read here, on the device, and its source list
//     split by the rule of ops/pairwise.py poisson_grid (min(want,
//     ceil(n_c / 64)) splits, at least one); the blocks of splits a replica
//     does not have leave at once;
//   * sources are staged 128 at a time in shared memory ({x, y, z, q} and
//     the site id), two buffers, the next tile loaded into registers while
//     the current one is used;
//   * each split writes its partial sums to a slot of its own, and the
//     block that draws its row block's last ticket (csrc/ticket.cuh) adds
//     the slots in ascending order: one launch a call, two calls bit-equal;
//   * a row range takes the split count of the sweep over every row (the
//     caller's ``want``), so each of its rows is that row of the whole sweep
//     bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_count.cuh"
#include "ticket.cuh"

namespace {

constexpr int kThreads = 128;  // threads a block == sources a tile
constexpr int kRows = 2;       // rows a thread
constexpr int kBlockRows = kThreads * kRows;
constexpr int kMinSplit = 64;  // sources a split takes at least (poisson_grid)

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float rint_(float a) { return rintf(a); }
__device__ __forceinline__ double rint_(double a) { return rint(a); }
__device__ __forceinline__ float erfc_(float a) { return erfcf(a); }
__device__ __forceinline__ double erfc_(double a) { return erfc(a); }

template <typename T>
struct Scal {
  T inv_s;  // 1 / (sigma sqrt2) [1/m]
  T k;      // the Coulomb constant
  T qc;     // the elementary charge
  T ly, lz;
};

// a source as staged: coordinates and charge
template <typename T>
struct __align__(16) Site {
  T x, y, z, q;
};

template <typename T, bool PBC>
__device__ __forceinline__ T pair(T xr, T yr, T zr, int ir, const Site<T>& s, int is,
                                  const Scal<T>& sc) {
  const T dx = sub_rn(xr, s.x);
  T dy = sub_rn(yr, s.y);
  T dz = sub_rn(zr, s.z);
  if (PBC) {
    dy = sub_rn(dy, mul_rn(rint_(div_rn(dy, sc.ly)), sc.ly));
    dz = sub_rn(dz, mul_rn(rint_(div_rn(dz, sc.lz)), sc.lz));
  }
  const T d2 = add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
  const T r0 = mul_rn(sqrt_rn(d2), T(1e-10));
  const bool dead = is == ir || r0 <= T(0);
  const T r = dead ? T(1) : r0;
  const T v = div_rn(mul_rn(mul_rn(mul_rn(s.q, erfc_(mul_rn(r, sc.inv_s))), sc.k), sc.qc), r);
  return dead ? T(0) : v;
}

// Grid (row blocks, the most splits, replicas).  rows [n, 3]: the swept
// rows, row k the site row0 + k; replica b's sources scoords [cap, 3], sids
// [cap] and sq [cap] at offset b * cap, its first min(counts[b], cap) swept.
// part: [B][gridDim.y][row blocks * kBlockRows] slots, cnt: a ticket a
// replica and row block, out [B, n].
template <typename T, bool PBC>
__global__ void __launch_bounds__(kThreads)
poisson_exact_kernel(const T* __restrict__ rows, int n, int row0,
                     const T* __restrict__ scoords, const int32_t* __restrict__ sids,
                     const T* __restrict__ sq, const int32_t* __restrict__ counts, int cap,
                     int want, Scal<T> sc, T* part, int* cnt, T* __restrict__ out,
                     unsigned long long* launches) {
  count_launch(launches);
  const int b = blockIdx.z;
  const int n_c = max(0, min(counts[b], cap));
  const int n_split = max(1, min(want, (n_c + kMinSplit - 1) / kMinSplit));
  const int split = blockIdx.y;
  if (split >= n_split) return;
  const int chunk = (n_c + n_split - 1) / n_split;
  const int64_t n_pad = (int64_t)gridDim.x * kBlockRows;
  scoords += (int64_t)b * cap * 3;
  sids += (int64_t)b * cap;
  sq += (int64_t)b * cap;
  part += (int64_t)b * gridDim.y * n_pad;
  cnt += (int64_t)b * gridDim.x;
  out += (int64_t)b * n;

  __shared__ Site<T> buf[2][kThreads];
  __shared__ int ids[2][kThreads];
  __shared__ int s_flag;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kBlockRows;
  T xr[kRows], yr[kRows], zr[kRows], acc[kRows];
  int ir[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int i = r0 + j * kThreads + tid;
    xr[j] = yr[j] = zr[j] = T(0);
    ir[j] = -1;
    if (i < n) {
      xr[j] = rows[3 * (int64_t)i];
      yr[j] = rows[3 * (int64_t)i + 1];
      zr[j] = rows[3 * (int64_t)i + 2];
      ir[j] = row0 + i;
    }
    acc[j] = T(0);
  }
  const int c0 = split * chunk, c1 = min(n_c, c0 + chunk);
  Site<T> next = {T(0), T(0), T(0), T(0)};
  int next_id = -1;
  if (c0 + tid < c1) {
    const int c = c0 + tid;
    next = Site<T>{scoords[3 * c], scoords[3 * c + 1], scoords[3 * c + 2], sq[c]};
    next_id = sids[c];
  }
  int w = 0;
  for (int t0 = c0; t0 < c1; t0 += kThreads) {
    buf[w][tid] = next;
    ids[w][tid] = next_id;
    __syncthreads();
    // the next tile is loaded while this one is used; the other buffer is
    // free: every thread passed this tile's barrier after it finished the
    // tile before
    const int c = t0 + kThreads + tid;
    if (c < c1) {
      next = Site<T>{scoords[3 * c], scoords[3 * c + 1], scoords[3 * c + 2], sq[c]};
      next_id = sids[c];
    }
    const int m = min(kThreads, c1 - t0);
#pragma unroll 2
    for (int k = 0; k < m; ++k) {
      const Site<T> s = buf[w][k];
      const int is = ids[w][k];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        acc[j] = add_rn(acc[j], pair<T, PBC>(xr[j], yr[j], zr[j], ir[j], s, is, sc));
      }
    }
    w ^= 1;
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) part[split * n_pad + r0 + j * kThreads + tid] = acc[j];
  if (last_ticket(cnt, blockIdx.x, n_split, &s_flag)) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int i = r0 + j * kThreads + tid;
      if (i < n) {
        T v = T(0);
        for (int s = 0; s < n_split; ++s) v = add_rn(v, __ldcg(part + s * n_pad + i));
        out[i] = v;
      }
    }
  }
}

template <typename T>
int launch(const void* rows, int n_rows, int row0, const void* scoords, const void* sids,
           const void* sq, const void* counts, int batch, int cap, double inv_s, double k,
           double qc, double lat_y, double lat_z, int pbc, int want, int max_split,
           void* part, void* cnt, void* out, void* launches, cudaStream_t st) {
  // each scalar is a value of T handed over as a double: the cast is exact
  const Scal<T> sc = {T(inv_s), T(k), T(qc), T(lat_y), T(lat_z)};
  const dim3 grid((unsigned)((n_rows + kBlockRows - 1) / kBlockRows), (unsigned)max_split,
                  (unsigned)batch);
  const T* r = static_cast<const T*>(rows);
  const T* c = static_cast<const T*>(scoords);
  const int32_t* ci = static_cast<const int32_t*>(sids);
  const T* q = static_cast<const T*>(sq);
  const int32_t* cn = static_cast<const int32_t*>(counts);
  T* pt = static_cast<T*>(part);
  int* ct = static_cast<int*>(cnt);
  T* o = static_cast<T*>(out);
  unsigned long long* lc = static_cast<unsigned long long*>(launches);
  if (pbc) {
    poisson_exact_kernel<T, true><<<grid, kThreads, 0, st>>>(r, n_rows, row0, c, ci, q, cn,
                                                             cap, want, sc, pt, ct, o, lc);
  } else {
    poisson_exact_kernel<T, false><<<grid, kThreads, 0, st>>>(r, n_rows, row0, c, ci, q, cn,
                                                              cap, want, sc, pt, ct, o, lc);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// V [B, n_rows] in T (f64 != 0: double, else float) of the rows rows
// [n_rows, 3] (T, row k the site row0 + k) under B replicas' sources: the
// coordinates scoords [B, cap, 3] (T), site ids sids [B, cap] (int32) and
// charges sq [B, cap] (T), replica b's first min(counts[b], cap) of them
// (counts [B] int32, on the device).  inv_s = 1 / (sigma sqrt2), k, qc and
// the lattice's y and z: values of T.  want: the most splits a replica may
// take (ops/pairwise.py poisson_grid for the sweep over every row);
// max_split: the grid's splits, at least every replica's.  part: scratch of
// B * max_split * ceil(n_rows / 256) * 256 values of T and cnt: B *
// ceil(n_rows / 256) int32 tickets, 0 before the call and 0 again after it;
// launches: a uint64 the launch adds one to on the card
// (csrc/launch_count.cuh), or null.  Returns the cudaError_t of the launch.
extern "C" int dkmc_poisson_exact(const void* rows, int n_rows, int row0, const void* scoords,
                                  const void* sids, const void* sq, const void* counts,
                                  int batch, int cap, int f64, double inv_s, double k,
                                  double qc, double lat_y, double lat_z, int pbc, int want,
                                  int max_split, void* part, void* cnt, void* out,
                                  void* launches, void* stream) {
  if (n_rows <= 0 || row0 < 0 || batch <= 0 || batch > 65535 || cap < 0 || want <= 0
      || max_split <= 0 || max_split > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f64) {
    return launch<double>(rows, n_rows, row0, scoords, sids, sq, counts, batch, cap, inv_s,
                          k, qc, lat_y, lat_z, pbc, want, max_split, part, cnt, out,
                          launches, st);
  }
  return launch<float>(rows, n_rows, row0, scoords, sids, sq, counts, batch, cap, inv_s, k,
                       qc, lat_y, lat_z, pbc, want, max_split, part, cnt, out, launches, st);
}
