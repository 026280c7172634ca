// One iteration of the warm boundary CG of B replicas, in three kernels: the
// body of the WHILE node that a captured superstep runs the solve in
// (ops/boundary_cg.py, csrc/graph.cu).
//
// Replaces the device loop of the JAX package's boundary solve, the
// lax.while_loop of devicekmc_tpu/ops/cg.py:95-115 (criterion "r", Jacobi)
// under the vmap of a batched superstep; the iteration is the port's
// cg_solve_batched (ops/cg.py), whose stop rule it keeps: a replica iterates
// while act0 and r.r > thresh^2, a stopped replica keeps its iterate,
// residual, r.z and count, and the loop runs while any replica iterates and
// fewer than maxiter iterations ran.  The operator is the interior system of
// physics/potential.py _dirichlet_system: y_i = diag_i x_i + sum_k vals[i,k]
// x[nb[i,k]] on interior rows (vals holds the negated conductances, zero on
// contact neighbours and pads), 0 on contact rows.  The plain version takes
// x as 0 on contact sites; the kernel needs no such mask: the direction p is
// 0 there in every iteration (the residual is 0 on contact rows, so z and p
// are), and a contact neighbour's value is 0.
//
//   cg_matvec_dot   ap = A p and p.ap of each replica -> alpha = r.z / p.ap
//   cg_update       x += alpha p, r -= alpha ap, z = r / diag, r.z and r.r
//                   -> beta, the new stop flags, the loop's predicate
//   cg_direction    p = z + beta p
//
// Bound: bytes.  An iteration needs the operator's nonzeros (8 + 4 bytes
// each in f64; 27.4 a row of the headline crossbar, 51 at most), the
// diagonal, p, ap and the row lengths once, and about ten [B, N] vectors.
// Design:
//
//   * the matvec reads only what the product needs: rows are left-packed
//     (pad -1 after the valid slots, state.Geometry), so a row's nonzeros
//     are the prefix of row_len[i] slots (ops/boundary_cg.row_lengths,
//     made once with the workspace); a contact row (row_len -1) loads no
//     value and no index, and no lane issues a load past a prefix;
//   * a group of 16 lanes a row, two rows a warp: lane g of a group takes
//     slots g, g + 16, g + 32, g + 48 (consecutive lanes on consecutive slots,
//     so a group's loads are whole 32-byte sectors but at the prefix's ends),
//     all four of a pass issued before their gathers of p, which go through
//     the read-only path (site_order "x" keeps a row's neighbours close in
//     index); 528 blocks (four an SM) walk the groups of 16 rows, each
//     reading the next group's row lengths before this group's loads.  A
//     probe of 4-32 lanes a row, 2-8 slots a lane, one or two groups in
//     flight and 528 to 13,618 blocks (tools/probe_cg_events.py --variants,
//     on an H100 80GB HBM3 at 700 W) put every form at 0.033 ms or more at
//     the crossbar's system, this one the fastest; the prefixes' values
//     alone take 0.021-0.024 ms of it;
//   * every reduction is a fixed tree: a butterfly in the warp, warps in
//     order, blocks' partial sums in slots of their own that the block which
//     draws a replica's last ticket (csrc/ticket.cuh) adds in a fixed order
//     (strided over its threads, then butterflies, then warps), and
//     the replicas' last blocks take a ticket of the loop, whose last block
//     sets the stop flags and the predicate.  No float atomics: two runs give
//     the same bits, and the grid depends on N only, so a replica's bits do
//     not depend on B;
//   * a stopped replica's blocks leave at once;
//   * nothing allocates: every buffer comes from the caller, so the three
//     launches can be captured into the body of a conditional node.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ticket.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// cg_matvec_dot: a group of kRowLanes lanes a row, kRowsPerWarp rows a warp,
// kMatvecRows rows a block at a time, kSlots slots a lane in one pass over a
// row (64 slots: one pass for max_nn up to 64)
constexpr int kRowLanes = 16;
constexpr int kRowsPerWarp = 32 / kRowLanes;
constexpr int kMatvecRows = kWarps * kRowsPerWarp;
constexpr int kSlots = 4;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  // a butterfly: every lane ends with the same bits (each step adds two
  // values whose sum is the same in either order)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The sum of `count` partials (read past L1: other blocks wrote them) by the
// whole block: thread t adds t, t + kThreads, ... in order, then the warps'
// butterflies, then the warps in order; in thread 0.  Every thread calls it.
template <typename T>
__device__ __forceinline__ T sum_partials(const T* part, int count, int stride, T* s_warp) {
  T t = 0;
  for (int i = threadIdx.x; i < count; i += kThreads) t += __ldcg(part + (size_t)i * stride);
  t = warp_sum(t);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = t;
  __syncthreads();
  T sum = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) sum += s_warp[w];
  return sum;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cg_matvec_dot_kernel(const T* __restrict__ diag, const T* __restrict__ vals,
                     const int* __restrict__ nb, const int* __restrict__ row_len,
                     const T* __restrict__ p, T* __restrict__ ap,
                     const unsigned char* __restrict__ act, const T* __restrict__ rz,
                     T* __restrict__ alpha, T* __restrict__ part, int* __restrict__ tickets,
                     int n, int m) {
  const int b = blockIdx.y;
  if (!act[b]) return;
  const int grid = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gl = lane % kRowLanes;  // this lane's place in its row's group
  const int n_groups = (n + kMatvecRows - 1) / kMatvecRows;
  const T* pb = p + (size_t)b * n;
  const T* db = diag + (size_t)b * n;
  const T* vb = vals + (size_t)b * n * m;
  T* apb = ap + (size_t)b * n;
  // the block's groups of kMatvecRows rows: blockIdx.x, + grid, ...; a row's
  // valid prefix (-1: a contact row, or past the last row, which loads
  // nothing and gives 0), the next group's read before this one's loads
  auto row_of = [&](int g) { return g * kMatvecRows + warp * kRowsPerWarp + lane / kRowLanes; };
  auto len_of = [&](int g) {
    const int row = row_of(g);
    return g < n_groups && row < n ? __ldg(row_len + row) : -1;
  };
  int g = blockIdx.x;
  int len = len_of(g);
  T py = 0;  // the group's first lane: p_i y_i of its rows, in group order
  for (; g < n_groups; g += grid) {
    const int row = row_of(g);
    const int len_next = len_of(g + grid);
    T d = 0, pr = 0;
    if (gl == 0 && len >= 0) {
      d = __ldg(db + row);
      pr = __ldg(pb + row);
    }
    // lane gl takes slots gl, gl + kRowLanes, ... of the prefix, kSlots of
    // them a pass: the index and value loads of a pass all issued before its
    // gathers of p, no load past the prefix; the products added in slot order
    const size_t e0 = (size_t)row * m;
    T s = 0;
    for (int base = 0; base < len; base += kRowLanes * kSlots) {
      int j[kSlots];
      T v[kSlots];
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int e = base + gl + kRowLanes * k;
        j[k] = e < len ? __ldg(nb + e0 + e) : -1;
        v[k] = e < len ? __ldg(vb + e0 + e) : T(0);
      }
#pragma unroll
      for (int k = 0; k < kSlots; ++k)
        if (j[k] >= 0) s += v[k] * __ldg(pb + j[k]);
    }
    // the group's sum, a butterfly over its kRowLanes lanes
#pragma unroll
    for (int o = kRowLanes / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (gl == 0 && row < n) {
      const T y = len >= 0 ? d * pr + s : T(0);
      apb[row] = y;
      py += pr * y;
    }
    len = len_next;
  }
  T acc = 0;  // lane 0: p.ap over this warp's rows, in row order
#pragma unroll
  for (int q = 0; q < kRowsPerWarp; ++q) acc += __shfl_sync(0xffffffffu, py, q * kRowLanes);
  __shared__ T s_part[kWarps];
  __shared__ int s_flag;
  if (lane == 0) s_part[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    T t = 0;
    for (int w = 0; w < kWarps; ++w) t += s_part[w];
    part[(size_t)b * grid + blockIdx.x] = t;
  }
  if (!last_ticket(tickets, b, grid, &s_flag)) return;
  const T denom = sum_partials(part + (size_t)b * grid, grid, 1, s_part);
  if (threadIdx.x == 0) alpha[b] = denom != T(0) ? rz[b] / denom : T(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cg_update_kernel(T* __restrict__ x, T* __restrict__ r, T* __restrict__ z,
                 const T* __restrict__ p, const T* __restrict__ ap,
                 const T* __restrict__ minv, unsigned char* __restrict__ act,
                 const unsigned char* __restrict__ act0, const T* __restrict__ alpha,
                 T* __restrict__ beta, T* __restrict__ rz, T* __restrict__ rr,
                 const T* __restrict__ thresh2, long long* __restrict__ iters,
                 T* __restrict__ part, int* __restrict__ tickets, int* __restrict__ ctl,
                 int* __restrict__ cond, unsigned long long* __restrict__ total,
                 unsigned long long handle, int n, int batch, int maxiter) {
  const int b = blockIdx.y;
  if (!act[b]) return;
  const int grid = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T a = alpha[b];
  T s_rz = 0, s_rr = 0;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += grid * kThreads) {
    const size_t k = (size_t)b * n + i;
    const T rn = r[k] - a * ap[k];
    const T zn = minv[k] * rn;
    x[k] = x[k] + a * p[k];
    r[k] = rn;
    z[k] = zn;
    s_rz += rn * zn;
    s_rr += rn * rn;
  }
  s_rz = warp_sum(s_rz);
  s_rr = warp_sum(s_rr);
  __shared__ T s_part[2][kWarps];
  __shared__ int s_flag;
  if (lane == 0) {
    s_part[0][warp] = s_rz;
    s_part[1][warp] = s_rr;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T t0 = 0, t1 = 0;
    for (int w = 0; w < kWarps; ++w) {
      t0 += s_part[0][w];
      t1 += s_part[1][w];
    }
    part[((size_t)b * grid + blockIdx.x) * 2] = t0;
    part[((size_t)b * grid + blockIdx.x) * 2 + 1] = t1;
  }
  if (!last_ticket(tickets, b, grid, &s_flag)) return;
  // this replica's last block: its r.z and r.r, beta and count
  const T* pb = part + (size_t)b * grid * 2;
  const T rz_n = sum_partials(pb, grid, 2, s_part[0]);
  const T rr_n = sum_partials(pb + 1, grid, 2, s_part[1]);
  if (threadIdx.x == 0) {
    const T rz_o = rz[b];
    beta[b] = rz_o != T(0) ? rz_n / rz_o : T(0);
    rz[b] = rz_n;
    rr[b] = rr_n;
    iters[b] += 1;
  }
  // the loop's ticket, one a replica that iterated: its last block decides
  if (!last_ticket(tickets, batch, ctl[1], &s_flag)) return;
  if (threadIdx.x == 0) {
    const int it = ctl[0] + 1;
    int n_act = 0;
    for (int c = 0; c < batch; ++c) {
      const bool on = act0[c] && __ldcg(rr + c) > thresh2[c];
      act[c] = on;
      n_act += on;
    }
    ctl[0] = it;
    ctl[1] = n_act;
    const int go = n_act > 0 && it < maxiter;
    cond[0] = go;
    *total += 1;
    if (handle) cudaGraphSetConditional(handle, go);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cg_direction_kernel(T* __restrict__ p, const T* __restrict__ z, const T* __restrict__ beta,
                    const unsigned char* __restrict__ act, int n) {
  const int b = blockIdx.y;
  if (!act[b]) return;
  const T be = beta[b];
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += gridDim.x * kThreads) {
    const size_t k = (size_t)b * n + i;
    p[k] = z[k] + be * p[k];
  }
}

bool bad_shape(int n, int m, int batch, int grid) {
  return n <= 0 || m <= 0 || batch <= 0 || batch > 65535 || grid <= 0;
}

}  // namespace

extern "C" int dkmc_cg_matvec_dot(int is_f64, const void* diag, const void* vals,
                                  const void* nb, const void* row_len, const void* p, void* ap,
                                  const void* act, const void* rz, void* alpha, void* part,
                                  void* tickets, int n, int m, int batch, int grid,
                                  void* stream) {
  if (bad_shape(n, m, batch, grid)) return (int)cudaErrorInvalidValue;
  const dim3 g(grid, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* len = static_cast<const int*>(row_len);
  const auto* a = static_cast<const unsigned char*>(act);
  const auto* ix = static_cast<const int*>(nb);
  if (is_f64)
    cg_matvec_dot_kernel<double><<<g, kThreads, 0, st>>>(
        static_cast<const double*>(diag), static_cast<const double*>(vals), ix, len,
        static_cast<const double*>(p), static_cast<double*>(ap), a,
        static_cast<const double*>(rz), static_cast<double*>(alpha),
        static_cast<double*>(part), static_cast<int*>(tickets), n, m);
  else
    cg_matvec_dot_kernel<float><<<g, kThreads, 0, st>>>(
        static_cast<const float*>(diag), static_cast<const float*>(vals), ix, len,
        static_cast<const float*>(p), static_cast<float*>(ap), a,
        static_cast<const float*>(rz), static_cast<float*>(alpha),
        static_cast<float*>(part), static_cast<int*>(tickets), n, m);
  return (int)cudaGetLastError();
}

extern "C" int dkmc_cg_update(int is_f64, void* x, void* r, void* z, const void* p,
                              const void* ap, const void* minv, void* act, const void* act0,
                              const void* alpha, void* beta, void* rz, void* rr,
                              const void* thresh2, void* iters, void* part, void* tickets,
                              void* ctl, void* cond, void* total, unsigned long long handle,
                              int n, int batch, int grid, int maxiter, void* stream) {
  if (bad_shape(n, 1, batch, grid)) return (int)cudaErrorInvalidValue;
  const dim3 g(grid, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* a = static_cast<unsigned char*>(act);
  const auto* a0 = static_cast<const unsigned char*>(act0);
  auto* it = static_cast<long long*>(iters);
  auto* tk = static_cast<int*>(tickets);
  auto* c = static_cast<int*>(ctl);
  auto* cd = static_cast<int*>(cond);
  auto* tot = static_cast<unsigned long long*>(total);
  if (is_f64)
    cg_update_kernel<double><<<g, kThreads, 0, st>>>(
        static_cast<double*>(x), static_cast<double*>(r), static_cast<double*>(z),
        static_cast<const double*>(p), static_cast<const double*>(ap),
        static_cast<const double*>(minv), a, a0, static_cast<const double*>(alpha),
        static_cast<double*>(beta), static_cast<double*>(rz), static_cast<double*>(rr),
        static_cast<const double*>(thresh2), it, static_cast<double*>(part), tk, c, cd, tot,
        handle, n, batch, maxiter);
  else
    cg_update_kernel<float><<<g, kThreads, 0, st>>>(
        static_cast<float*>(x), static_cast<float*>(r), static_cast<float*>(z),
        static_cast<const float*>(p), static_cast<const float*>(ap),
        static_cast<const float*>(minv), a, a0, static_cast<const float*>(alpha),
        static_cast<float*>(beta), static_cast<float*>(rz), static_cast<float*>(rr),
        static_cast<const float*>(thresh2), it, static_cast<float*>(part), tk, c, cd, tot,
        handle, n, batch, maxiter);
  return (int)cudaGetLastError();
}

extern "C" int dkmc_cg_direction(int is_f64, void* p, const void* z, const void* beta,
                                 const void* act, int n, int batch, int grid, void* stream) {
  if (bad_shape(n, 1, batch, grid)) return (int)cudaErrorInvalidValue;
  const dim3 g(grid, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const unsigned char*>(act);
  if (is_f64)
    cg_direction_kernel<double><<<g, kThreads, 0, st>>>(
        static_cast<double*>(p), static_cast<const double*>(z),
        static_cast<const double*>(beta), a, n);
  else
    cg_direction_kernel<float><<<g, kThreads, 0, st>>>(
        static_cast<float*>(p), static_cast<const float*>(z), static_cast<const float*>(beta),
        a, n);
  return (int)cudaGetLastError();
}
