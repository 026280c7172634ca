// The device loops of the local heat model: the transient substeps and the
// steady branch as WHILE nodes of a captured superstep (ops/heat.py,
// csrc/graph.cu), for NVIDIA Hopper (sm_90a).
//
// Replaces the host loops of the port's local heat model, the counterpart of
// the JAX package's lax.while_loop over the transient substeps
// (devicekmc_tpu/physics/heat.py:271 dense, :351 matrix-free) and its
// lax.cond between the steady and transient branches (:280, :415) inside
// jit(superstep_impl).  The branch is not a mask: each branch is a loop of
// its own, entered on a trip count set on the device (the transient loop
// n_sub substeps, the steady one 1 pass; the branch not taken 0), so the
// steady CG's up to 1000 iterations never run beside the transient ones.
//
//   heat_dense_substep  one substep of the dense model: row i of the
//                       propagator M [ni, ni] (L_inv, or L_ss_inv for the
//                       steady pass) times the right-hand side u_in, t_new =
//                       (+/-) M u_in, T[iidx[i]] = t_new scale + T0 and the
//                       next substep's right-hand side (T - T0) / scale +
//                       src into the other half of u; the substep counter
//                       advanced and the WHILE predicate set by the block
//                       that draws the last ticket
//   heat_cg_begin       the set-up of one CG solve of the matrix-free model
//                       (boundary_cg's workspace, B = 1, minv = 1): x0 =
//                       (T - T0) / scale on the interface (warm; 0 for the
//                       steady solve), b = x0 + src, r = p = b - A x0, r.r,
//                       the threshold tol ||b||, the stop flag and the
//                       inner predicate; the CG iterations that follow are
//                       boundary_cg.cu's cg_matvec_dot and
//                       cg_update_direction on the ELL form of the operator
//   heat_cg_end         the solve's field written back, T = (+/-) x scale +
//                       T0 on the interface, its iterations summed, the
//                       substep counter advanced and the outer predicate set
//
// The dense product is plain jnp in the JAX package, outside Pallas, so a
// library product (torch.matmul) would stand in for it on an eager path; it
// is a hand-written kernel here because it is the body of a conditional
// WHILE node, inside which nothing may allocate and whose last kernel must
// set the node's condition on the device.
//
// Bound: bytes.  A dense substep reads the propagator once (ni^2 entries of
// the working type) and two [ni] vectors; the CG set-up reads the operator's
// interface rows (value and index of each valid slot), T, src and the mask,
// and writes x, r, p.
// Design:
//
//   * heat_dense_substep: a warp a row, lane l adding columns l, l + 32, ...
//     (coalesced reads of the row), a fused multiply-add each, then a
//     butterfly; the right-hand side is double-buffered (u [2, ni], the
//     half read chosen by the substep counter's parity), since every row
//     reads all of the old one while the rows of the new one are written;
//   * heat_cg_begin: a row a thread, its ELL slots over the valid prefix
//     (row_len, -1 off the interface: boundary_cg.row_lengths), the
//     neighbours' x0 recomputed from T; the blocks' partial sums of b.b and
//     r.r in slots of their own, added in block order by the block that
//     draws the last ticket (csrc/ticket.cuh), which writes the scalars;
//   * every sum has a fixed order and no float atomics are used: two runs
//     give the same bits, so the captured loops and the host loop that runs
//     the same kernels outside a capture (ops/heat.py) agree bit for bit;
//   * nothing allocates: every buffer comes from the caller.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "launch_count.cuh"
#include "ticket.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's sum of v (each warp's butterfly, then the warps in order), in
// thread 0.  Every thread calls it.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* s_warp) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  T sum = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) sum += s_warp[w];
  __syncthreads();
  return sum;
}

// The sum of `count` partials part[k * stride] (written by other blocks:
// read past L1) by the whole block: thread t adds t, t + kThreads, ... in
// order, then the warps' butterflies, then the warps in order; in thread 0.
template <typename T>
__device__ __forceinline__ T sum_partials(const T* part, int count, int stride, T* s_warp) {
  T t = 0;
  for (int i = threadIdx.x; i < count; i += kThreads) t += __ldcg(part + (size_t)i * stride);
  return block_sum(t, s_warp);
}

// ----------------------------------------------------------------------------
// heat_dense_substep
// ----------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
heat_dense_substep_kernel(const T* __restrict__ M, T* __restrict__ u, const T* __restrict__ src,
                          const int* __restrict__ iidx, T* __restrict__ temp, int ni, T T0,
                          T scale, int negate, int* __restrict__ k, const int* __restrict__ n,
                          int* __restrict__ cond, int* __restrict__ ticket,
                          unsigned long long handle, unsigned long long* count) {
  count_launch(count);
  __shared__ int s_flag;
  // every block reads the counter before its ticket; the last block writes
  // it after every ticket is drawn
  const int par = __ldcg(k) & 1;
  const T* in = u + (size_t)par * ni;
  T* out = u + (size_t)(par ^ 1) * ni;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row < ni) {
    const T* m = M + (size_t)row * ni;
    T acc = 0;
    for (int j = lane; j < ni; j += 32) acc = fma_rn(__ldg(m + j), __ldcg(in + j), acc);
    acc = warp_sum(acc);
    if (lane == 0) {
      const T t = negate ? -acc : acc;
      const T tn = add_rn(mul_rn(t, scale), T0);
      temp[iidx[row]] = tn;
      out[row] = add_rn(div_rn(sub_rn(tn, T0), scale), src[row]);
    }
  }
  if (!last_ticket(ticket, 0, gridDim.x, &s_flag)) return;
  if (threadIdx.x == 0) {
    const int kn = __ldcg(k) + 1;
    *k = kn;
    const int go = kn < *n;
    *cond = go;
    if (handle) cudaGraphSetConditional(handle, go);
  }
}

// ----------------------------------------------------------------------------
// heat_cg_begin
// ----------------------------------------------------------------------------

template <typename T>
struct BeginArgs {
  // the temperature field [n], the interface mask [n], the source [n]
  const T* temp;
  const unsigned char* mask;
  const T* src;
  // the operator's ELL form: diagonal [n], values [n, m], neighbours [n, m]
  // (int32, pad -1), the valid prefix of each row (-1 off the interface)
  const T* diag;
  const T* vals;
  const int* nb;
  const int* row_len;
  // boundary_cg's workspace at B = 1
  T* x;
  T* r;
  T* p;
  T* rz;
  T* rr;
  T* thresh2;
  const unsigned char* act0;
  unsigned char* act;
  long long* iters;
  int* ctl;
  int* cond;
  // scratch: the blocks' partial sums of b.b and r.r (pairs), the ticket
  T* part;
  int* ticket;
  T T0, scale, tol;
  int warm, n, m, maxiter;
  unsigned long long* count;
};

// x0 of site j: (T_j - T0) / scale on the interface when warm, else 0
template <typename T>
__device__ __forceinline__ T start_of(const BeginArgs<T>& A, int j) {
  return A.warm && A.mask[j] ? div_rn(sub_rn(A.temp[j], A.T0), A.scale) : T(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) heat_cg_begin_kernel(BeginArgs<T> A) {
  count_launch(A.count);
  __shared__ T s_warp[kWarps];
  __shared__ int s_flag;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  T bb = 0, rr = 0;
  if (i < A.n) {
    T x0 = 0, r = 0;
    const int len = A.row_len[i];
    if (A.mask[i] && len >= 0) {
      x0 = start_of(A, i);
      const T b = add_rn(x0, A.src[i]);
      // A x0 on the row: its slots in order, a fused multiply-add each,
      // then the diagonal
      const size_t e0 = (size_t)i * A.m;
      T s = 0;
      for (int q = 0; q < len; ++q) {
        const int j = A.nb[e0 + q];
        s = fma_rn(A.vals[e0 + q], start_of(A, j), s);
      }
      const T ax = fma_rn(A.diag[i], x0, s);
      r = sub_rn(b, ax);
      bb = mul_rn(b, b);
      rr = mul_rn(r, r);
    }
    A.x[i] = x0;
    A.r[i] = r;
    A.p[i] = r;
  }
  const T s_bb = block_sum(bb, s_warp);
  const T s_rr = block_sum(rr, s_warp);
  if (threadIdx.x == 0) {
    A.part[2 * (size_t)blockIdx.x] = s_bb;
    A.part[2 * (size_t)blockIdx.x + 1] = s_rr;
  }
  if (!last_ticket(A.ticket, 0, gridDim.x, &s_flag)) return;
  const T t_bb = sum_partials(A.part, gridDim.x, 2, s_warp);
  const T t_rr = sum_partials(A.part + 1, gridDim.x, 2, s_warp);
  if (threadIdx.x == 0) {
    const T ref = sqrt_rn(t_bb);
    const T th = mul_rn(A.tol, ref > T(0) ? ref : T(1));
    const T th2 = mul_rn(th, th);
    const bool go = A.act0[0] && t_rr > th2;
    A.rz[0] = t_rr;
    A.rr[0] = t_rr;
    A.thresh2[0] = th2;
    A.act[0] = go;
    A.iters[0] = 0;
    A.ctl[0] = 0;
    A.ctl[1] = go;
    A.cond[0] = go && 0 < A.maxiter;
  }
}

// ----------------------------------------------------------------------------
// heat_cg_end
// ----------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
heat_cg_end_kernel(const T* __restrict__ x, const unsigned char* __restrict__ mask,
                   T* __restrict__ temp, int n, T T0, T scale, int negate,
                   const long long* __restrict__ iters, long long* __restrict__ iters_sum,
                   int* __restrict__ k, const int* __restrict__ nk, int* __restrict__ cond,
                   unsigned long long handle, unsigned long long* count) {
  count_launch(count);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n && mask[i]) {
    const T v = negate ? -x[i] : x[i];
    temp[i] = add_rn(mul_rn(v, scale), T0);
  }
  // no other block reads the counters in this launch
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *iters_sum += *iters;
    const int kn = *k + 1;
    *k = kn;
    const int go = kn < *nk;
    *cond = go;
    if (handle) cudaGraphSetConditional(handle, go);
  }
}

int blocks_of(long long rows, int per) { return (int)((rows + per - 1) / per); }

}  // namespace

// One dense substep (heat_dense_substep_kernel): M [ni, ni], u [2, ni],
// src [ni], iidx [ni] (int32), temp [N]; k, n, cond and ticket int32 [1].
extern "C" int dkmc_heat_dense_substep(int is_f64, const void* M, void* u, const void* src,
                                       const void* iidx, void* temp, int ni, double T0,
                                       double scale, int negate, void* k, const void* n,
                                       void* cond, void* ticket, unsigned long long handle,
                                       void* count, void* stream) {
  if (ni <= 0) return (int)cudaErrorInvalidValue;
  const int grid = blocks_of(ni, kWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* cnt = static_cast<unsigned long long*>(count);
  auto* ix = static_cast<const int*>(iidx);
  auto* kk = static_cast<int*>(k);
  auto* nn = static_cast<const int*>(n);
  auto* cc = static_cast<int*>(cond);
  auto* tk = static_cast<int*>(ticket);
  if (is_f64)
    heat_dense_substep_kernel<double><<<grid, kThreads, 0, st>>>(
        static_cast<const double*>(M), static_cast<double*>(u),
        static_cast<const double*>(src), ix, static_cast<double*>(temp), ni, T0, scale,
        negate, kk, nn, cc, tk, handle, cnt);
  else
    heat_dense_substep_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(M), static_cast<float*>(u), static_cast<const float*>(src),
        ix, static_cast<float*>(temp), ni, (float)T0, (float)scale, negate, kk, nn, cc, tk,
        handle, cnt);
  return (int)cudaGetLastError();
}

// The set-up of one CG solve (heat_cg_begin_kernel) over n rows of m slots.
extern "C" int dkmc_heat_cg_begin(int is_f64, const void* temp, const void* mask,
                                  const void* src, const void* diag, const void* vals,
                                  const void* nb, const void* row_len, void* x, void* r,
                                  void* p, void* rz, void* rr, void* thresh2, const void* act0,
                                  void* act, void* iters, void* ctl, void* cond, void* part,
                                  void* ticket, double T0, double scale, double tol, int warm,
                                  int n, int m, int maxiter, void* count, void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const int grid = blocks_of(n, kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto fill = [&](auto& A) {
    using T = typename std::remove_const<
        typename std::remove_pointer<decltype(A.temp)>::type>::type;
    A.temp = static_cast<const T*>(temp);
    A.mask = static_cast<const unsigned char*>(mask);
    A.src = static_cast<const T*>(src);
    A.diag = static_cast<const T*>(diag);
    A.vals = static_cast<const T*>(vals);
    A.nb = static_cast<const int*>(nb);
    A.row_len = static_cast<const int*>(row_len);
    A.x = static_cast<T*>(x);
    A.r = static_cast<T*>(r);
    A.p = static_cast<T*>(p);
    A.rz = static_cast<T*>(rz);
    A.rr = static_cast<T*>(rr);
    A.thresh2 = static_cast<T*>(thresh2);
    A.act0 = static_cast<const unsigned char*>(act0);
    A.act = static_cast<unsigned char*>(act);
    A.iters = static_cast<long long*>(iters);
    A.ctl = static_cast<int*>(ctl);
    A.cond = static_cast<int*>(cond);
    A.part = static_cast<T*>(part);
    A.ticket = static_cast<int*>(ticket);
    A.T0 = (T)T0;
    A.scale = (T)scale;
    A.tol = (T)tol;
    A.warm = warm;
    A.n = n;
    A.m = m;
    A.maxiter = maxiter;
    A.count = static_cast<unsigned long long*>(count);
  };
  if (is_f64) {
    BeginArgs<double> A;
    fill(A);
    heat_cg_begin_kernel<double><<<grid, kThreads, 0, st>>>(A);
  } else {
    BeginArgs<float> A;
    fill(A);
    heat_cg_begin_kernel<float><<<grid, kThreads, 0, st>>>(A);
  }
  return (int)cudaGetLastError();
}

// The end of one CG solve (heat_cg_end_kernel) over n rows.
extern "C" int dkmc_heat_cg_end(int is_f64, const void* x, const void* mask, void* temp, int n,
                                double T0, double scale, int negate, const void* iters,
                                void* iters_sum, void* k, const void* nk, void* cond,
                                unsigned long long handle, void* count, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int grid = blocks_of(n, kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* m = static_cast<const unsigned char*>(mask);
  auto* it = static_cast<const long long*>(iters);
  auto* is = static_cast<long long*>(iters_sum);
  auto* kk = static_cast<int*>(k);
  auto* nn = static_cast<const int*>(nk);
  auto* cc = static_cast<int*>(cond);
  auto* cnt = static_cast<unsigned long long*>(count);
  if (is_f64)
    heat_cg_end_kernel<double><<<grid, kThreads, 0, st>>>(
        static_cast<const double*>(x), m, static_cast<double*>(temp), n, T0, scale, negate, it,
        is, kk, nn, cc, handle, cnt);
  else
    heat_cg_end_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), m, static_cast<float*>(temp), n, (float)T0,
        (float)scale, negate, it, is, kk, nn, cc, handle, cnt);
  return (int)cudaGetLastError();
}
