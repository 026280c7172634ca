// The device loops of the warm transport solve: the mixed-precision CG with
// iterative refinement of the blocked transport operator, as nested WHILE
// nodes of a captured superstep (ops/transport_cg.py, csrc/graph.cu).
//
// Replaces the host loops of the port's cg_solve_mixed around cg_solve
// (ops/cg.py) on the transport path, the counterpart of the JAX package's
// lax.while_loop of the refinement rounds (devicekmc_tpu/ops/cg.py:225)
// around the inner CG's lax.while_loop (:112) inside jit(superstep_impl).
// The operator is physics/current.py _apply_X_blocks on the Jacobi-scaled
// grounded system: y = dsi * X (dsi * v), X the static band (f32 inner
// iterations) or the ELL neighbour conductances (f64 refinement), plus the
// dynamic bump of neutral-vacancy pairs, the on-the-fly metal block
// (csrc/wkb_fly.cu), the vacancy blocks T_vm [vcap, n_mp] and T_vv [vcap,
// vcap] (f32), the virtual-node rows and the exact diagonal.
//
//   transport_pack    the scaled vector x = dsi * v into the full layout,
//                     the band's zero-padded window (through the band's
//                     inverse permutation) and the metal vector the fly
//                     kernel reads; the f64 build first adds the finished
//                     round's correction, x += f64(inner x) * scale
//   transport_apply   the rest of the product, one cooperative launch: the
//                     three vacancy-block products and the bump, the two
//                     virtual-node dots; a barrier of the grid; every row
//                     (band or ELL part, bump, metal block through mp_inv,
//                     vacancy blocks through the bucket slot, virtual rows,
//                     diagonal, dsi); the f32 build writes ap and
//                     alpha = r.z / p.ap (the inner CG's step, as
//                     cg_matvec_dot does), the f64 build r = b - A x and r.r
//   transport_refine  the end of a round (and the set-up): ||r||, the
//                     rounds and inner iterations counted, the outer
//                     predicate (also the outer WHILE node's condition), the
//                     scale, b_in = f32(r / scale), the round's tolerance
//                     and the inner CG's set-up (x = 0, r = p = b_in, r.r,
//                     its threshold and predicate); a barrier of the grid
//                     between the sum of b_in.b_in's tiles and its use
//
// The inner update and direction is boundary_cg.cu's cg_update_direction
// kernel (f32, B = 1) with the inverse diagonal 1: the system is Jacobi-
// scaled, so z = r and r.z is r.r bit for bit.
//
// Bound: bytes.  An inner iteration reads the band (static, about 2 GB at
// the crossbar's width: its own kernel), the vacancy blocks twice (rows and
// columns, 14.4 + 4.2 MB at a bucket of 1,024 and 3,527 metal atoms) and a
// few [N] vectors; the rest is small.
// Design:
//
//   * every row is written by one thread, every sum has a fixed order and
//     no float atomics are used: a block product's sums in a warp's lanes in
//     order then a butterfly; the T_vm^T x_v columns in chunks of rows whose
//     partial sums have slots of their own, added in chunk order by the
//     row's thread; tile partial sums of 512 rows added in tile order by
//     the block that draws the last ticket; two runs give the same bits;
//   * the row arithmetic spells out each rounding (products rounded on
//     their own, then added) in the order of the plain version, so that a
//     row differs from it only through the sums that reduce in another
//     order;
//   * a slot past the bucket's live vacancies (n_vac, on the device) is
//     skipped: its rows and columns of the blocks are zeros;
//   * nothing allocates: every buffer comes from the caller, so the
//     launches can be captured into the body of a WHILE node.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "grid_sync.cuh"
#include "launch_count.cuh"
#include "ticket.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// row tiles of kTile rows, kRows a thread (rows k kThreads + threadIdx.x of
// the tile), whose partial sums have a slot of their own
constexpr int kRows = 2;
constexpr int kTile = kThreads * kRows;
// chunks of the bucket's rows in the T_vm^T x_v column sums
constexpr int kColChunks = 32;

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The sum of `count` partials (written by other blocks: read past L1) by
// the whole block: thread t adds t, t + kThreads, ... in order, then the
// warps' butterflies, then the warps in order; in thread 0.  Every thread
// calls it.
template <typename T>
__device__ __forceinline__ T sum_partials(const T* part, int count, T* s_warp) {
  T t = 0;
  for (int i = threadIdx.x; i < count; i += kThreads) t += __ldcg(part + i);
  t = warp_sum(t);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = t;
  __syncthreads();
  T sum = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) sum += s_warp[w];
  return sum;
}

// The sum of the block's values v (one a thread) in thread order through
// the warps' butterflies and the warps in order; in thread 0.
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

// ----------------------------------------------------------------------------
// transport_pack
// ----------------------------------------------------------------------------

// Thread i of [0, n_full): the scaled full vector xs[i] = dsi[i] v[i] (0 on
// the grounded last atom, i = nsub), its atom's slot of the band's window
// (xw[front + inv[a]], a = i - 2; lo only) and of the metal vector (xm[k],
// k = mp_inv[a]).  hi: v is x + f64(xi) scale (the round's correction,
// written back to x; `first`: x as it is).
template <typename T>
__global__ void __launch_bounds__(kThreads)
transport_pack_kernel(const T* __restrict__ dsi, const float* __restrict__ p, T* __restrict__ x,
                      const float* __restrict__ xi, const double* __restrict__ scale, int first,
                      const int* __restrict__ inv, const int* __restrict__ mp_inv, int front,
                      int nsub, int n_full, T* __restrict__ xs, float* __restrict__ xw,
                      float* __restrict__ xm, unsigned long long* count) {
  count_launch(count);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_full) return;
  T v = T(0);
  if (i < nsub) {
    if (sizeof(T) == 4) {
      v = mul_rn(dsi[i], (T)p[i]);
    } else {
      T xv = x[i];
      if (!first) {
        xv = add_rn(xv, mul_rn((T)xi[i], (T)scale[0]));
        x[i] = xv;
      }
      v = mul_rn(dsi[i], xv);
    }
  }
  xs[i] = v;
  if (i < 2) return;
  const int a = i - 2;
  if (xw != nullptr) xw[front + inv[a]] = (float)v;
  const int k = mp_inv[a];
  if (k >= 0) xm[k] = (float)v;
}

// ----------------------------------------------------------------------------
// transport_apply
// ----------------------------------------------------------------------------

template <typename T>
struct ApplyArgs {
  // the scaled vector [n_full] and its f32 metal part [n_mp]
  const T* xs;
  const float* xm;
  // lo: the band's product in its permuted layout and the inverse
  // permutation [na]; the bump's values [vcap, max_nn] (f32)
  const float* band_y;
  const int* inv;
  const float* dyn;
  // hi: the ELL neighbour conductances [na, max_nn] (f64)
  const double* nbv;
  // the atom graph [na, max_nn] (int32, pad -1)
  const int* anb;
  // the vacancy blocks and the bucket
  const float* T_vm;
  const float* T_vv;
  const int* vidx;
  const int* vslot;
  const int* n_vac;
  const int* mp_inv;
  // the fly kernel's product [n_mp] (f32)
  const float* y_cc;
  // virtual rows, diagonal and scaling in the working type
  const T* gnd;
  const T* src;
  const T* diag;
  const T* dsi;
  double loop_G;
  int gnd_lo, nsi;
  int na, nsub, max_nn, vcap, n_mp;
  // lo: the inner CG's direction, product, r.z, step and flag
  const float* p;
  float* ap;
  const float* rz;
  float* alpha;
  const unsigned char* act;
  // hi: the right-hand side, the residual and r.r
  const double* b;
  double* r;
  double* rsum;
  // scratch: the products of the vacancy blocks and the bump [vcap], the
  // column sums' chunks [kColChunks, n_mp], the two virtual-node dots, the
  // tiles' partial sums, the ticket, the barrier
  float* y_vm;
  float* y_vv;
  float* y_bump;
  float* mv_part;
  T* dots;
  T* part;
  int* ticket;
  unsigned* bar;
  unsigned long long* count;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) transport_apply_kernel(ApplyArgs<T> A) {
  count_launch(A.count);
  constexpr bool kLo = sizeof(T) == 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nv = min(*A.n_vac, A.vcap);
  const int col_groups = (A.n_mp + 31) / 32;
  const int rows_per_chunk = (A.vcap + kColChunks - 1) / kColChunks;
  const int n_tasks = A.vcap + col_groups * kColChunks + 2;
  auto xv_of = [&](int s) { return (float)A.xs[A.vidx[s] + 2]; };

  // 1. the block products, one task a warp
  for (int task = blockIdx.x * kWarps + warp; task < n_tasks; task += gridDim.x * kWarps) {
    if (task < A.vcap) {
      const int s = task;
      if (s >= nv) continue;
      const float* row = A.T_vm + (size_t)s * A.n_mp;
      float a = 0.f;
      for (int k = lane; k < A.n_mp; k += 32) a = fma_rn(__ldg(row + k), __ldg(A.xm + k), a);
      a = warp_sum(a);
      const float* rvv = A.T_vv + (size_t)s * A.vcap;
      float c = 0.f;
      for (int j = lane; j < nv; j += 32) c = fma_rn(__ldg(rvv + j), xv_of(j), c);
      c = warp_sum(c);
      float d = 0.f;
      if (kLo) {
        const int* nb = A.anb + (size_t)A.vidx[s] * A.max_nn;
        const float* dv = A.dyn + (size_t)s * A.max_nn;
        for (int k = lane; k < A.max_nn; k += 32) {
          const int j = nb[k];
          d = fma_rn(dv[k], (float)A.xs[(j < 0 ? 0 : j) + 2], d);
        }
        d = warp_sum(d);
      }
      if (lane == 0) {
        A.y_vm[s] = a;
        A.y_vv[s] = c;
        if (kLo) A.y_bump[s] = d;
      }
    } else if (task < A.vcap + col_groups * kColChunks) {
      const int t = task - A.vcap;
      const int g = t / kColChunks, q = t % kColChunks;
      const int col = g * 32 + lane;
      const int s0 = q * rows_per_chunk, s1 = min(s0 + rows_per_chunk, nv);
      if (col < A.n_mp) {
        float acc = 0.f;
        for (int s = s0; s < s1; ++s)
          acc = fma_rn(xv_of(s), __ldg(A.T_vm + (size_t)s * A.n_mp + col), acc);
        A.mv_part[(size_t)q * A.n_mp + col] = acc;
      }
    } else {
      // the virtual nodes' rows: gnd . xa over its nonzero range (atoms
      // past na - num_ground_ext), src . xa over the first nsi atoms
      const bool is_gnd = task == n_tasks - 2;
      const int a0 = is_gnd ? A.gnd_lo : 0, a1 = is_gnd ? A.na : A.nsi;
      const T* w = is_gnd ? A.gnd : A.src;
      T acc = 0;
      for (int a = a0 + lane; a < a1; a += 32) acc = fma_rn(w[a], A.xs[a + 2], acc);
      acc = warp_sum(acc);
      if (lane == 0) A.dots[is_gnd ? 0 : 1] = acc;
    }
  }

  grid_barrier(A.bar);

  // 2. the rows, a tile of kTile at a time, and the tile's partial sum
  __shared__ T s_warp[kWarps];
  __shared__ int s_flag;
  const int n_tiles = (A.nsub + kTile - 1) / kTile;
  const T x0 = A.xs[0], x1 = A.xs[1];
  const T lg = (T)A.loop_G;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    T acc = 0;
#pragma unroll
    for (int kk = 0; kk < kRows; ++kk) {
      const int i = t * kTile + kk * kThreads + threadIdx.x;
      if (i >= A.nsub) continue;
      T y;
      if (i >= 2) {
        const int a = i - 2;
        if (kLo) {
          y = (T)__ldcg(A.band_y + A.inv[a]);
        } else {
          y = 0;
          const int* nb = A.anb + (size_t)a * A.max_nn;
          const double* nv_ = A.nbv + (size_t)a * A.max_nn;
          for (int k = 0; k < A.max_nn; ++k) {
            const int j = nb[k];
            if (j >= 0) y = fma_rn((T)nv_[k], A.xs[j + 2], y);
          }
        }
        const int s = A.vslot[a];
        if (kLo && s >= 0) y = add_rn(y, (T)__ldcg(A.y_bump + s));
        const int k = A.mp_inv[a];
        T tm = 0;
        if (k >= 0) {
          float mv = 0.f;
          for (int q = 0; q < kColChunks; ++q) mv += __ldcg(A.mv_part + (size_t)q * A.n_mp + k);
          tm = add_rn((T)A.y_cc[k], (T)mv);
        }
        y = add_rn(y, tm);
        if (s >= 0) y = add_rn(y, add_rn((T)__ldcg(A.y_vv + s), (T)__ldcg(A.y_vm + s)));
        y = add_rn(y, mul_rn(A.gnd[a], x0));
        y = add_rn(y, mul_rn(A.src[a], x1));
      } else if (i == 0) {
        y = sub_rn(__ldcg(A.dots + 0), mul_rn(lg, x1));
      } else {
        y = sub_rn(__ldcg(A.dots + 1), mul_rn(lg, x0));
      }
      y = add_rn(y, mul_rn(A.diag[i], A.xs[i]));
      const T v = mul_rn(A.dsi[i], y);
      if (kLo) {
        A.ap[i] = (float)v;
        acc = fma_rn((T)A.p[i], v, acc);
      } else {
        const T rr = sub_rn((T)A.b[i], v);
        A.r[i] = (double)rr;
        acc = fma_rn(rr, rr, acc);
      }
    }
    const T sum = block_sum(acc, s_warp);
    if (threadIdx.x == 0) A.part[t] = sum;
  }

  // 3. the tiles' sums in tile order, by the block that draws the last
  // ticket: alpha (lo, while the inner CG iterates) or r.r (hi)
  if (!last_ticket(A.ticket, 0, gridDim.x, &s_flag)) return;
  const T total = sum_partials(A.part, n_tiles, s_warp);
  if (threadIdx.x == 0) {
    if (kLo) {
      if (A.act[0]) A.alpha[0] = total != T(0) ? (float)(A.rz[0] / (float)total) : 0.f;
    } else {
      A.rsum[0] = (double)total;
    }
  }
}

// ----------------------------------------------------------------------------
// transport_refine
// ----------------------------------------------------------------------------

struct RefineArgs {
  // the f64 residual, its r.r, the refinement's threshold and go flag
  const double* r;
  const double* rsum;
  const double* thresh;
  const unsigned char* go;
  // the refinement's state: rounds, inner iterations summed, ||r||, the
  // scale, ||r|| of the set-up, the outer predicate
  long long* it_out;
  long long* it_in;
  double* rnorm;
  double* scale;
  double* rnorm0;
  int* cond_out;
  // the inner CG (boundary_cg's workspace at B = 1, f32)
  float* x;
  float* rr_in;
  float* p;
  float* rz;
  float* rr;
  float* thresh2;
  unsigned char* act0;
  unsigned char* act;
  long long* iters;
  int* ctl;
  int* cond_in;
  // scratch: the tiles' partial sums of b_in . b_in and the barrier
  float* part;
  unsigned* bar;
  double inner_tol;
  int first, max_outer, maxiter, nsub;
  unsigned long long handle;
  unsigned long long* count;
};

__global__ void __launch_bounds__(kThreads) transport_refine_kernel(RefineArgs A) {
  count_launch(A.count);
  __shared__ float s_warp[kWarps];
  // every block: ||r|| and the predicate, from values no block writes
  // before the barrier
  const double rn = sqrt(*A.rsum);
  long long it_out = *A.it_out, it_in = *A.it_in;
  if (!A.first) {
    it_out += 1;
    it_in += *A.iters;
  }
  const bool go = *A.go != 0 && rn > *A.thresh && it_out < A.max_outer && it_in < A.maxiter;
  const double scale = rn > 0 ? rn : 1.0;
  const int n_tiles = (A.nsub + kTile - 1) / kTile;

  // the inner CG's start: x = 0, r = p = b_in = f32(r / scale), and the
  // tiles' partial sums of b_in . b_in
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    float acc = 0.f;
#pragma unroll
    for (int kk = 0; kk < kRows; ++kk) {
      const int i = t * kTile + kk * kThreads + threadIdx.x;
      if (i >= A.nsub) continue;
      const float bi = __double2float_rn(__ddiv_rn(A.r[i], scale));
      A.x[i] = 0.f;
      A.rr_in[i] = bi;
      A.p[i] = bi;
      acc = fma_rn(bi, bi, acc);
    }
    const float sum = block_sum(acc, s_warp);
    if (threadIdx.x == 0) A.part[t] = sum;
  }

  grid_barrier(A.bar);
  if (blockIdx.x != 0) return;
  const float rz = sum_partials(A.part, n_tiles, s_warp);
  if (threadIdx.x != 0) return;
  // the round's tolerance: a tenth of the reduction this round needs, no
  // tighter than inner_tol and no looser than 0.05, rounded to f32
  const double needed = __ddiv_rn(*A.thresh, fmax(rn, 1e-300));
  const float tol = __double2float_rn(fmin(fmax(__dmul_rn(0.1, needed), A.inner_tol), 0.05));
  const float ref = sqrtf(rz);
  const float th = __fmul_rn(tol, ref > 0.f ? ref : 1.f);
  const float th2 = __fmul_rn(th, th);
  const bool act = go && rz > th2;
  *A.rz = rz;
  *A.rr = rz;
  *A.thresh2 = th2;
  *A.act0 = go;
  *A.act = act;
  *A.iters = 0;
  A.ctl[0] = 0;
  A.ctl[1] = act;
  *A.cond_in = act;
  *A.it_out = it_out;
  *A.it_in = it_in;
  *A.rnorm = rn;
  *A.scale = scale;
  if (A.first) *A.rnorm0 = rn;
  *A.cond_out = go;
  if (A.handle) cudaGraphSetConditional(A.handle, go);
}

// Blocks of a cooperative kernel that the current card holds at once.
template <typename K>
int resident_blocks(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess
      || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0)
             != cudaSuccess)
    return 0;
  return per_sm * sms;
}

template <typename K, typename Args>
int launch_cooperative(K kernel, int want, const Args& args, cudaStream_t st) {
  const int cap = resident_blocks(kernel);
  if (cap <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(max(1, min(want, cap)));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// Every function launches one kernel on `stream` and returns its cudaError_t
// (0 on success).  is_f64: the f64 (refinement) build, else the f32 (inner)
// one.

// lo: p the inner direction (f32) -> xs (f32), xw, xm; hi: x (f64, updated
// by xi * scale unless first) -> xs (f64), xm (xw null).
extern "C" int dkmc_transport_pack(int is_f64, const void* dsi, const void* p, void* x,
                                   const void* xi, const void* scale, int first,
                                   const void* inv, const void* mp_inv, int front, int nsub,
                                   void* xs, void* xw, void* xm, void* count, void* stream) {
  if (nsub < 2) return (int)cudaErrorInvalidValue;
  const int n_full = nsub + 1;
  const dim3 grid((n_full + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* cnt = static_cast<unsigned long long*>(count);
  if (is_f64)
    transport_pack_kernel<double><<<grid, kThreads, 0, st>>>(
        static_cast<const double*>(dsi), nullptr, static_cast<double*>(x),
        static_cast<const float*>(xi), static_cast<const double*>(scale), first,
        static_cast<const int*>(inv), static_cast<const int*>(mp_inv), front, nsub, n_full,
        static_cast<double*>(xs), nullptr, static_cast<float*>(xm), cnt);
  else
    transport_pack_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(dsi), static_cast<const float*>(p), nullptr, nullptr,
        nullptr, 1, static_cast<const int*>(inv), static_cast<const int*>(mp_inv), front,
        nsub, n_full, static_cast<float*>(xs), static_cast<float*>(xw),
        static_cast<float*>(xm), cnt);
  return (int)cudaGetLastError();
}

extern "C" int dkmc_transport_apply(
    int is_f64, const void* xs, const void* xm, const void* band_y, const void* inv,
    const void* dyn, const void* nbv, const void* anb, const void* T_vm, const void* T_vv,
    const void* vidx, const void* vslot, const void* n_vac, const void* mp_inv,
    const void* y_cc, const void* gnd, const void* src, const void* diag, const void* dsi,
    double loop_G, int gnd_lo, int nsi, int na, int max_nn, int vcap, int n_mp,
    const void* p, void* ap, const void* rz, void* alpha, const void* act, const void* b,
    void* r, void* rsum, void* y_vm, void* y_vv, void* y_bump, void* mv_part, void* dots,
    void* part, void* ticket, void* bar, void* count, void* stream) {
  const int nsub = na + 1;
  if (na < 1 || max_nn < 1 || vcap < 1 || n_mp < 1) return (int)cudaErrorInvalidValue;
  const int n_tiles = (nsub + kTile - 1) / kTile;
  const int tasks = vcap + (n_mp + 31) / 32 * kColChunks + 2;
  const int want = max(n_tiles, (tasks + kWarps - 1) / kWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto fill = [&](auto& A) {
    using T = typename std::remove_pointer<decltype(A.gnd)>::type;
    using TT = typename std::remove_const<T>::type;
    A.xs = static_cast<const TT*>(xs);
    A.xm = static_cast<const float*>(xm);
    A.band_y = static_cast<const float*>(band_y);
    A.inv = static_cast<const int*>(inv);
    A.dyn = static_cast<const float*>(dyn);
    A.nbv = static_cast<const double*>(nbv);
    A.anb = static_cast<const int*>(anb);
    A.T_vm = static_cast<const float*>(T_vm);
    A.T_vv = static_cast<const float*>(T_vv);
    A.vidx = static_cast<const int*>(vidx);
    A.vslot = static_cast<const int*>(vslot);
    A.n_vac = static_cast<const int*>(n_vac);
    A.mp_inv = static_cast<const int*>(mp_inv);
    A.y_cc = static_cast<const float*>(y_cc);
    A.gnd = static_cast<const TT*>(gnd);
    A.src = static_cast<const TT*>(src);
    A.diag = static_cast<const TT*>(diag);
    A.dsi = static_cast<const TT*>(dsi);
    A.loop_G = loop_G;
    A.gnd_lo = gnd_lo;
    A.nsi = nsi;
    A.na = na;
    A.nsub = nsub;
    A.max_nn = max_nn;
    A.vcap = vcap;
    A.n_mp = n_mp;
    A.p = static_cast<const float*>(p);
    A.ap = static_cast<float*>(ap);
    A.rz = static_cast<const float*>(rz);
    A.alpha = static_cast<float*>(alpha);
    A.act = static_cast<const unsigned char*>(act);
    A.b = static_cast<const double*>(b);
    A.r = static_cast<double*>(r);
    A.rsum = static_cast<double*>(rsum);
    A.y_vm = static_cast<float*>(y_vm);
    A.y_vv = static_cast<float*>(y_vv);
    A.y_bump = static_cast<float*>(y_bump);
    A.mv_part = static_cast<float*>(mv_part);
    A.dots = static_cast<TT*>(dots);
    A.part = static_cast<TT*>(part);
    A.ticket = static_cast<int*>(ticket);
    A.bar = static_cast<unsigned*>(bar);
    A.count = static_cast<unsigned long long*>(count);
  };
  if (is_f64) {
    ApplyArgs<double> A;
    fill(A);
    return launch_cooperative(transport_apply_kernel<double>, want, A, st);
  }
  ApplyArgs<float> A;
  fill(A);
  return launch_cooperative(transport_apply_kernel<float>, want, A, st);
}

extern "C" int dkmc_transport_refine(
    const void* r, const void* rsum, const void* thresh, const void* go, void* it_out,
    void* it_in, void* rnorm, void* scale, void* rnorm0, void* cond_out, void* x, void* rr_in,
    void* p, void* rz, void* rr, void* thresh2, void* act0, void* act, void* iters, void* ctl,
    void* cond_in, void* part, void* bar, double inner_tol, int first, int max_outer,
    int maxiter, int nsub, unsigned long long handle, void* count, void* stream) {
  if (nsub < 1) return (int)cudaErrorInvalidValue;
  RefineArgs A;
  A.r = static_cast<const double*>(r);
  A.rsum = static_cast<const double*>(rsum);
  A.thresh = static_cast<const double*>(thresh);
  A.go = static_cast<const unsigned char*>(go);
  A.it_out = static_cast<long long*>(it_out);
  A.it_in = static_cast<long long*>(it_in);
  A.rnorm = static_cast<double*>(rnorm);
  A.scale = static_cast<double*>(scale);
  A.rnorm0 = static_cast<double*>(rnorm0);
  A.cond_out = static_cast<int*>(cond_out);
  A.x = static_cast<float*>(x);
  A.rr_in = static_cast<float*>(rr_in);
  A.p = static_cast<float*>(p);
  A.rz = static_cast<float*>(rz);
  A.rr = static_cast<float*>(rr);
  A.thresh2 = static_cast<float*>(thresh2);
  A.act0 = static_cast<unsigned char*>(act0);
  A.act = static_cast<unsigned char*>(act);
  A.iters = static_cast<long long*>(iters);
  A.ctl = static_cast<int*>(ctl);
  A.cond_in = static_cast<int*>(cond_in);
  A.part = static_cast<float*>(part);
  A.bar = static_cast<unsigned*>(bar);
  A.inner_tol = inner_tol;
  A.first = first;
  A.max_outer = max_outer;
  A.maxiter = maxiter;
  A.nsub = nsub;
  A.handle = handle;
  A.count = static_cast<unsigned long long*>(count);
  const int n_tiles = (nsub + kTile - 1) / kTile;
  return launch_cooperative(transport_refine_kernel, n_tiles, A,
                            static_cast<cudaStream_t>(stream));
}
