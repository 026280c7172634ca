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
//                       advanced and the WHILE predicate set once every
//                       block is done
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
//   * heat_dense_substep, in the form ops/heat.py dense_plan picks by ni
//     (each form's constants passed with the launch); every form reads the
//     right-hand side's half by the substep counter's parity, u [2, ni]
//     being double-buffered since every row reads all of the old one while
//     the rows of the new one are written, and stages it in shared memory,
//     so that each read of it from L2 feeds many rows:
//       - the cluster form (small ni): one cluster of up to 16 blocks takes
//         the whole product, a warp R rows, so no ticket: the first loads of
//         the propagator are issued before the counter is read, both halves
//         of u are staged (no wait for the counter), and after a barrier of
//         the cluster block 0's thread 0 sets the counter and the predicate;
//       - the grid form (large ni), its blocks the ones the card holds: a
//         block a row at a time, its warps each a slice of the row's
//         columns; a block's first row is its index, the next ones are drawn
//         from a counter (an integer atomic), so that the blocks the memory
//         serves faster take more rows and all finish together; where u
//         does not fit one tile of shared memory, sets of R rows a warp over
//         tiles of the columns instead; the counter and the predicate by
//         the block that draws the last ticket (csrc/ticket.cuh), which also
//         sets the row counter back to 0;
//     the propagator read in 16-byte loads (double2, float4; 1 entry where
//     ni or the data is not aligned to them), streaming (ld.global.cs) in
//     the grid form, 8 in flight a lane, the next pass's issued before the
//     current one's products; a row's sum: each lane its columns in order,
//     fused multiply-adds, a butterfly, then (the grid form) the warps in
//     order;
//   * heat_cg_begin, one cooperative launch on the blocks the card holds:
//     first x0 of every row, a row a thread ((T - T0) / scale on the
//     interface when warm, else 0; r = p = 0 off the interface), then a
//     barrier of the grid (csrc/grid_sync.cuh, on boundary_cg's counter),
//     then 16 lanes a row (as cg_matvec_dot), lane l taking the slots l,
//     l + 16, ... of the row's valid prefix (row_len, -1 off the interface:
//     boundary_cg.row_lengths), so the value and index loads of a row are
//     coalesced and issued before the neighbours' x0 are gathered (written
//     this launch: read past L1), and the next row's length read a row
//     ahead; the row's sum a butterfly of its 16 lanes; a block takes chunks
//     of 64 rows (4 passes of its 8 warps x 2 rows); the blocks' (b.b, r.r)
//     pairs in slots of their own, added in block order in one pass of pairs
//     by the block that draws the last ticket, which writes the scalars;
//   * every sum has a fixed order and no float atomics are used: two runs
//     give the same bits, so the captured loops and the host loop that runs
//     the same kernels outside a capture (ops/heat.py) agree bit for bit;
//   * nothing allocates: every buffer comes from the caller.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "grid_sync.cuh"
#include "launch_count.cuh"
#include "ticket.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// heat_dense_substep: blocks of the cluster form at most (the card's largest
// cluster); steps of a warp's columns a pass (cluster form, 16 bytes a lane
// a step); loads a pass a lane (the other forms, R rows x U steps); bytes of
// a tile of the right-hand side at most; the cluster form stages both halves
// of the right-hand side, ni up to kMaxSmallNi
constexpr int kMaxCluster = 16;
constexpr int kSmallSteps = 4;
constexpr int kGridLoads = 8;
constexpr int kMaxTileBytes = 200 * 1024;
constexpr int kMaxSmallNi = 2048;
// heat_cg_begin: lanes a row, slots a lane loads before it gathers, passes
// of the block's warps over a chunk
constexpr int kBeginLanes = 16;
constexpr int kBeginSlots = 4;
constexpr int kBeginPasses = 4;
constexpr int kBeginRowsPerWarp = 32 / kBeginLanes;
constexpr int kBeginChunk = kBeginPasses * kWarps * kBeginRowsPerWarp;

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
struct Pair;
template <>
struct Pair<double> {
  using type = double2;
};
template <>
struct Pair<float> {
  using type = float2;
};

// VEC entries of T in one load: 16 bytes, or one entry
template <typename T, int VEC>
struct VecOf;
template <>
struct VecOf<double, 1> {
  using type = double;
};
template <>
struct VecOf<double, 2> {
  using type = double2;
};
template <>
struct VecOf<float, 1> {
  using type = float;
};
template <>
struct VecOf<float, 4> {
  using type = float4;
};

// acc + m . x over the entries of one load, in order, a fused multiply-add
// each
__device__ __forceinline__ double dot_fma(double m, double x, double acc) {
  return fma_rn(m, x, acc);
}
__device__ __forceinline__ double dot_fma(double2 m, double2 x, double acc) {
  return fma_rn(m.y, x.y, fma_rn(m.x, x.x, acc));
}
__device__ __forceinline__ float dot_fma(float m, float x, float acc) {
  return fma_rn(m, x, acc);
}
__device__ __forceinline__ float dot_fma(float4 m, float4 x, float acc) {
  return fma_rn(m.w, x.w, fma_rn(m.z, x.z, fma_rn(m.y, x.y, fma_rn(m.x, x.x, acc))));
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ----------------------------------------------------------------------------
// heat_dense_substep
// ----------------------------------------------------------------------------

template <typename T>
struct DenseArgs {
  // the propagator [ni, ni], the right-hand side [2, ni] (double-buffered),
  // the source [ni], the interface sites [ni], the field [N]
  const T* M;
  T* u;
  const T* src;
  const int* iidx;
  T* temp;
  // the substep counter, the trip count, the predicate, the ticket and the
  // row counter (grid form), the WHILE node (0: none), the launch counter
  int* k;
  const int* n;
  int* cond;
  int* ticket;
  int* rows;
  unsigned long long handle;
  unsigned long long* count;
  T T0, scale;
  // tile: columns of the right-hand side in shared memory (grid form)
  int ni, negate, tile;
};

// in[0, len) into shared memory, VEC entries a load (read past L1: the
// previous launch wrote it), then a barrier
template <typename T, int VEC>
__device__ __forceinline__ void stage(T* s_in, const T* in, int len) {
  using V = typename VecOf<T, VEC>::type;
  for (int c = threadIdx.x * VEC; c < len; c += kThreads * VEC)
    *reinterpret_cast<V*>(s_in + c) = __ldcg(reinterpret_cast<const V*>(in + c));
  __syncthreads();
}

// The substep counter advanced from k0 (read by every block before), the
// WHILE predicate and the node's condition set
template <typename T>
__device__ __forceinline__ void advance(const DenseArgs<T>& A, int k0) {
  const int kn = k0 + 1;
  *A.k = kn;
  const int go = kn < *A.n;
  *A.cond = go;
  if (A.handle) cudaGraphSetConditional(A.handle, go);
}

// VEC entries a load, R rows a warp; CLUSTER: the cluster form (the grid is
// one cluster), else the sets over the grid.  A warp walks its passes (set,
// tile, chunk of U steps of 32 VEC columns) in order and issues the next
// pass's loads of the propagator before it adds the current one's, the
// first before the counter is read and the right-hand side staged.
template <typename T, int VEC, int R, bool CLUSTER>
__global__ void __launch_bounds__(kThreads) heat_dense_substep_kernel(DenseArgs<T> A) {
  using V = typename VecOf<T, VEC>::type;
  // steps of a warp's columns a pass
  constexpr int U = CLUSTER ? kSmallSteps : kGridLoads / R;
  constexpr int kStep = 32 * VEC;
  constexpr int kChunk = kStep * U;
  constexpr int kSetRows = kWarps * R;
  extern __shared__ __align__(16) unsigned char s_raw[];
  count_launch(A.count);
  const int ni = A.ni;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_sets = (ni + kSetRows - 1) / kSetRows;
  const int tile = CLUSTER ? ni : A.tile;
  const int n_tiles = (ni + tile - 1) / tile;
  T* s_u = reinterpret_cast<T*>(s_raw);
  // the propagator's entries of pass (set s, tile t, chunk at cb): rows
  // s kSetRows + warp R + q, U loads of VEC columns each
  auto load = [&](V (&dst)[R][U], int s, int t, int cb) {
    const int r0 = s * kSetRows + warp * R;
    const int c_lo = t * tile, len = min(tile, ni - c_lo);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = cb + u * kStep + lane * VEC;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const V* pm = reinterpret_cast<const V*>(A.M + (size_t)(r0 + q) * ni + c_lo + c);
        const bool ok = c < len && r0 + q < ni;
        dst[q][u] = ok ? (CLUSTER ? __ldg(pm) : __ldcs(pm)) : V{};
      }
    }
  };
  int s = blockIdx.x, t = 0, cb = 0;
  V nxt[R][U];
  if (s < n_sets) load(nxt, s, 0, 0);
  // every block reads the counter before the ticket (the barrier); the
  // counter is written after it
  const int k0 = __ldcg(A.k);
  const int par = k0 & 1;
  const T* in = A.u + (size_t)par * ni;
  T* out = A.u + (size_t)(par ^ 1) * ni;
  // the cluster form stages both halves (no wait for the counter), the
  // grid form the first tile of the half the counter picks
  if constexpr (CLUSTER)
    stage<T, VEC>(s_u, A.u, 2 * ni);
  else
    stage<T, VEC>(s_u, in, min(tile, ni));
  // every thread of the block has read the counter: the cluster form
  // arrives at the cluster's barrier (its wait comes at the end), the grid
  // form's thread 0 takes the block's ticket, and the block that draws the
  // last one advances the counter and sets the predicate now, since every
  // block has read the counter (no block reads it again)
  if constexpr (CLUSTER) {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  } else if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(A.ticket, 1) == (int)gridDim.x - 1) {
      *A.ticket = 0;
      advance(A, k0);
    }
  }
  const T* xs = CLUSTER ? s_u + (size_t)par * ni : s_u;
  // lane q < R: row r0 + q's interface site and source, read a set ahead
  auto row_inputs = [&](int s, int& rq, int& site, T& sq) {
    rq = s * kSetRows + warp * R + lane;
    const bool mine = lane < R && rq < ni;
    site = mine ? __ldg(A.iidx + rq) : -1;
    sq = mine ? __ldg(A.src + rq) : T(0);
  };
  int rq = 0, site = -1;
  T sq = 0;
  if (s < n_sets) row_inputs(s, rq, site, sq);
  T acc[R];
#pragma unroll
  for (int q = 0; q < R; ++q) acc[q] = T(0);
  while (s < n_sets) {
    V cur[R][U];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int q = 0; q < R; ++q) cur[q][u] = nxt[q][u];
    const int len = min(tile, ni - t * tile);
    int s2 = s, t2 = t, cb2 = cb + kChunk;
    if (cb2 >= len) {
      cb2 = 0;
      if (++t2 == n_tiles) {
        t2 = 0;
        s2 += gridDim.x;
      }
    }
    if (s2 < n_sets) load(nxt, s2, t2, cb2);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = cb + u * kStep + lane * VEC;
      const V x = c < len ? *reinterpret_cast<const V*>(xs + c) : V{};
#pragma unroll
      for (int q = 0; q < R; ++q) acc[q] = dot_fma(cur[q][u], x, acc[q]);
    }
    if (s2 != s) {
      // the set's rows: each row's sum a butterfly, lane q writes row q
      T a = 0;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const T sum = warp_sum(acc[q]);
        if (lane == q) a = sum;
        acc[q] = T(0);
      }
      if (site >= 0) {
        const T tv = A.negate ? -a : a;
        const T tn = add_rn(mul_rn(tv, A.scale), A.T0);
        A.temp[site] = tn;
        out[rq] = add_rn(div_rn(sub_rn(tn, A.T0), A.scale), sq);
      }
      if (s2 < n_sets) row_inputs(s2, rq, site, sq);
    }
    if constexpr (!CLUSTER) {
      if (t2 != t && s2 < n_sets) {
        __syncthreads();
        stage<T, VEC>(s_u, in + (size_t)t2 * tile, min(tile, ni - t2 * tile));
      }
    }
    s = s2;
    t = t2;
    cb = cb2;
  }
  if constexpr (CLUSTER) {
    // every block of the cluster has read the counter: block 0 advances it
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    if (blockIdx.x == 0 && threadIdx.x == 0) advance(A, k0);
  }
}

// The grid form with the whole right-hand side in shared memory: a block
// takes a row at a time (its first row blockIdx.x, then rows drawn from a
// counter, so that the blocks the memory serves faster take more of them),
// each warp a slice of the row's columns in passes of U steps, the next
// pass's loads (the next row's first) issued before the current one's
// products; the row's sum each warp's butterfly, then the warps in order.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 2) heat_dense_rows_kernel(DenseArgs<T> A) {
  using V = typename VecOf<T, VEC>::type;
  constexpr int U = kGridLoads;
  constexpr int kStep = 32 * VEC;
  constexpr int kChunk = kStep * U;
  extern __shared__ __align__(16) unsigned char s_raw[];
  __shared__ T s_part[2][kWarps];
  __shared__ int s_next[2];
  count_launch(A.count);
  const int ni = A.ni;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // this warp's columns of a row, [c_lo, c_hi); every warp makes at least
  // one pass a row
  const int span = (ni + kWarps * VEC - 1) / (kWarps * VEC) * VEC;
  const int c_lo = min(ni, warp * span), c_hi = min(ni, c_lo + span);
  const int passes = c_hi > c_lo ? (c_hi - c_lo + kChunk - 1) / kChunk : 1;
  auto load = [&](V (&dst)[U], int row, int cb) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c_lo + cb + u * kStep + lane * VEC;
      dst[u] = c < c_hi ? __ldcs(reinterpret_cast<const V*>(A.M + (size_t)row * ni + c)) : V{};
    }
  };
  // thread 0 draws the rows; at the first barrier after its block's last
  // draw (a row past ni; every thread of the block has read the substep
  // counter by then) it takes the block's ticket, and the block that draws
  // the last one sets the row counter back, advances the substep counter
  // and sets the predicate
  const int k0 = __ldcg(A.k);
  bool drawn = false, ticketed = false;  // thread 0: the last draw made, the ticket taken
  auto draw = [&]() {
    const int r = (int)gridDim.x + atomicAdd(A.rows, 1);
    drawn = r >= ni;
    return r;
  };
  auto ticket = [&]() {
    if (threadIdx.x != 0 || !drawn || ticketed) return;
    ticketed = true;
    __threadfence();
    if (atomicAdd(A.ticket, 1) == (int)gridDim.x - 1) {
      *A.ticket = 0;
      *A.rows = 0;
      advance(A, k0);
    }
  };
  int row = blockIdx.x;
  V nxt[U];
  load(nxt, row, 0);
  if (threadIdx.x == 0) s_next[0] = draw();
  const int par = k0 & 1;
  T* out = A.u + (size_t)(par ^ 1) * ni;
  T* s_u = reinterpret_cast<T*>(s_raw);
  stage<T, VEC>(s_u, A.u + (size_t)par * ni, ni);
  ticket();
  int next = s_next[0];
  // thread 0: the row's interface site and source
  int site = 0;
  T sq = 0;
  if (threadIdx.x == 0) {
    site = __ldg(A.iidx + row);
    sq = __ldg(A.src + row);
  }
  T acc = 0;
  for (int it = 0; row < ni; ++it) {
    for (int p = 0; p < passes; ++p) {
      V cur[U];
#pragma unroll
      for (int u = 0; u < U; ++u) cur[u] = nxt[u];
      if (p + 1 < passes)
        load(nxt, row, (p + 1) * kChunk);
      else if (next < ni)
        load(nxt, next, 0);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = c_lo + p * kChunk + u * kStep + lane * VEC;
        const V x = c < c_hi ? *reinterpret_cast<const V*>(s_u + c) : V{};
        acc = dot_fma(cur[u], x, acc);
      }
    }
    const T w = warp_sum(acc);
    acc = T(0);
    if (lane == 0) s_part[it & 1][warp] = w;
    // thread 0 draws the row after the next one
    if (threadIdx.x == 0 && next < ni) s_next[(it + 1) & 1] = draw();
    __syncthreads();
    ticket();
    const int after = next < ni ? s_next[(it + 1) & 1] : ni;
    if (threadIdx.x == 0) {
      T a = 0;
      for (int q = 0; q < kWarps; ++q) a += s_part[it & 1][q];
      const T tv = A.negate ? -a : a;
      const T tn = add_rn(mul_rn(tv, A.scale), A.T0);
      A.temp[site] = tn;
      out[row] = add_rn(div_rn(sub_rn(tn, A.T0), A.scale), sq);
      if (next < ni) {
        site = __ldg(A.iidx + next);
        sq = __ldg(A.src + next);
      }
    }
    row = next;
    next = after;
  }
}

// `smem` bytes of dynamic shared memory allowed to `kernel` (beyond the
// default 48 KB only once its attribute is raised), `allowed` the most the
// caller has set for it so far
cudaError_t allow_smem(const void* kernel, size_t smem, size_t* allowed) {
  if (smem <= *allowed) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) *allowed = smem;
  return e;
}

// One launch of a build: the cluster form as one cluster of `grid` blocks
// (beyond 8, a cluster the card allows but does not promise), the grid form
// with the tile's shared memory
template <typename T, int VEC, int R>
int launch_dense(const DenseArgs<T>& A, int cluster, int grid, cudaStream_t st) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaError_t e;
  if (cluster) {
    auto* kernel = heat_dense_substep_kernel<T, VEC, R, true>;
    static bool wide = false;  // this build allowed clusters beyond 8
    if (grid > 8 && !wide) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return (int)e;
      wide = true;
    }
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = grid;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.dynamicSmemBytes = 2 * (size_t)A.ni * sizeof(T);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kernel, A);
  } else {
    auto* kernel = heat_dense_substep_kernel<T, VEC, R, false>;
    const size_t smem = (size_t)(A.tile < A.ni ? A.tile : A.ni) * sizeof(T);
    static size_t allowed = 48 * 1024;
    e = allow_smem(reinterpret_cast<const void*>(kernel), smem, &allowed);
    if (e != cudaSuccess) return (int)e;
    cfg.dynamicSmemBytes = smem;
    cfg.numAttrs = 0;
    e = cudaLaunchKernelEx(&cfg, kernel, A);
  }
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <typename T, int VEC>
int dense_rows(const DenseArgs<T>& A, int cluster, int rows, int grid, cudaStream_t st) {
  switch (rows) {
    case 1:
      return launch_dense<T, VEC, 1>(A, cluster, grid, st);
    case 2:
      return launch_dense<T, VEC, 2>(A, cluster, grid, st);
    case 4:
      return launch_dense<T, VEC, 4>(A, cluster, grid, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The grid form with the right-hand side in one tile: heat_dense_rows_kernel
// on `grid` blocks (at most ni), with the tile's shared memory
template <typename T, int VEC>
int launch_rows(const DenseArgs<T>& A, int grid, cudaStream_t st) {
  auto* kernel = heat_dense_rows_kernel<T, VEC>;
  const size_t smem = (size_t)A.ni * sizeof(T);
  static size_t allowed = 48 * 1024;
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(kernel), smem, &allowed);
  if (e != cudaSuccess) return (int)e;
  const int blocks = grid < A.ni ? grid : A.ni;
  kernel<<<blocks, kThreads, smem, st>>>(A);
  return (int)cudaGetLastError();
}

// forms: 0 sets of rows over the grid, 1 one cluster, 2 a row a block
template <typename T>
int dense_launch(const DenseArgs<T>& A, int form, int rows, int vec, int grid,
                 cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec != kVec && vec != 1) return (int)cudaErrorInvalidValue;
  if (form == 2)
    return vec == kVec ? launch_rows<T, kVec>(A, grid, st) : launch_rows<T, 1>(A, grid, st);
  return vec == kVec ? dense_rows<T, kVec>(A, form, rows, grid, st)
                     : dense_rows<T, 1>(A, form, rows, grid, st);
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
  // scratch: the blocks' (b.b, r.r) pairs [2 grid], the ticket, the grid
  // barrier's counter (boundary_cg's)
  T* part;
  int* ticket;
  unsigned* bar;
  T T0, scale, tol;
  int warm, n, m, maxiter;
  unsigned long long* count;
};

// The sum of `count` pairs part[2 i], part[2 i + 1] (written by other
// blocks: read past L1) by the whole block: thread t adds t, t + kThreads,
// ... in order (4 loads issued before their adds), then the warps'
// butterflies, then the warps in order; in thread 0.
template <typename T>
__device__ __forceinline__ typename Pair<T>::type sum_pairs(const T* part, int count,
                                                            typename Pair<T>::type* s_pair) {
  using T2 = typename Pair<T>::type;
  constexpr int kPass = 4;
  const T2* pc = reinterpret_cast<const T2*>(part);
  T a = 0, q = 0;
  for (int t0 = threadIdx.x; t0 < count; t0 += kThreads * kPass) {
    T2 v[kPass];
#pragma unroll
    for (int k = 0; k < kPass; ++k) {
      const int t = t0 + kThreads * k;
      v[k] = t < count ? __ldcg(pc + t) : T2{T(0), T(0)};
    }
#pragma unroll
    for (int k = 0; k < kPass; ++k) {
      a += v[k].x;
      q += v[k].y;
    }
  }
  a = warp_sum(a);
  q = warp_sum(q);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s_pair[threadIdx.x >> 5] = T2{a, q};
  __syncthreads();
  T2 sum{T(0), T(0)};
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) {
      sum.x += s_pair[w].x;
      sum.y += s_pair[w].y;
    }
  return sum;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) heat_cg_begin_kernel(BeginArgs<T> A) {
  using T2 = typename Pair<T>::type;
  count_launch(A.count);
  __shared__ T2 s_pair[kWarps];
  __shared__ int s_flag;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gl = lane % kBeginLanes, sub = lane / kBeginLanes;
  const int n = A.n, m = A.m;
  // 1. x0 of every row, a row a thread of the grid in turn: (T - T0) / scale
  // on the interface when warm, else 0 (the row lengths are -1 exactly off
  // the interface); r = p = 0 off it
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += gridDim.x * kThreads) {
    const bool on = __ldg(A.row_len + i) >= 0 && __ldg(A.mask + i);
    A.x[i] = on && A.warm ? div_rn(sub_rn(__ldg(A.temp + i), A.T0), A.scale) : T(0);
    if (!on) {
      A.r[i] = T(0);
      A.p[i] = T(0);
    }
  }
  grid_barrier(A.bar);
  // 2. r = b - A x0 on the interface rows, x0 read back (past L1: other
  // blocks wrote it).  The block's chunks of kBeginChunk rows: blockIdx.x,
  // + gridDim.x, ...; a warp's row group in a chunk's pass q: rows ((chunk
  // kBeginPasses + q) kWarps + warp) kBeginRowsPerWarp + sub
  const int n_chunks = (n + kBeginChunk - 1) / kBeginChunk;
  auto len_of = [&](int chunk, int q) {
    const int row = ((chunk * kBeginPasses + q) * kWarps + warp) * kBeginRowsPerWarp + sub;
    return chunk < n_chunks && row < n ? __ldg(A.row_len + row) : -1;
  };
  T bb = 0, rr = 0;  // the group's first lane: its rows' b.b and r.r, in row order
  int len = len_of(blockIdx.x, 0);
  for (int chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const int next = chunk + gridDim.x;
    for (int q = 0; q < kBeginPasses; ++q) {
      const int row = ((chunk * kBeginPasses + q) * kWarps + warp) * kBeginRowsPerWarp + sub;
      const int len_next = q + 1 < kBeginPasses ? len_of(chunk, q + 1) : len_of(next, 0);
      // the row's own inputs (its group's first lane, interface rows)
      unsigned char mk = 0;
      T xi = 0, si = 0, di = 0;
      if (gl == 0 && len >= 0) {
        mk = __ldg(A.mask + row);
        xi = __ldcg(A.x + row);
        si = __ldg(A.src + row);
        di = __ldg(A.diag + row);
      }
      // A x0 on the row (warm; 0 from x0 = 0): lane gl takes the slots gl,
      // gl + kBeginLanes, ... of the prefix, kBeginSlots of them a pass, the
      // index and value loads of a pass issued before its gathers of x0; each
      // lane's products added in slot order
      T s = 0;
      if (A.warm) {
        const size_t e0 = (size_t)row * m;
        for (int base = 0; base < len; base += kBeginLanes * kBeginSlots) {
          int j[kBeginSlots];
          T v[kBeginSlots], xj[kBeginSlots];
#pragma unroll
          for (int k = 0; k < kBeginSlots; ++k) {
            const int e = base + gl + kBeginLanes * k;
            j[k] = e < len ? __ldg(A.nb + e0 + e) : -1;
            v[k] = e < len ? __ldg(A.vals + e0 + e) : T(0);
          }
#pragma unroll
          for (int k = 0; k < kBeginSlots; ++k) xj[k] = j[k] >= 0 ? __ldcg(A.x + j[k]) : T(0);
#pragma unroll
          for (int k = 0; k < kBeginSlots; ++k)
            if (j[k] >= 0) s = fma_rn(v[k], xj[k], s);
        }
      }
      // the row's sum, a butterfly over its group's lanes
#pragma unroll
      for (int o = kBeginLanes / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (gl == 0 && len >= 0 && mk && row < n) {
        const T b = add_rn(xi, si);
        const T ax = fma_rn(di, xi, s);
        const T r = sub_rn(b, ax);
        bb += mul_rn(b, b);
        rr += mul_rn(r, r);
        A.r[row] = r;
        A.p[row] = r;
      }
      len = len_next;
    }
  }
  // the warp's pair: its groups' first lanes in order; the block's: the
  // warps in order
  T wb = 0, wr = 0;
#pragma unroll
  for (int q = 0; q < kBeginRowsPerWarp; ++q) {
    wb += __shfl_sync(0xffffffffu, bb, q * kBeginLanes);
    wr += __shfl_sync(0xffffffffu, rr, q * kBeginLanes);
  }
  if (lane == 0) s_pair[warp] = T2{wb, wr};
  __syncthreads();
  if (threadIdx.x == 0) {
    T2 t{T(0), T(0)};
    for (int w = 0; w < kWarps; ++w) {
      t.x += s_pair[w].x;
      t.y += s_pair[w].y;
    }
    reinterpret_cast<T2*>(A.part)[blockIdx.x] = t;
  }
  if (!last_ticket(A.ticket, 0, gridDim.x, &s_flag)) return;
  const T2 tot = sum_pairs(A.part, gridDim.x, s_pair);
  if (threadIdx.x == 0) {
    const T t_bb = tot.x, t_rr = tot.y;
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

// A cooperative launch (every block resident, for the grid barrier) of a
// build of heat_cg_begin on at most `cap` blocks.
template <typename T>
int launch_begin(const BeginArgs<T>& A, int cap, cudaStream_t st) {
  auto* kernel = heat_cg_begin_kernel<T>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  if (per_sm * sms <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cap < per_sm * sms ? cap : per_sm * sms);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, A);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

int blocks_of(long long rows, int per) { return (int)((rows + per - 1) / per); }

}  // namespace

// One dense substep (heat_dense_substep_kernel): M [ni, ni], u [2, ni],
// src [ni], iidx [ni] (int32), temp [N]; k, n and cond int32 [1], ticket
// int32 [2] (the ticket and the grid form's row counter, zero between calls);
// the form and its constants of ops/heat.py dense_plan: form (0: sets of
// rows on `grid` blocks over tiles of `tile` columns of the right-hand side,
// a multiple of vec; 1: one cluster of `grid` blocks, at most 16, ni at most
// kMaxSmallNi, sets of rows; 2: `grid` blocks a row at a time, the tile the
// whole row), rows a warp of the sets (1, 2 or 4), entries a load (`vec`: 16
// bytes' worth, which M, u and ni must be aligned to, or 1).
extern "C" int dkmc_heat_dense_substep(int is_f64, const void* M, void* u, const void* src,
                                       const void* iidx, void* temp, int ni, double T0,
                                       double scale, int negate, void* k, const void* n,
                                       void* cond, void* ticket, unsigned long long handle,
                                       void* count, void* stream, int form, int rows,
                                       int vec, int tile, int grid) {
  const int isz = is_f64 ? 8 : 4;
  const int span = tile < ni ? tile : ni;
  if (ni <= 0 || grid <= 0 || vec <= 0 || form < 0 || form > 2
      || (form == 1 && (grid > kMaxCluster || ni > kMaxSmallNi))
      || (form == 0 && (tile <= 0 || tile % vec != 0))
      || (form == 2 && tile < ni)
      || (form != 1 && (long long)span * isz > kMaxTileBytes))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto fill = [&](auto& A) {
    using T = typename std::remove_const<
        typename std::remove_pointer<decltype(A.M)>::type>::type;
    A.M = static_cast<const T*>(M);
    A.u = static_cast<T*>(u);
    A.src = static_cast<const T*>(src);
    A.iidx = static_cast<const int*>(iidx);
    A.temp = static_cast<T*>(temp);
    A.k = static_cast<int*>(k);
    A.n = static_cast<const int*>(n);
    A.cond = static_cast<int*>(cond);
    A.ticket = static_cast<int*>(ticket);
    A.rows = static_cast<int*>(ticket) + 1;
    A.handle = handle;
    A.count = static_cast<unsigned long long*>(count);
    A.T0 = (T)T0;
    A.scale = (T)scale;
    A.ni = ni;
    A.negate = negate;
    A.tile = tile;
  };
  if (is_f64) {
    DenseArgs<double> A;
    fill(A);
    return dense_launch(A, form, rows, vec, grid, st);
  }
  DenseArgs<float> A;
  fill(A);
  return dense_launch(A, form, rows, vec, grid, st);
}

// The set-up of one CG solve (heat_cg_begin_kernel) over n rows of m slots
// on at most `grid` blocks, as many as are resident (ops/heat.py
// cg_begin_grid; part holds 2 grid entries, 16-byte aligned); bar the grid
// barrier's counter (int32 [1], boundary_cg's).
extern "C" int dkmc_heat_cg_begin(int is_f64, const void* temp, const void* mask,
                                  const void* src, const void* diag, const void* vals,
                                  const void* nb, const void* row_len, void* x, void* r,
                                  void* p, void* rz, void* rr, void* thresh2, const void* act0,
                                  void* act, void* iters, void* ctl, void* cond, void* part,
                                  void* ticket, double T0, double scale, double tol, int warm,
                                  int n, int m, int maxiter, void* count, void* stream,
                                  int grid, void* bar) {
  if (n <= 0 || m <= 0 || grid <= 0) return (int)cudaErrorInvalidValue;
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
    A.bar = static_cast<unsigned*>(bar);
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
    return launch_begin(A, grid, st);
  }
  BeginArgs<float> A;
  fill(A);
  return launch_begin(A, grid, st);
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
