// One iteration of the warm boundary CG of B replicas, in two kernels: the
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
//   cg_matvec_dot        ap = A p and p.ap of each replica -> alpha = r.z / p.ap
//   cg_update_direction  x += alpha p, r -= alpha ap, z = r / diag, r.z and
//                        r.r -> beta, p = z + beta p, the new stop flags, the
//                        loop's predicate (the transport CG's inner tail is
//                        this update with minv = 1 after its rows, fused in
//                        csrc/transport_cg.cu transport_rows_update)
//
// Bound: bytes.  An iteration needs the operator's nonzeros (8 + 4 bytes
// each in f64; 27.4 a row of the headline crossbar, 51 at most), the
// diagonal, p, ap and the row lengths once, and eight [B, N] vectors for the
// update and direction (x, r, ap, minv, p read; x, r, p written).
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
//   * the update and the direction are one launch with a barrier of the
//     whole grid between them (a cooperative launch: every block resident,
//     the grid capped at what the card holds), so z never leaves the
//     registers of the block that made it and no block waits for a serial
//     last block: after the barrier every block sums the same tiles'
//     partial sums in the same order and gets the same r.z and r.r, and
//     block 0 alone writes the replicas' scalars, flags and the predicate;
//     tiles of 512 rows, two a thread: of 1, 2, 3, 4 and 8 rows a thread
//     and a launch that is not cooperative (tools/probe_cg_events.py
//     --parts update --variants, on an H100 80GB HBM3 at 700 W) none was
//     faster at the crossbar's system by more than the noise; clock64()
//     stamps put the barrier and the sums after it at half of a block's time;
//   * every reduction is a fixed tree: a butterfly in the warp, warps in
//     order; the matvec's blocks' partial sums in slots of their own that
//     the block which draws a replica's last ticket (csrc/ticket.cuh) adds
//     in a fixed order (strided over its threads, then butterflies, then
//     warps), with a grid that depends on N only; the update's partial sums
//     one a tile of kTile rows, added in tile order.  No float atomics: two
//     runs give the same bits, and a replica's bits do not depend on B;
//   * a stopped replica's matvec blocks leave at once; its update tiles are
//     skipped, but their blocks reach the barrier;
//   * nothing allocates: every buffer comes from the caller, so the two
//     launches can be captured into the body of a conditional node.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_sync.cuh"
#include "launch_count.cuh"
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
// cg_update_direction: tiles of kTile rows, kRows a thread (rows k kThreads +
// threadIdx.x of the tile); the tiles of one block span kMaxSpan replicas at
// most (a bit each)
constexpr int kRows = 2;
constexpr int kTile = kThreads * kRows;
constexpr int kMaxSpan = 64;

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

// a product rounded on its own (never fused into an add), and a fused
// multiply-add: the update and direction spell out each rounding, so that z
// comes out the same from registers and from r read again
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }

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
                     int n, int m, unsigned long long* count) {
  count_launch(count);
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

// r.z and r.r of one replica from its tiles' partial sums (pairs, written
// by other blocks: read past L1), in every lane of the calling warp and with
// the same bits in whichever warp and block: lane l adds tiles l, l + 32, ...
// in order (kPass of them loaded before any is added), then a butterfly.
// Every lane of the warp calls it.
template <typename T>
__device__ __forceinline__ void tile_sums(const T* part, int n_tiles, T& s_rz, T& s_rr) {
  using T2 = typename Pair<T>::type;
  constexpr int kPass = 8;
  const T2* pc = reinterpret_cast<const T2*>(part);
  T a = 0, q = 0;
  for (int t0 = threadIdx.x & 31; t0 < n_tiles; t0 += 32 * kPass) {
    T2 v[kPass];
#pragma unroll
    for (int k = 0; k < kPass; ++k) {
      const int t = t0 + 32 * k;
      v[k] = t < n_tiles ? __ldcg(pc + t) : T2{T(0), T(0)};
    }
#pragma unroll
    for (int k = 0; k < kPass; ++k) {
      a += v[k].x;
      q += v[k].y;
    }
  }
  s_rz = warp_sum(a);
  s_rr = warp_sum(q);
}

// One launch after cg_matvec_dot: the update x += alpha p, r -= alpha ap,
// z = r / diag with the partial sums of r.z and r.r, a barrier of the grid,
// every block's sums, beta and the direction p = z + beta p.  The grid's
// blocks take `per` consecutive items (replica b, tile t), t a tile of kTile
// rows; a tile's partial sums go to its own slot (part[2 (b n_tiles + t)]),
// so the sums' bits depend on N alone, not on B or the grid.  The block's
// first tile keeps z and the old p in registers to the direction; its other
// tiles read r, minv and p again.  Block 0 writes every replica's r.z, r.r,
// beta, count and flag, the loop's count and predicate and sets the WHILE
// node's condition; the other blocks read act and rz before the barrier.
template <typename T>
__global__ void __launch_bounds__(kThreads)
cg_update_direction_kernel(T* __restrict__ x, T* __restrict__ r, T* __restrict__ p,
                           const T* __restrict__ ap, const T* __restrict__ minv,
                           unsigned char* __restrict__ act,
                           const unsigned char* __restrict__ act0, const T* __restrict__ alpha,
                           T* __restrict__ beta, T* __restrict__ rz, T* __restrict__ rr,
                           const T* __restrict__ thresh2, long long* __restrict__ iters,
                           T* __restrict__ part, unsigned* __restrict__ bar,
                           int* __restrict__ ctl, int* __restrict__ cond,
                           unsigned long long* __restrict__ total, unsigned long long handle,
                           int n, int batch, int per, int maxiter) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (n + kTile - 1) / kTile;
  const int first = blockIdx.x * per, last = min(first + per, batch * n_tiles);
  const int b_lo = first / n_tiles, span = (last - 1) / n_tiles - b_lo + 1;
  __shared__ T s_part[2][kWarps];
  __shared__ T s_rzo[kMaxSpan], s_beta[kMaxSpan];
  __shared__ int s_cnt[kWarps];
  // the entry flags of the replicas this block's tiles span, and their r.z
  unsigned long long on = 0;
  for (int j = 0; j < span; ++j) on |= (unsigned long long)(act[b_lo + j] != 0) << j;
  if ((int)threadIdx.x < span) s_rzo[threadIdx.x] = rz[b_lo + threadIdx.x];

  // block 0: the scalars of each warp's first replica and the loop's count,
  // read before the barrier so that its tail after it waits on no load
  const bool writer = blockIdx.x == 0;
  long long it_w = 0;
  T rz_w = 0, rr_w = 0, th_w = 0;
  bool on_w = false, a0_w = false;
  int ctl_0 = 0;
  if (writer && warp < batch) {
    it_w = iters[warp];
    rz_w = rz[warp];
    rr_w = rr[warp];
    th_w = thresh2[warp];
    on_w = act[warp] != 0;
    a0_w = act0[warp] != 0;
  }
  if (writer && threadIdx.x == 0) ctl_0 = ctl[0];

  // 1. each tile of an iterating replica: the update and its partial sums
  // (each thread's rows in order, the warp's butterfly, the warps in order)
  T zh[kRows], ph[kRows];
  for (int w = first; w < last; ++w) {
    const int b = w / n_tiles;
    if (!((on >> (b - b_lo)) & 1)) continue;
    const int t = w - b * n_tiles;
    const T a = alpha[b];
    T s_rz = 0, s_rr = 0;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int i = t * kTile + k * kThreads + threadIdx.x;
      if (i < n) {
        const size_t e = (size_t)b * n + i;
        const T pe = p[e];
        const T rn = fma_rn(-a, ap[e], r[e]);
        const T zn = mul_rn(minv[e], rn);
        x[e] = fma_rn(a, pe, x[e]);
        r[e] = rn;
        s_rz = fma_rn(rn, zn, s_rz);
        s_rr = fma_rn(rn, rn, s_rr);
        if (w == first) {
          zh[k] = zn;
          ph[k] = pe;
        }
      }
    }
    s_rz = warp_sum(s_rz);
    s_rr = warp_sum(s_rr);
    if (lane == 0) {
      s_part[0][warp] = s_rz;
      s_part[1][warp] = s_rr;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      T t0 = 0, t1 = 0;
      for (int q = 0; q < kWarps; ++q) {
        t0 += s_part[0][q];
        t1 += s_part[1][q];
      }
      part[2 * (size_t)w] = t0;
      part[2 * (size_t)w + 1] = t1;
    }
    __syncthreads();
  }

  // 2. every tile's partial sums written
  grid_barrier(bar);

  // 3. r.z, r.r and beta of the replicas spanned, a warp each; block 0 also
  // of every other replica, whose scalars and flags it writes (a warp's
  // first replica's from what it read before the barrier)
  const int c_end = writer ? batch : b_lo + span;
  int n_act = 0;
  for (int c = (writer ? 0 : b_lo) + warp; c < c_end; c += kWarps) {
    const bool pre = writer && c == warp;
    const bool in_span = c >= b_lo && c < b_lo + span;
    const bool it = in_span ? ((on >> (c - b_lo)) & 1) != 0 : pre ? on_w : act[c] != 0;
    T rr_c = 0;
    if (it) {
      T s_rz, s_rr;
      tile_sums(part + 2 * (size_t)c * n_tiles, n_tiles, s_rz, s_rr);
      const T rz_o = in_span ? s_rzo[c - b_lo] : pre ? rz_w : rz[c];
      const T be = rz_o != T(0) ? s_rz / rz_o : T(0);
      if (in_span && lane == 0) s_beta[c - b_lo] = be;
      if (writer && lane == 0) {
        beta[c] = be;
        rz[c] = s_rz;
        rr[c] = s_rr;
        iters[c] = (pre ? it_w : iters[c]) + 1;
      }
      rr_c = s_rr;
    } else if (writer) {
      rr_c = pre ? rr_w : rr[c];
    }
    if (writer && lane == 0) {
      const bool go_c = (pre ? a0_w : act0[c] != 0) && rr_c > (pre ? th_w : thresh2[c]);
      act[c] = go_c;
      n_act += go_c;
    }
  }
  if (lane == 0) s_cnt[warp] = n_act;
  __syncthreads();

  // 4. the direction of each tile of an iterating replica: z and the old p
  // of the first from registers, of the others z again from r and minv (the
  // same product, so the same bits)
  for (int w = first; w < last; ++w) {
    const int b = w / n_tiles;
    if (!((on >> (b - b_lo)) & 1)) continue;
    const int t = w - b * n_tiles;
    const T be = s_beta[b - b_lo];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int i = t * kTile + k * kThreads + threadIdx.x;
      if (i < n) {
        const size_t e = (size_t)b * n + i;
        const T pn =
            w == first ? fma_rn(be, ph[k], zh[k]) : fma_rn(be, p[e], mul_rn(minv[e], r[e]));
        p[e] = pn;
      }
    }
  }

  // 5. block 0: the iterations run, the replicas iterating, the predicate
  if (writer && threadIdx.x == 0) {
    int n_on = 0;
    for (int q = 0; q < kWarps; ++q) n_on += s_cnt[q];
    const int it = ctl_0 + 1;
    ctl[0] = it;
    ctl[1] = n_on;
    const int go = n_on > 0 && it < maxiter;
    cond[0] = go;
    *total += 1;
    if (handle) cudaGraphSetConditional(handle, go);
  }
}

bool bad_shape(int n, int m, int batch, int grid) {
  return n <= 0 || m <= 0 || batch <= 0 || batch > 65535 || grid <= 0;
}

// Blocks of a build of cg_update_direction that the current card holds at
// once.
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

// The grid of a build of cg_update_direction for B = batch replicas of n
// rows: `per` consecutive (replica, tile) items a block, as few a block as
// the resident blocks allow, and no block without one.
// cudaErrorCooperativeLaunchTooLarge when no block is resident or a block's
// items would span more than kMaxSpan replicas.
template <typename K>
int update_grid(K kernel, int n, int batch, int* grid, int* per) {
  if (bad_shape(n, 1, batch, 1)) return (int)cudaErrorInvalidValue;
  const long long n_tiles = (n + kTile - 1) / kTile;
  const long long items = batch * n_tiles;
  const int cap = resident_blocks(kernel);
  if (cap <= 0 || items > 0x7fffffffLL) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long pr = (items + cap - 1) / cap;
  if ((pr + n_tiles - 2) / n_tiles + 1 > kMaxSpan)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  *per = (int)pr;
  *grid = (int)((items + pr - 1) / pr);
  return 0;
}

// A cooperative launch of a build of cg_update_direction (every block
// resident at once, as the barrier needs) on the grid of update_grid.
template <typename T>
int launch_update(void* x, void* r, void* p, const void* ap, const void* minv, void* act,
                  const void* act0, const void* alpha, void* beta, void* rz, void* rr,
                  const void* thresh2, void* iters, void* part, void* bar, void* ctl,
                  void* cond, void* total, unsigned long long handle, int n, int batch,
                  int maxiter, void* stream) {
  auto* kernel = cg_update_direction_kernel<T>;
  int grid = 0, per = 0;
  const int err = update_grid(kernel, n, batch, &grid, &per);
  if (err != 0) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<T*>(x), static_cast<T*>(r), static_cast<T*>(p),
      static_cast<const T*>(ap), static_cast<const T*>(minv), static_cast<unsigned char*>(act),
      static_cast<const unsigned char*>(act0), static_cast<const T*>(alpha),
      static_cast<T*>(beta), static_cast<T*>(rz), static_cast<T*>(rr),
      static_cast<const T*>(thresh2), static_cast<long long*>(iters), static_cast<T*>(part),
      static_cast<unsigned*>(bar), static_cast<int*>(ctl), static_cast<int*>(cond),
      static_cast<unsigned long long*>(total), handle, n, batch, per, maxiter);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

extern "C" int dkmc_cg_matvec_dot(int is_f64, const void* diag, const void* vals,
                                  const void* nb, const void* row_len, const void* p, void* ap,
                                  const void* act, const void* rz, void* alpha, void* part,
                                  void* tickets, int n, int m, int batch, int grid,
                                  void* count, void* stream) {
  if (bad_shape(n, m, batch, grid)) return (int)cudaErrorInvalidValue;
  const dim3 g(grid, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* len = static_cast<const int*>(row_len);
  const auto* a = static_cast<const unsigned char*>(act);
  const auto* ix = static_cast<const int*>(nb);
  auto* cnt = static_cast<unsigned long long*>(count);
  if (is_f64)
    cg_matvec_dot_kernel<double><<<g, kThreads, 0, st>>>(
        static_cast<const double*>(diag), static_cast<const double*>(vals), ix, len,
        static_cast<const double*>(p), static_cast<double*>(ap), a,
        static_cast<const double*>(rz), static_cast<double*>(alpha),
        static_cast<double*>(part), static_cast<int*>(tickets), n, m, cnt);
  else
    cg_matvec_dot_kernel<float><<<g, kThreads, 0, st>>>(
        static_cast<const float*>(diag), static_cast<const float*>(vals), ix, len,
        static_cast<const float*>(p), static_cast<float*>(ap), a,
        static_cast<const float*>(rz), static_cast<float*>(alpha),
        static_cast<float*>(part), static_cast<int*>(tickets), n, m, cnt);
  return (int)cudaGetLastError();
}


// The grid of cg_update_direction (its f32 or f64 boundary build) for B =
// batch replicas of n rows (update_grid).
extern "C" int dkmc_cg_update_direction_grid(int is_f64, int n, int batch, int* grid,
                                             int* per) {
  return is_f64 ? update_grid(cg_update_direction_kernel<double>, n, batch, grid, per)
                : update_grid(cg_update_direction_kernel<float>, n, batch, grid, per);
}

extern "C" int dkmc_cg_update_direction(int is_f64, void* x, void* r, void* p, const void* ap,
                                        const void* minv, void* act, const void* act0,
                                        const void* alpha, void* beta, void* rz, void* rr,
                                        const void* thresh2, void* iters, void* part,
                                        void* bar, void* ctl, void* cond, void* total,
                                        unsigned long long handle, int n, int batch,
                                        int maxiter, void* stream) {
  auto launch = is_f64 ? launch_update<double> : launch_update<float>;
  return launch(x, r, p, ap, minv, act, act0, alpha, beta, rz, rr, thresh2, iters,
                part, bar, ctl, cond, total, handle, n, batch, maxiter, stream);
}
