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
//   transport_blocks  every part of the product that reads the packed
//                     vector alone: T_vm x_m, T_vv x_v, the columns
//                     T_vm^T x_v, the bump over the bucket's neighbours
//                     (f32 build) and the two virtual-node dots; it runs on
//                     a branch beside the band (ops/transport_cg.products)
//   transport_rows_update
//                     the inner iteration's tail (f32), one cooperative
//                     launch: every row of ap = A p (band part, a bf16
//                     band's row_fix, bump, metal row through mp_inv,
//                     vacancy slot, virtual rows, diagonal, dsi) and p.ap;
//                     a barrier of the grid; alpha = r.z / p.ap, x += alpha
//                     p, r -= alpha ap, z = r (the system is Jacobi-scaled:
//                     minv = 1) and r.r; a barrier; beta, p = z + beta p
//                     packed as the next product reads it (xs = dsi p, the
//                     band's window, the metal vector), the stop flag, the
//                     counts and the inner predicate (also the WHILE node's
//                     condition): boundary_cg.cu's cg_update_direction with
//                     minv = 1, after the rows
//   transport_rows    the refinement's f64 residual: every row (ELL part,
//                     metal row, vacancy slot, virtual rows, diagonal, dsi),
//                     r = b - A x and r.r
//   transport_pack    the refinement's iterate: x += f64(inner x) scale (the
//                     finished round's correction), then the scaled vector
//                     xs = dsi * x and its f32 metal part
//   transport_refine  the end of a round (and the set-up): ||r||, the
//                     rounds and inner iterations counted, the outer
//                     predicate (also the outer WHILE node's condition), the
//                     scale, b_in = f32(r / scale), the round's tolerance
//                     and the inner CG's set-up (x = 0, r = p = b_in, p
//                     packed as the inner product reads it, r.r, its
//                     threshold and predicate); the tiles' b_in.b_in
//                     added by the block that draws the last ticket
//
//   stored_matvec     the stored metal block's product y = T_cc x_m (f32
//                     in mixed precision, f64 in f64), in the fly matvec's
//                     place when the block is stored (transport_cc =
//                     "stored", what "auto" picks): the JAX package's
//                     jnp.matmul(T_cc, xm) (devicekmc_tpu/physics/
//                     current.py:802) inside its jitted superstep
//   transport_tail64  the f64 solve's tail (Jacobi CG, criterion "pre", on
//                     the unscaled system: the JAX package's cg_solve,
//                     devicekmc_tpu/ops/cg.py:40-118), one cooperative
//                     launch: every row of ap = A p (transport_rows' row)
//                     and p.ap; a barrier of the grid; alpha, x += alpha p,
//                     r -= alpha ap, z = r / diag and r.z; a barrier; beta,
//                     p = z + beta p packed into the full vector and the
//                     metal vector; the flag, count and predicate (also the
//                     WHILE node's condition)
//
// So the inner body is band | (fly or stored, transport_blocks), then
// transport_rows_update; a round's end is transport_pack, fly or stored,
// transport_blocks (f64), transport_rows and transport_refine.  The f64
// solve's body is stored | transport_blocks (f64 blocks), then
// transport_tail64.
//
// Bound: bytes.  An inner iteration reads the band (static, about 2 GB at
// the crossbar's width: its own kernel), the vacancy blocks' live rows once
// (8.1 + 1.3 MB at 572 live slots and 3,527 metal atoms) and a few [N]
// vectors; the rest is small.
// Design:
//
//   * transport_blocks reads each live element of T_vm once for both of its
//     products: a block takes a work item, the live ones (n_vac, read on
//     the device) in the first blocks: the two dots, the bump's and T_vv's
//     groups of live slots, then the live tiles of kBlockRows rows x
//     kBlockCols columns, a warp kRowsPerWarp rows, a lane kColsPerLane
//     columns (all kRowsPerWarp x kColsPerLane loads issued before any is
//     used); the rows' partial sums (one a column tile) and the columns'
//     (one a live row tile) go to slots of their own, and the block that
//     draws a column tile's or a row tile's last ticket adds them in tile
//     order, so that a metal row later reads one value; the two tickets are
//     drawn side by side by threads 0 and 32 (csrc/ticket.cuh
//     last_ticket_acq_rel: an acquire-release atomic after the barrier that
//     orders the block's slots, no fences), a column's slots loaded at once;
//     T_vv's rows a warp each against x_v gathered into shared memory, the
//     row's first two passes of loads issued before the gather; the bump's
//     and the dots' loads issued before any is used; 40 registers in the
//     f32 builds, so that the crossbar's 680 live blocks fit the card's
//     first wave (6 blocks an SM).  tools/probe_cg_events.py on an H100
//     80GB HBM3 at 700 W: the parent's two last_tickets (fences, barriers)
//     and strip sums 1.85 us of a tile block's 5.3; a persistent grid of 2
//     blocks an SM with each block's tiles through a cp.async ring was 18 %
//     slower than the parent's block a tile, its items' chains one after
//     another, and this design with each tile staged through shared memory
//     by cp.async 11 % slower than with its loads in registers (PERF.md);
//   * transport_rows_update keeps each row's ap, p, dsi and slots in
//     registers from the rows to the direction, so ap is written once and
//     never read back, p read once; a thread starts the loads of all its
//     rows' own entries and slots, then of all the values the slots point
//     at, before it adds any (two levels of latency, not one a slot); kRuRows rows a
//     thread in tiles of kRuTile rows (rows t, t + kRuThreads, ... of a
//     tile), a block the tiles [b per, (b + 1) per) of which the first
//     stays in registers (the others read their rows again), the grid
//     capped at the blocks the card holds (a cooperative launch,
//     csrc/grid_sync.cuh); each tile's partial sums of p.ap and r.r go to
//     slots of their own, and after each barrier warp 0 of every block adds
//     the same slots in the same order (lane l: the four slots of groups
//     l, l + 32, ..., then a butterfly), so every block has the same alpha
//     and beta and no block waits for a last one.  The last-ticket sum of
//     the two kernels it replaces (transport_rows' f32 build and the
//     transport build of cg_update_direction) is gone with their ap round
//     trip, their second read of p and a node of the WHILE body; a stopped
//     iterate's launch leaves at once (block 0 writes the flags and counts).
//     tools/probe_cg_events.py on an H100 80GB HBM3 at 700 W: one row a
//     thread in 152 blocks of 512 the fastest of 1-4 rows and 256-1,024
//     threads (none of them apart by more than 10 %), the barriers and sums
//     after them 62 % of a block's time (clock64() stamps); every warp of
//     every block adding the slots put tens of thousands of loads on the
//     same L2 lines (6.8 us for a barrier at 304 blocks), one block an SM
//     and a sleep between a barrier's polls were no faster;
//   * transport_rows (f64) takes one row a thread in tiles of kThreads rows
//     (bytes: the valid slots of the atom graph, 17.83 of 51 a row at the
//     crossbar, and a few [N] vectors; the row-major [Na, 51] ELL of f64
//     conductances and int32 indices, read whole a thread a row, made a
//     warp's load of a slot touch 32 rows 408 and 204 bytes apart); the
//     atom graph is a sliced ELL made once a structure, before any capture
//     (ops/transport_cg.py atom_slices): a warp's rows a slice, each row's
//     valid neighbours in the graph's order, slot-major, so a warp's load
//     of a slot is 128
//     consecutive bytes and no pad past the slice's longest row is read;
//     the conductance, one of two constants, comes from the two atoms'
//     classes (a byte an atom the assembly writes, gathered from L2) as the
//     assembly's nb_vals chooses it, so a slot costs 4 bytes, not 12; a
//     row's slots in passes of kEll whose loads all start before the first
//     is used; the tiles' partial sums are added in tile order by the block
//     that draws the last ticket;
//   * transport_refine, a plain launch of a block a tile of kTile rows:
//     nothing after the sum of b_in.b_in is read by another block, so the
//     last ticket's block adds the tiles' slots and writes the scalars and
//     every other block leaves after its stores; thread 0 draws the ticket
//     before the rows' stores go out (ticket.cuh's last_ticket_acq_rel: one
//     atomic with release and acquire semantics orders the tile's slot
//     alone), so no fence or barrier waits for the atomic or for the
//     scattered stores of the window and the metal vector; the scalars that
//     do not need the sum (the rounds, the predicate, the round's tolerance
//     with its f64 divide) are worked out while the rows' loads are in
//     flight, so the tail after the sum is a square root, two products and
//     the stores.  A cooperative launch waited at a barrier of the grid
//     for block 0 to go on alone (tools/probe_cg_events.py --parts
//     transport stamps both forms);
//   * every sum has a fixed order and no float atomics are used: two runs
//     give the same bits, and graph and host loop the same iterates;
//   * the row arithmetic spells out each rounding (products rounded on
//     their own, then added) in the order of the plain version, so that a
//     row differs from it only through the sums that reduce in another
//     order; a bf16 band's row_fix x is added to the band's value first, a
//     rounded product and a rounded sum, where the eager bf16 operator adds
//     it (physics/current.py _band_unpermute), not folded into the f32
//     diagonal at assembly: (diag + row_fix) x would round once where the
//     plain version rounds twice, so the CPU result would no longer be
//     cg_solve_mixed's bit for bit;
//   * stored_matvec (bytes: the block once, 49.8 MB in f32 at the crossbar's
//     3,527 metal atoms, 2.45 GB at the reference's 24,768): a warp a row,
//     16-byte loads, kSmLoads of them in flight a lane; a block of at most
//     kSmPastL1L2s of the card's L2s (the crossbar's, 1 and 2 L2s in f32
//     and f64) loads past L1, which took a captured stored iteration from
//     0.044 to 0.037 ms on an H100 (x and what the branch beside it reads
//     stay in L1), a larger one (24,768: 49 and 98 L2s) through L1, which
//     was 1-4 % faster there after a dirty L2 (PERF.md); a persistent grid
//     of equal row ranges, an L2 evict-first policy and TMA bulk copies into
//     shared memory were measured and gained nothing over it; a row's head
//     before its first 16-byte boundary and its tail a lane an element, the
//     head's product deferred until its first vectors are on their way; one
//     fixed order a row, so graph and host loop get the same bits and f32
//     never meets TF32;
//   * transport_tail64 is the f64 rows (transport_rows' row_product, a row
//     a thread, 512-row tiles whose halves are transport_rows' 256-row
//     tiles of p.ap) and the update in one cooperative launch: ap, p, z and
//     the metal slot of the first tile stay in registers across its two
//     grid barriers, after each of which every block sums the same slots in
//     the same order (alpha: sum_partials' order of the halves; beta: warp
//     0, lane-strided) and so has the same scalars; every operand of a row's
//     update is loaded before any is used, the slots' loads issued
//     together; block 0 alone writes the scalars.  The rows' last ticket,
//     one launch of the WHILE body and ap's round trip through memory went
//     with the pair it replaced (transport_rows' product form, then
//     transport_update64: PERF.md has both timed in turns);
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
// transport_refine: tiles of kTile rows, kRows a thread (rows k kThreads +
// threadIdx.x of the tile), whose partial sums have a slot of their own
constexpr int kRows = 2;
constexpr int kTile = kThreads * kRows;
// transport_blocks: tiles of T_vm of kBlockRows x kBlockCols, kRowsPerWarp
// rows a warp and kColsPerLane columns a lane (lane l: l, l + 32, ...)
constexpr int kRowsPerWarp = 4;
constexpr int kBlockRows = kWarps * kRowsPerWarp;
constexpr int kColsPerLane = 4;
constexpr int kBlockCols = 32 * kColsPerLane;
// transport_blocks: T_vv's loads a lane in each of the two passes in
// flight, the bump's (max_nn up to 32 kBumpLoads in one pass), a dot's,
// x_v's gather's, and the tile sums' (a column's over up to 32 kColSumLoads
// live row tiles, a row's over the column tiles)
constexpr int kVvLoads = 8;
constexpr int kBumpLoads = 2;
// transport_blocks: the blocks an SM its registers allow (40 and 64 a
// thread): the crossbar's live items (680 blocks at 578 live slots) in one
// wave of f32 blocks
template <typename S>
constexpr int kBlocksPerSm = sizeof(S) == 4 ? 6 : 4;
constexpr int kDotLoads = 8;
constexpr int kGather = 4;
constexpr int kColSumLoads = 16;
constexpr int kSumLoads = 8;
// transport_rows (f64): rows a slice of the atom graph (a warp's rows,
// ops/transport_cg.py ATOM_SLICE), and slots a pass, their loads issued
// together
constexpr int kSlice = 32;
constexpr int kEll = 8;
static_assert(kThreads % kSlice == 0, "a block of transport_rows holds whole slices");
// stored_matvec: threads a block (a warp a row), blocks an SM (the launch
// bound), 16-byte loads a lane in flight, and the card's L2s of block up to
// which the block's loads go past L1
constexpr int kSmThreads = 256;
constexpr int kSmWarps = kSmThreads / 32;
constexpr int kSmBlocks = 4;
constexpr int kSmLoads = 4;
constexpr int kSmPastL1L2s = 4;
// transport_tail64: threads a block, a row a thread (a tile)
constexpr int kUpThreads = 512;
constexpr int kUpWarps = kUpThreads / 32;
// transport_rows_update: threads a block and rows a thread (rows t, t +
// kRuThreads, ... of a tile of kRuTile rows); tools/probe_cg_events.py
// --parts transport --variants times other values
constexpr int kRuThreads = 512;
constexpr int kRuRows = 1;
constexpr int kRuWarps = kRuThreads / 32;
constexpr int kRuTile = kRuThreads * kRuRows;
// the caller's partial sums hold two slots for every RU_MIN_TILE rows and
// four more (ops/transport_cg.py): the r.r slots start 16-byte aligned
static_assert(kRuTile >= 128, "a tile of transport_rows_update holds 128 rows or more");

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
// the warps' butterflies and the warps in order (kW warps); in thread 0.
template <typename T, int kW = kWarps>
__device__ __forceinline__ T block_sum(T v, T* s_warp) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  T sum = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kW; ++w) sum += s_warp[w];
  __syncthreads();
  return sum;
}

// The sum of `count` partials (written by other blocks: read past L1; 16-
// byte aligned) in every thread of the block, with the same bits in every
// block: warp 0 alone reads them, 16 bytes a load (lane l: the four slots
// of groups l, l + 32, ..., kPass groups loaded before any is added, each
// group's slots below `count` added in order), then a butterfly; the sum
// reaches the other warps through `s_sum`.  Every thread calls it.
__device__ __forceinline__ float block_sum_partials(const float* part, int count,
                                                    float* s_sum) {
  if (threadIdx.x < 32) {
    constexpr int kPass = 4;
    const float4* p4 = reinterpret_cast<const float4*>(part);
    const int n4 = (count + 3) >> 2;
    float a = 0.f;
    for (int q0 = threadIdx.x; q0 < n4; q0 += 32 * kPass) {
      float4 v[kPass];
#pragma unroll
      for (int k = 0; k < kPass; ++k) {
        const int q = q0 + 32 * k;
        v[k] = q < n4 ? __ldcg(p4 + q) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < kPass; ++k) {
        const int t = 4 * (q0 + 32 * k);
        if (t < count) a += v[k].x;
        if (t + 1 < count) a += v[k].y;
        if (t + 2 < count) a += v[k].z;
        if (t + 3 < count) a += v[k].w;
      }
    }
    a = warp_sum(a);
    if (threadIdx.x == 0) *s_sum = a;
  }
  __syncthreads();
  return *s_sum;
}

// The sum of slots q, q + lanes, ... below count of a column of partial sums
// (base[k stride], written by other blocks: read past L1), in order, with
// kLoads loads in flight; 0 unless `on`.
template <int kLoads, typename S>
__device__ __forceinline__ S sum_strided(const S* base, size_t stride, int q, int lanes,
                                         int count, bool on) {
  S a = S(0);
  if (!on) return a;
  for (int k0 = q; k0 < count; k0 += lanes * kLoads) {
    S v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int k = k0 + u * lanes;
      v[u] = k < count ? __ldcg(base + (size_t)k * stride) : S(0);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) a += v[u];
  }
  return a;
}

// ----------------------------------------------------------------------------
// transport_pack (f64)
// ----------------------------------------------------------------------------

// Thread i of [0, n_full): the corrected iterate x[i] += f64(xi[i]) scale
// (`first`: x as it is), the scaled full vector xs[i] = dsi[i] x[i] (0 on
// the grounded last atom, i = nsub) and its atom's slot of the metal vector
// (xm[k], k = mp_inv[a], a = i - 2).
__global__ void __launch_bounds__(kThreads)
transport_pack_kernel(const double* __restrict__ dsi, double* __restrict__ x,
                      const float* __restrict__ xi, const double* __restrict__ scale, int first,
                      const int* __restrict__ mp_inv, int nsub, int n_full,
                      double* __restrict__ xs, float* __restrict__ xm,
                      unsigned long long* count) {
  count_launch(count);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_full) return;
  double v = 0;
  if (i < nsub) {
    double xv = x[i];
    if (!first) {
      xv = add_rn(xv, mul_rn((double)xi[i], scale[0]));
      x[i] = xv;
    }
    v = mul_rn(dsi[i], xv);
  }
  xs[i] = v;
  if (i < 2) return;
  const int k = mp_inv[i - 2];
  if (k >= 0) xm[k] = (float)v;
}

// ----------------------------------------------------------------------------
// transport_blocks
// ----------------------------------------------------------------------------

template <typename T, typename S>
struct BlocksArgs {
  // the packed vector [n_full] and its metal part [n_mp] (S: the blocks'
  // storage, f32 in mixed precision, f64 in f64)
  const T* xs;
  const S* xm;
  // the vacancy blocks, the bucket and its live count
  const S* T_vm;
  const S* T_vv;
  const int* vidx;
  const int* n_vac;
  // lo: the bump's values [vcap, max_nn] (f32) over the atom graph [na,
  // max_nn] (int32, pad -1)
  const float* dyn;
  const int* anb;
  // the virtual rows: gnd nonzero on atoms gnd_lo .. na - 1, src on 0 ..
  // nsi - 1
  const T* gnd;
  const T* src;
  int gnd_lo, nsi, na, max_nn, vcap, n_mp;
  // out: the column sums T_vm^T x_v [n_mp], T_vm x_m, T_vv x_v [vcap] (S)
  // and the bump [vcap] (f32), the dots [2]
  S* mv;
  S* y_vm;
  S* y_vv;
  float* y_bump;
  T* dots;
  // scratch: the column tiles' partial sums [n_rt, n_mp], the row tiles'
  // [n_ct, vcap], the tickets [n_ct + n_rt] (column tiles, then row tiles)
  S* col_part;
  S* row_part;
  int* tickets;
  unsigned long long* count;
};

// T_vv's row s (a warp; lane l: j = l, l + 32, ... below nv) against x_v
// in shared memory, the lane's terms in order, then the warp's butterfly;
// the lane's loads in passes of kVvLoads through two buffers, two passes in
// flight before the first is used (the first two, v0 and v1, issued by the
// caller).
template <typename S>
__device__ __forceinline__ void vv_loads(const S* row, int j0, int nv, S (&v)[kVvLoads]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < kVvLoads; ++u) {
    const int j = j0 + lane + 32 * u;
    v[u] = j < nv ? __ldg(row + j) : S(0);
  }
}

template <typename S>
__device__ __forceinline__ void vv_terms(const S (&v)[kVvLoads], int j0, int nv,
                                         const S* s_xall, S& c) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < kVvLoads; ++u) {
    const int j = j0 + lane + 32 * u;
    if (j < nv) c = fma_rn(v[u], s_xall[j], c);
  }
}

// the loads of the passes at j0 and j0 + 32 kVvLoads (where it holds live
// slots)
template <typename S>
__device__ __forceinline__ void vv_two_passes(const S* row, int j0, int nv, S (&v0)[kVvLoads],
                                              S (&v1)[kVvLoads]) {
  vv_loads(row, j0, nv, v0);
  if (j0 + 32 * kVvLoads < nv) vv_loads(row, j0 + 32 * kVvLoads, nv, v1);
}

template <typename T, typename S>
__device__ __forceinline__ void vv_row(const BlocksArgs<T, S>& A, int s, int nv, const S* s_xall,
                                       S (&v0)[kVvLoads], S (&v1)[kVvLoads]) {
  constexpr int kPass = 32 * kVvLoads;
  const S* row = A.T_vv + (size_t)s * A.vcap;
  S c = S(0);
  for (int j0 = 0; j0 < nv; j0 += 2 * kPass) {
    if (j0 > 0) vv_two_passes(row, j0, nv, v0, v1);
    vv_terms(v0, j0, nv, s_xall, c);
    if (j0 + kPass < nv) vv_terms(v1, j0 + kPass, nv, s_xall, c);
  }
  c = warp_sum(c);
  if ((threadIdx.x & 31) == 0) A.y_vv[s] = c;
}

// A block a work item of the ones that the bucket's live count n_vac, read
// on the device, makes, in this order: the gnd and the src dot; the bump's
// groups of kWarps live slots (f32 build); T_vv's groups of kWarps live
// rows; the live row tiles' tiles of T_vm (row tile rt = t / n_ct, column
// tile ct = t % n_ct).  So the live items take the first blocks, all of them
// in the card's first wave, the short latency-bound kinds first, and the
// blocks past the live items leave at once.  A T_vm tile's elements are
// read once for both of its products: the rows' partial sums (a lane's
// columns in order, the warp's butterfly) and the columns' (a warp's rows
// in order, the warps in order) go to slots of their own; then threads 0
// and 32 draw the column tile's and the row tile's tickets side by side
// (csrc/ticket.cuh last_ticket_acq_rel, after the barrier that orders the
// block's slots before them), and the block that draws a strip's last
// ticket adds its slots in sum_strided's order.  Three builds: <float,
// float> the inner direction (mixed), <double, float> the refinement's
// iterate (mixed), <double, double> the f64 solve.
template <typename T, typename S>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm<S>) transport_blocks_kernel(
    BlocksArgs<T, S> A) {
  count_launch(A.count);
  constexpr bool kLo = sizeof(T) == 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nv = min(*A.n_vac, A.vcap);
  const int n_ct = (A.n_mp + kBlockCols - 1) / kBlockCols;
  const int n_live = (nv + kBlockRows - 1) / kBlockRows;
  const int n_grp = (nv + kWarps - 1) / kWarps;
  const int n_bump = kLo ? n_grp : 0;
  const int n_small = 2 + n_bump + n_grp;
  const int it = blockIdx.x;
  __shared__ S s_xv[kBlockRows];
  __shared__ S s_cp[kWarps][kBlockCols];
  __shared__ T s_warp[kWarps];
  __shared__ int s_last[2];
  extern __shared__ __align__(16) unsigned char s_raw[];
  S* s_xall = reinterpret_cast<S*>(s_raw);

  // no live slot: zero column sums
  if (nv == 0)
    for (int c = it * kThreads + threadIdx.x; c < A.n_mp; c += gridDim.x * kThreads)
      A.mv[c] = S(0);
  if (it >= n_small + n_live * n_ct) return;

  if (it >= n_small) {
    // a tile of T_vm: every element, the columns' x_m and the rows' x_v
    // loaded before any is used
    const int tile = it - n_small, rt = tile / n_ct, ct = tile - rt * n_ct;
    const int r0 = rt * kBlockRows, c0 = ct * kBlockCols;
    S t[kRowsPerWarp][kColsPerLane], xm[kColsPerLane];
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int s = r0 + warp * kRowsPerWarp + j;
#pragma unroll
      for (int q = 0; q < kColsPerLane; ++q) {
        const int col = c0 + lane + 32 * q;
        t[j][q] = s < nv && col < A.n_mp ? __ldg(A.T_vm + (size_t)s * A.n_mp + col) : S(0);
      }
    }
#pragma unroll
    for (int q = 0; q < kColsPerLane; ++q) {
      const int col = c0 + lane + 32 * q;
      xm[q] = col < A.n_mp ? __ldg(A.xm + col) : S(0);
    }
    if (threadIdx.x < kBlockRows) {
      const int s = r0 + threadIdx.x;
      s_xv[threadIdx.x] = s < nv ? (S)A.xs[A.vidx[s] + 2] : S(0);
    }
    // each row's partial T_vm x_m over the tile's columns: a lane's columns
    // in order, then the warp's butterfly
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      S a = S(0);
#pragma unroll
      for (int q = 0; q < kColsPerLane; ++q) a = fma_rn(t[j][q], xm[q], a);
      a = warp_sum(a);
      const int s = r0 + warp * kRowsPerWarp + j;
      if (lane == 0 && s < nv) A.row_part[(size_t)ct * A.vcap + s] = a;
    }
    __syncthreads();
    // each column's partial T_vm^T x_v over the tile's rows: a warp's rows
    // in order, then the warps in order
#pragma unroll
    for (int q = 0; q < kColsPerLane; ++q) {
      S a = S(0);
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j)
        a = fma_rn(s_xv[warp * kRowsPerWarp + j], t[j][q], a);
      s_cp[warp][lane + 32 * q] = a;
    }
    __syncthreads();
    const int col = c0 + threadIdx.x;
    if (threadIdx.x < kBlockCols && col < A.n_mp) {
      S a = S(0);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += s_cp[w][threadIdx.x];
      A.col_part[(size_t)rt * A.n_mp + col] = a;
    }
    // the column tile's and the row tile's tickets, drawn side by side by
    // threads 0 and 32 once the block's slots are written
    __syncthreads();
    if (threadIdx.x == 0) s_last[0] = last_ticket_acq_rel(A.tickets, ct, n_live);
    if (threadIdx.x == 32) s_last[1] = last_ticket_acq_rel(A.tickets, n_ct + rt, n_ct);
    __syncthreads();
    // the column tile's last live row tile: its columns' sums over the row
    // tiles, kLanes threads a column (thread q of a column: tiles q, q +
    // kLanes, ... in order), then those in order
    if (s_last[0]) {
      constexpr int kLanes = kThreads / kBlockCols;
      const int c = threadIdx.x % kBlockCols, q = threadIdx.x / kBlockCols;
      const S a = sum_strided<kColSumLoads>(A.col_part + c0 + c, A.n_mp, q, kLanes, n_live,
                                            c0 + c < A.n_mp);
      s_cp[q][c] = a;
      __syncthreads();
      if (threadIdx.x < kBlockCols && col < A.n_mp) {
        S tot = S(0);
#pragma unroll
        for (int l = 0; l < kLanes; ++l) tot += s_cp[l][threadIdx.x];
        A.mv[col] = tot;
      }
    }
    // the row tile's last column tile: its rows' sums over the column tiles,
    // alike, then a butterfly of the row's lanes downwards
    if (s_last[1]) {
      constexpr int kLanes = kThreads / kBlockRows;
      const int j = threadIdx.x / kLanes, q = threadIdx.x % kLanes, s = r0 + j;
      S a = sum_strided<kSumLoads>(A.row_part + s, A.vcap, q, kLanes, n_ct, s < nv);
#pragma unroll
      for (int o = 1; o < kLanes; o <<= 1) a += __shfl_down_sync(0xffffffffu, a, o, kLanes);
      if (q == 0 && s < nv) A.y_vm[s] = a;
    }
    return;
  }

  if (it >= 2 + n_bump) {
    // a warp a slot: T_vv's row against x_v gathered into shared memory
    // (kGather a thread in flight), the row's first loads issued before
    // the gather
    const int s = (it - 2 - n_bump) * kWarps + warp;
    S v0[kVvLoads], v1[kVvLoads];
    if (s < nv) vv_two_passes(A.T_vv + (size_t)s * A.vcap, 0, nv, v0, v1);
    for (int j0 = threadIdx.x; j0 < nv; j0 += kThreads * kGather) {
      int a[kGather];
      S x[kGather];
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        const int j = j0 + kThreads * u;
        a[u] = j < nv ? A.vidx[j] : 0;
      }
#pragma unroll
      for (int u = 0; u < kGather; ++u) x[u] = (S)A.xs[a[u] + 2];
#pragma unroll
      for (int u = 0; u < kGather; ++u)
        if (j0 + kThreads * u < nv) s_xall[j0 + kThreads * u] = x[u];
    }
    __syncthreads();
    if (s < nv) vv_row(A, s, nv, s_xall, v0, v1);
    return;
  }

  if (it >= 2) {
    // lo: a warp a slot, the bump over the slot's neighbours (lane l:
    // slots l, l + 32, ..., their indices, values and entries loaded before
    // any is used)
    const int s = (it - 2) * kWarps + warp;
    if (s >= nv) return;
    const int* nb = A.anb + (size_t)A.vidx[s] * A.max_nn;
    const float* dv = A.dyn + (size_t)s * A.max_nn;
    float d = 0.f;
    for (int k0 = 0; k0 < A.max_nn; k0 += 32 * kBumpLoads) {
      int j[kBumpLoads];
      float w[kBumpLoads], x[kBumpLoads];
#pragma unroll
      for (int u = 0; u < kBumpLoads; ++u) {
        const int k = k0 + lane + 32 * u;
        j[u] = k < A.max_nn ? nb[k] : 0;
        w[u] = k < A.max_nn ? dv[k] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBumpLoads; ++u) x[u] = (float)A.xs[(j[u] < 0 ? 0 : j[u]) + 2];
#pragma unroll
      for (int u = 0; u < kBumpLoads; ++u)
        if (k0 + lane + 32 * u < A.max_nn) d = fma_rn(w[u], x[u], d);
    }
    d = warp_sum(d);
    if (lane == 0) A.y_bump[s] = d;
    return;
  }

  // the virtual nodes' rows: gnd . xa over its nonzero range (atoms past na
  // - num_ground_ext), src . xa over the first nsi atoms; a block each, the
  // threads' terms in order (kDotLoads loads in flight), then the block's
  // sum
  const bool is_gnd = it == 0;
  const int a0 = is_gnd ? A.gnd_lo : 0, a1 = is_gnd ? A.na : A.nsi;
  const T* w = is_gnd ? A.gnd : A.src;
  T acc = 0;
  for (int a = a0 + threadIdx.x; a < a1; a += kThreads * kDotLoads) {
    T wv[kDotLoads], xv[kDotLoads];
#pragma unroll
    for (int u = 0; u < kDotLoads; ++u) {
      const int q = a + kThreads * u;
      wv[u] = q < a1 ? w[q] : T(0);
      xv[u] = q < a1 ? A.xs[q + 2] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kDotLoads; ++u)
      if (a + kThreads * u < a1) acc = fma_rn(wv[u], xv[u], acc);
  }
  const T sum = block_sum(acc, s_warp);
  if (threadIdx.x == 0) A.dots[is_gnd ? 0 : 1] = sum;
}

// ----------------------------------------------------------------------------
// transport_rows (f64)
// ----------------------------------------------------------------------------

template <typename P>
struct RowsArgs {
  // the packed vector [n_full]
  const double* xs;
  // the atom graph as a sliced ELL over the rows of the system (row i, atom
  // i - 2): slices of kSlice rows, a row's valid neighbours in the atom
  // graph's order, slot-major inside a slice (row i's slot k at nb_start[i
  // / kSlice] + k kSlice + i % kSlice, pad -1); each atom's class (bit 0
  // metal, bit 1 neutral vacancy) and the conductances of a pair whose
  // atoms share a class bit (g_hi = -high_G) or not (g_lo = -low_G)
  const int* nb_idx;
  const int* nb_start;
  const unsigned char* cls;
  double g_hi, g_lo;
  // each atom's bucket slot and metal slot (-1: none)
  const int* vslot;
  const int* mp_inv;
  // the metal block's product [n_mp] and transport_blocks': the column sums
  // [n_mp], T_vm x_m and T_vv x_v [vcap] (P: f32 in mixed precision, f64 in
  // f64), the dots [2]
  const P* y_cc;
  const P* mv;
  const P* y_vm;
  const P* y_vv;
  const double* dots;
  // virtual rows, diagonal and the scaling (null: none, the unscaled system)
  const double* gnd;
  const double* src;
  const double* diag;
  const double* dsi;
  double loop_G;
  int na, nsub;
  // the right-hand side, the residual and r.r (transport_rows)
  const double* b;
  double* r;
  double* rsum;
  // scratch: the tiles' partial sums (the f64 tail's: of p.ap), the ticket
  double* part;
  int* ticket;
  unsigned long long* count;
};

// Row i < nsub of y = A xs (ELL part, metal row, vacancy slot, virtual rows,
// diagonal), and xs[i] in xi.  The row's own entries and the products it
// adds are loaded before its slots; the slots in passes of kEll, a pass's
// indices (32 rows' words side by side) loaded before the neighbours'
// entries and classes, those before any is added; each slot's conductance
// from the two atoms' classes.
template <typename P>
__device__ __forceinline__ double row_product(const RowsArgs<P>& A, int i, double& xi) {
  const double x0 = A.xs[0], x1 = A.xs[1];
  xi = A.xs[i];
  const double dg = A.diag[i];
  double y;
  if (i >= 2) {
    const int a = i - 2;
    const int s = A.vslot[a];
    const int k = A.mp_inv[a];
    const double ga = A.gnd[a], sa = A.src[a];
    double tm = 0, tv = 0;
    if (k >= 0) tm = add_rn((double)__ldcg(A.y_cc + k), (double)__ldcg(A.mv + k));
    if (s >= 0) tv = add_rn((double)__ldcg(A.y_vv + s), (double)__ldcg(A.y_vm + s));
    const int c0 = __ldg(A.nb_start + i / kSlice), c1 = __ldg(A.nb_start + i / kSlice + 1);
    const int width = (c1 - c0) / kSlice;
    const int* nb = A.nb_idx + c0 + i % kSlice;
    const unsigned ca = A.cls[a];
    y = 0;
    for (int k0 = 0; k0 < width; k0 += kEll) {
      int j[kEll];
      double w[kEll], xv[kEll];
#pragma unroll
      for (int u = 0; u < kEll; ++u)
        j[u] = k0 + u < width ? __ldg(nb + (k0 + u) * kSlice) : -1;
#pragma unroll
      for (int u = 0; u < kEll; ++u) {
        xv[u] = j[u] >= 0 ? __ldg(A.xs + j[u] + 2) : 0.0;
        w[u] = j[u] >= 0 && (ca & __ldg(A.cls + j[u])) != 0u ? A.g_hi : A.g_lo;
      }
#pragma unroll
      for (int u = 0; u < kEll; ++u)
        if (j[u] >= 0) y = fma_rn(w[u], xv[u], y);
    }
    y = add_rn(y, tm);
    if (s >= 0) y = add_rn(y, tv);
    y = add_rn(y, mul_rn(ga, x0));
    y = add_rn(y, mul_rn(sa, x1));
  } else {
    y = i == 0 ? sub_rn(__ldcg(A.dots + 0), mul_rn(A.loop_G, x1))
               : sub_rn(__ldcg(A.dots + 1), mul_rn(A.loop_G, x0));
  }
  return add_rn(y, mul_rn(dg, xi));
}

// A row a thread, a warp a slice: row_product, r = b - dsi y and the
// tiles' r.r; the block that draws the last ticket adds the tiles' sums in
// tile order and writes r.r.
template <typename P>
__global__ void __launch_bounds__(kThreads) transport_rows_kernel(RowsArgs<P> A) {
  count_launch(A.count);
  __shared__ double s_warp[kWarps];
  __shared__ int s_flag;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  double acc = 0;
  if (i < A.nsub) {
    double xi;
    const double y = row_product(A, i, xi);
    const double rr = sub_rn(A.b[i], A.dsi != nullptr ? mul_rn(A.dsi[i], y) : y);
    A.r[i] = rr;
    acc = fma_rn(rr, rr, acc);
  }
  const double sum = block_sum(acc, s_warp);
  if (threadIdx.x == 0) A.part[blockIdx.x] = sum;

  // the tiles' sums in tile order, by the block that draws the last ticket
  if (!last_ticket(A.ticket, 0, gridDim.x, &s_flag)) return;
  const double total = sum_partials(A.part, gridDim.x, s_warp);
  if (threadIdx.x == 0) A.rsum[0] = total;
}

// ----------------------------------------------------------------------------
// transport_stored: the stored metal block's product
// ----------------------------------------------------------------------------

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
  __device__ static float at(const float4& v, int c) {
    return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
  }
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
  __device__ static double at(const double2& v, int c) { return c == 0 ? v.x : v.y; }
};

// The block's 16-byte loads, past L1 (kPastL1) or through it.
template <bool kPastL1>
__device__ __forceinline__ float4 ld_block(const float4* p) {
  if constexpr (kPastL1) {
    float4 v;
    asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
        : "l"(p));
    return v;
  } else {
    return __ldg(p);
  }
}
template <bool kPastL1>
__device__ __forceinline__ double2 ld_block(const double2* p) {
  if constexpr (kPastL1) {
    double2 v;
    asm("ld.global.nc.L1::no_allocate.v2.f64 {%0, %1}, [%2];" : "=d"(v.x), "=d"(v.y) : "l"(p));
    return v;
  } else {
    return __ldg(p);
  }
}

// y = T_cc x_m, a warp a row of n: lane l takes the row's elements before
// its first 16-byte boundary at l (head; the row starts wherever row * n
// puts it), then the 16-byte vectors l, l + 32, ..., kSmLoads of them
// loaded before any is used, then the tail's element l; each vector's
// elements in order, one fused multiply-add each; then the warp's
// butterfly.  So a row's sum has one fixed order, whatever launch runs it.
// The row's head and tail elements are read (a few words a row) before its
// vectors, the head's product added once the first vectors are on their
// way.
template <typename T, bool kPastL1>
__global__ void __launch_bounds__(kSmThreads, kSmBlocks)
stored_matvec_kernel(const T* __restrict__ tcc, const T* __restrict__ xm, T* __restrict__ y,
                     int n, unsigned long long* count) {
  count_launch(count);
  using V = typename Vec16<T>::type;
  constexpr int kV = Vec16<T>::n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kSmWarps + warp;
  if (row >= n) return;
  const T* rp = tcc + (size_t)row * n;
  const int head = min(n, (int)(((16u - (unsigned)(reinterpret_cast<uintptr_t>(rp) & 15u)) & 15u)
                                / sizeof(T)));
  const int n_vec = (n - head) / kV;
  const int tail0 = head + n_vec * kV;
  T ha = T(0), hx = T(0), ta = T(0), tx = T(0);
  if (lane < head) {
    ha = __ldg(rp + lane);
    hx = __ldg(xm + lane);
  }
  if (lane < n - tail0) {
    ta = __ldg(rp + tail0 + lane);
    tx = __ldg(xm + tail0 + lane);
  }
  const V* rv = reinterpret_cast<const V*>(rp + head);
  const T* xh = xm + head;
  T acc = T(0);
  for (int q0 = lane; q0 < n_vec; q0 += 32 * kSmLoads) {
    V v[kSmLoads];
#pragma unroll
    for (int u = 0; u < kSmLoads; ++u) {
      const int q = q0 + 32 * u;
      if (q < n_vec) v[u] = ld_block<kPastL1>(rv + q);
    }
    if (q0 == lane && lane < head) acc = fma_rn(ha, hx, acc);
#pragma unroll
    for (int u = 0; u < kSmLoads; ++u) {
      const int q = q0 + 32 * u;
      if (q < n_vec) {
#pragma unroll
        for (int c = 0; c < kV; ++c)
          acc = fma_rn(Vec16<T>::at(v[u], c), __ldg(xh + q * kV + c), acc);
      }
    }
  }
  // a lane without vectors adds its head here, still first
  if (lane >= n_vec && lane < head) acc = fma_rn(ha, hx, acc);
  if (lane < n - tail0) acc = fma_rn(ta, tx, acc);
  acc = warp_sum(acc);
  if (lane == 0) y[row] = acc;
}

// ----------------------------------------------------------------------------
// the f64 solve's tail: the update, direction and packing
// ----------------------------------------------------------------------------

// The f64 solve's tail: the product form of the rows (R: the direction p =
// xs, its graph and products; R.part the 256-row halves' partial sums of
// p.ap) and the update.
struct Tail64Args {
  RowsArgs<double> R;
  // the iterate and residual [nsub], the direction p [n_full] (= R.xs; the
  // vector the products read, p[nsub] stays 0) and its product ap, the
  // Jacobi minv = 1 / diag; the metal vector the direction is packed into
  double* x;
  double* r;
  double* p;
  double* ap;
  const double* minv;
  double* xm;
  const int* mp_inv;
  // the entry flag, alpha, beta, r.z, the threshold of the "pre" criterion,
  // the iterations, the predicate, the loop's count, the WHILE node it
  // conditions (0: none)
  unsigned char* act;
  double* alpha;
  double* beta;
  double* rz;
  const double* thresh2;
  long long* iters;
  int* cond;
  unsigned long long* total;
  unsigned long long handle;
  int nsub, per, maxiter;
  // scratch: the tiles' partial sums of r.z; the grid barrier
  double* part;
  unsigned* bar;
  unsigned long long* count;
};

// The sum of `count` partials (written by other blocks: read past L1) in
// every thread of the block, with the same bits in every block: warp 0's
// lane l adds slots l, l + 32, ... in order (kP of them loaded before any is
// added), then a butterfly; the sum reaches the other warps through
// `s_sum`.  Every thread calls it.
__device__ __forceinline__ double block_sum_partials64(const double* part, int count,
                                                       double* s_sum) {
  if (threadIdx.x < 32) {
    constexpr int kP = 8;
    double a = 0;
    for (int t0 = threadIdx.x; t0 < count; t0 += 32 * kP) {
      double v[kP];
#pragma unroll
      for (int k = 0; k < kP; ++k) {
        const int t = t0 + 32 * k;
        v[k] = t < count ? __ldcg(part + t) : 0.0;
      }
#pragma unroll
      for (int k = 0; k < kP; ++k)
        if (t0 + 32 * k < count) a += v[k];
    }
    a = warp_sum(a);
    if (threadIdx.x == 0) *s_sum = a;
  }
  __syncthreads();
  return *s_sum;
}

// x += alpha p, r -= alpha ap, z = minv r of row i (every operand, the
// row's metal slot too, loaded before any is used); r.z in `rz`.
struct Up64Row {
  double pe, zn;
  int m;
};

__device__ __forceinline__ Up64Row up64_row(double* x, double* r, const double* minv,
                                            const int* mp_inv, double pe, double ape,
                                            double alpha, int i, double& rz) {
  const double rv = r[i], xv = x[i], mi = minv[i];
  const int m = i >= 2 ? mp_inv[i - 2] : -1;
  const double rn = fma_rn(-alpha, ape, rv);
  const double zn = mul_rn(mi, rn);
  x[i] = fma_rn(alpha, pe, xv);
  r[i] = rn;
  rz = mul_rn(rn, zn);
  return {pe, zn, m};
}

// The whole f64 tail in one cooperative launch of kUpThreads-row tiles
// (block b: tiles [b per, (b + 1) per), a row a thread, the first tile held
// in registers): the rows of ap = A p (row_product, transport_rows' product
// form) and each 256-row half's partial p.ap (transport_rows' tiles); a
// barrier of the grid; alpha = r.z / p.ap in every block from the halves'
// slots in sum_partials' order (the first kThreads threads as its block);
// x += alpha p, r -= alpha ap, z = minv r (every operand, the row's metal
// slot too, loaded before the barrier) and the tiles' r.z; a barrier; r.z
// and beta in every block from the same slots in the same order (warp 0,
// lane-strided); p = z + beta p and its metal part packed.  ap, p, z and the
// metal slot of the block's first tile stay in registers from the rows to
// the direction (ap is also written, as cg_solve keeps it).  Block 0 writes
// the scalars, the flag (criterion "pre": r.z above the threshold), the
// count and the predicate (also the WHILE node's condition); a stopped CG's
// launch changes nothing else.
__global__ void __launch_bounds__(kUpThreads, 2) transport_tail64_kernel(Tail64Args A) {
  const RowsArgs<double>& R = A.R;
  count_launch(A.count);
  __shared__ double s_warp[kUpWarps];
  __shared__ double s_rz, s_alpha;
  const bool writer = blockIdx.x == 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (A.nsub + kUpThreads - 1) / kUpThreads;
  const int n_half = (A.nsub + kThreads - 1) / kThreads;
  const int first = blockIdx.x * A.per, last = min(first + A.per, n_tiles);
  const bool on = *A.act != 0;
  const double rz_o = *A.rz;
  long long it_w = 0;
  double th_w = 0;
  if (writer && threadIdx.x == 0) {
    it_w = *A.iters;
    th_w = *A.thresh2;
  }
  double alpha = 0, rz_n = 0, beta = 0;
  if (on) {
    // A. the rows of ap = A p and each half's partial p.ap (the half's
    // warps in order)
    double ph = 0, yh = 0;
    for (int t = first; t < last; ++t) {
      const int i = t * kUpThreads + threadIdx.x;
      double acc = 0, pe = 0, y = 0;
      if (i < A.nsub) {
        y = row_product(R, i, pe);
        A.ap[i] = y;
        acc = fma_rn(pe, y, acc);
      }
      if (t == first) {
        ph = pe;
        yh = y;
      }
      acc = warp_sum(acc);
      __syncthreads();
      if (lane == 0) s_warp[warp] = acc;
      __syncthreads();
      if ((threadIdx.x & (kThreads - 1)) == 0) {
        const int h = threadIdx.x / kThreads, q = 2 * t + h;
        double sum = 0;
        for (int w = 0; w < kWarps; ++w) sum += s_warp[h * kWarps + w];
        if (q < n_half) R.part[q] = sum;
      }
    }
    grid_barrier(A.bar);
    // alpha: the halves' slots as sum_partials adds them in a block of
    // kThreads
    if (threadIdx.x < kThreads) {
      constexpr int kP = 4;
      double a = 0;
      for (int q0 = threadIdx.x; q0 < n_half; q0 += kThreads * kP) {
        double v[kP];
#pragma unroll
        for (int k = 0; k < kP; ++k) {
          const int q = q0 + kThreads * k;
          v[k] = q < n_half ? __ldcg(R.part + q) : 0.0;
        }
#pragma unroll
        for (int k = 0; k < kP; ++k)
          if (q0 + kThreads * k < n_half) a += v[k];
      }
      a = warp_sum(a);
      if (lane == 0) s_warp[warp] = a;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      double tot = 0;
      for (int w = 0; w < kWarps; ++w) tot += s_warp[w];
      s_alpha = tot != 0.0 ? rz_o / tot : 0.0;
    }
    __syncthreads();
    alpha = s_alpha;
    // B. the update and each tile's partial r.z
    Up64Row h = {0.0, 0.0, -1};
    for (int t = first; t < last; ++t) {
      const int i = t * kUpThreads + threadIdx.x;
      double acc = 0;
      if (i < A.nsub) {
        const bool reg = t == first;
        const Up64Row w = up64_row(A.x, A.r, A.minv, A.mp_inv, reg ? ph : A.p[i],
                                   reg ? yh : __ldcg(A.ap + i), alpha, i, acc);
        if (reg) h = w;
      }
      const double sum = block_sum<double, kUpWarps>(acc, s_warp);
      if (threadIdx.x == 0) A.part[t] = sum;
    }
    grid_barrier(A.bar);
    // C. beta in every block; the direction packed
    rz_n = block_sum_partials64(A.part, n_tiles, &s_rz);
    beta = rz_o != 0.0 ? rz_n / rz_o : 0.0;
    for (int t = first; t < last; ++t) {
      const int i = t * kUpThreads + threadIdx.x;
      if (i >= A.nsub) continue;
      const bool reg = t == first;
      const double pn = reg ? fma_rn(beta, h.pe, h.zn)
                            : fma_rn(beta, A.p[i], mul_rn(A.minv[i], A.r[i]));
      A.p[i] = pn;
      const int k = reg ? h.m : i >= 2 ? A.mp_inv[i - 2] : -1;
      if (k >= 0) A.xm[k] = pn;
    }
  }
  if (writer && threadIdx.x == 0) {
    if (on) {
      *A.alpha = alpha;
      *A.beta = beta;
      *A.rz = rz_n;
      *A.iters = it_w + 1;
    }
    const bool go_c = on && rz_n > th_w;
    *A.act = go_c;
    const int go = go_c && (on ? it_w + 1 : it_w) < A.maxiter;
    *A.cond = go;
    *A.total += 1;
    if (A.handle) cudaGraphSetConditional(A.handle, go);
  }
}

// ----------------------------------------------------------------------------
// transport_rows_update (f32): the inner iteration's tail
// ----------------------------------------------------------------------------

struct RowsUpdateArgs {
  // the packed direction: the scaled vector [n_full] (the rows read it, the
  // direction writes the next one), the band's zero-padded window (atom a at
  // front + inv[a]) and the metal vector (atom a at mp_inv[a] >= 0)
  float* xs;
  float* xw;
  float* xm;
  int front;
  // the band's product in its permuted layout and the inverse permutation
  // [na]; a bf16 band's row_fix [na] (null: an f32 band); the bump [vcap]
  const float* band_y;
  const int* inv;
  const float* row_fix;
  const float* y_bump;
  // each atom's bucket slot and metal slot (-1: none)
  const int* vslot;
  const int* mp_inv;
  // the fly kernel's product [n_mp] and transport_blocks': the column sums
  // [n_mp], T_vm x_m and T_vv x_v [vcap], the dots [2]
  const float* y_cc;
  const float* mv;
  const float* y_vm;
  const float* y_vv;
  const float* dots;
  // virtual rows, diagonal and scaling
  const float* gnd;
  const float* src;
  const float* diag;
  const float* dsi;
  double loop_G;
  int nsub, per, maxiter;
  // the inner CG (boundary_cg's workspace at B = 1): iterate, residual,
  // direction, its product, the flags, the scalars, the counts, the
  // predicate and the WHILE node it conditions (0: none)
  float* x;
  float* r;
  float* p;
  float* ap;
  unsigned char* act;
  const unsigned char* act0;
  float* alpha;
  float* beta;
  float* rz;
  float* rr;
  const float* thresh2;
  long long* iters;
  int* ctl;
  int* cond;
  unsigned long long* total;
  unsigned long long handle;
  // scratch: the tiles' partial sums of p.ap [n_tiles] and then, from the
  // next multiple of 4, of r.r [n_tiles]; the grid barrier
  float* part;
  unsigned* bar;
  unsigned long long* count;
};

// Row i of ap = A p from the packed direction (transport_rows' f32 rows
// before they were fused, each rounding spelled out), in two levels of
// loads so that a thread's rows start every load of a level before any is
// used: ru_load1 the row's own entries and slots, ru_load2 what the slots
// point at (slot 0 where the row has none: loaded, not used), ru_value the
// arithmetic.
struct RuRow {
  float xi, pe, d, dg, g, sr, rf;
  int a_inv, s, m;
  float by, bump, vv, vm, ycc, mvv;
};

__device__ __forceinline__ void ru_load1(const RowsUpdateArgs& A, int i, RuRow& w) {
  w.xi = A.xs[i];
  w.pe = A.p[i];
  w.d = A.dsi[i];
  w.dg = A.diag[i];
  w.a_inv = w.s = w.m = -1;
  w.g = w.sr = w.rf = 0.f;
  if (i >= 2) {
    const int a = i - 2;
    w.a_inv = A.inv[a];
    w.s = A.vslot[a];
    w.m = A.mp_inv[a];
    w.g = A.gnd[a];
    w.sr = A.src[a];
    if (A.row_fix != nullptr) w.rf = A.row_fix[a];
  }
}

__device__ __forceinline__ void ru_load2(const RowsUpdateArgs& A, int i, RuRow& w) {
  if (i < 2) return;
  const int s = max(w.s, 0), m = max(w.m, 0);
  w.by = __ldcg(A.band_y + w.a_inv);
  w.bump = __ldcg(A.y_bump + s);
  w.vv = __ldcg(A.y_vv + s);
  w.vm = __ldcg(A.y_vm + s);
  w.ycc = A.y_cc[m];
  w.mvv = __ldcg(A.mv + m);
}

__device__ __forceinline__ float ru_value(const RowsUpdateArgs& A, int i, const RuRow& w,
                                          float x0, float x1) {
  float y;
  if (i >= 2) {
    y = w.by;
    // a bf16 band's rounding of the row, put back on the diagonal as
    // physics/current.py _band_unpermute adds it: y + row_fix x
    if (A.row_fix != nullptr) y = add_rn(y, mul_rn(w.rf, w.xi));
    if (w.s >= 0) y = add_rn(y, w.bump);
    float tm = 0.f;
    if (w.m >= 0) tm = add_rn(w.ycc, w.mvv);
    y = add_rn(y, tm);
    if (w.s >= 0) y = add_rn(y, add_rn(w.vv, w.vm));
    y = add_rn(y, mul_rn(w.g, x0));
    y = add_rn(y, mul_rn(w.sr, x1));
  } else {
    const float lg = (float)A.loop_G;
    y = i == 0 ? sub_rn(__ldcg(A.dots + 0), mul_rn(lg, x1))
               : sub_rn(__ldcg(A.dots + 1), mul_rn(lg, x0));
  }
  return mul_rn(w.d, add_rn(y, mul_rn(w.dg, w.xi)));
}

// One inner iteration's tail after the products, in three phases between
// two barriers of the grid; the block's tiles t in [first, last), row i =
// t kRuTile + k kRuThreads + threadIdx.x, the first tile's rows held in
// registers from A to C.  Block 0 reads its scalars before the barriers and
// writes every scalar, flag, count and the predicate after the last.
__global__ void __launch_bounds__(kRuThreads) transport_rows_update_kernel(RowsUpdateArgs A) {
  count_launch(A.count);
  __shared__ float s_warp[kRuWarps];
  __shared__ float s_alpha, s_beta;
  const bool writer = blockIdx.x == 0;
  const int n_tiles = (A.nsub + kRuTile - 1) / kRuTile;
  // the r.r slots after the p.ap slots, 16-byte aligned
  float* part_rr = A.part + ((n_tiles + 3) & ~3);
  const int first = blockIdx.x * A.per, last = min(first + A.per, n_tiles);
  // the entry flag and the scalars no block writes before the last barrier
  const bool on = *A.act != 0;
  const float rz_o = *A.rz;
  long long it_w = 0;
  float rr_w = 0.f, th_w = 0.f;
  bool a0_w = false;
  int ctl_0 = 0;
  if (writer && threadIdx.x == 0) {
    it_w = *A.iters;
    rr_w = *A.rr;
    th_w = *A.thresh2;
    a0_w = *A.act0 != 0;
    ctl_0 = A.ctl[0];
  }
  float alpha = 0.f, beta = 0.f, rz_n = 0.f;
  if (on) {
    float ph[kRuRows], vh[kRuRows], dh[kRuRows], zh[kRuRows];
    int ih[kRuRows], mh[kRuRows];
    const float x0 = A.xs[0], x1 = A.xs[1];

    // A. the rows of ap = A p and each tile's partial p.ap (a thread's rows
    // in order, the warp's butterfly, the warps in order)
    for (int t = first; t < last; ++t) {
      RuRow w[kRuRows];
#pragma unroll
      for (int k = 0; k < kRuRows; ++k) {
        const int i = t * kRuTile + k * kRuThreads + threadIdx.x;
        if (i < A.nsub) ru_load1(A, i, w[k]);
      }
#pragma unroll
      for (int k = 0; k < kRuRows; ++k) {
        const int i = t * kRuTile + k * kRuThreads + threadIdx.x;
        if (i < A.nsub) ru_load2(A, i, w[k]);
      }
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kRuRows; ++k) {
        const int i = t * kRuTile + k * kRuThreads + threadIdx.x;
        if (i < A.nsub) {
          const float v = ru_value(A, i, w[k], x0, x1);
          A.ap[i] = v;
          acc = fma_rn(w[k].pe, v, acc);
          if (t == first) {
            ph[k] = w[k].pe;
            vh[k] = v;
            dh[k] = w[k].d;
            ih[k] = w[k].a_inv;
            mh[k] = w[k].m;
          }
        }
      }
      const float sum = block_sum<float, kRuWarps>(acc, s_warp);
      if (threadIdx.x == 0) A.part[t] = sum;
    }
    grid_barrier(A.bar);

    // B. alpha in every block; the update of the block's rows and each
    // tile's partial r.r (z = r: r.z is r.r bit for bit)
    const float pap = block_sum_partials(A.part, n_tiles, &s_alpha);
    alpha = pap != 0.f ? rz_o / pap : 0.f;
    for (int t = first; t < last; ++t) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kRuRows; ++k) {
        const int i = t * kRuTile + k * kRuThreads + threadIdx.x;
        if (i < A.nsub) {
          const bool reg = t == first;
          const float pe = reg ? ph[k] : A.p[i];
          const float ve = reg ? vh[k] : A.ap[i];
          const float rn = fma_rn(-alpha, ve, A.r[i]);
          A.x[i] = fma_rn(alpha, pe, A.x[i]);
          A.r[i] = rn;
          acc = fma_rn(rn, rn, acc);
          if (reg) zh[k] = rn;
        }
      }
      const float sum = block_sum<float, kRuWarps>(acc, s_warp);
      if (threadIdx.x == 0) part_rr[t] = sum;
    }
    grid_barrier(A.bar);

    // C. beta in every block; the direction p = z + beta p of the block's
    // rows, packed: xs = dsi p, the band's window, the metal vector
    rz_n = block_sum_partials(part_rr, n_tiles, &s_beta);
    beta = rz_o != 0.f ? rz_n / rz_o : 0.f;
    for (int t = first; t < last; ++t) {
#pragma unroll
      for (int k = 0; k < kRuRows; ++k) {
        const int i = t * kRuTile + k * kRuThreads + threadIdx.x;
        if (i < A.nsub) {
          const bool reg = t == first;
          const float pn = reg ? fma_rn(beta, ph[k], zh[k]) : fma_rn(beta, A.p[i], A.r[i]);
          A.p[i] = pn;
          const float v = mul_rn(reg ? dh[k] : A.dsi[i], pn);
          A.xs[i] = v;
          if (i >= 2) {
            const int a_inv = reg ? ih[k] : A.inv[i - 2];
            const int a_mp = reg ? mh[k] : A.mp_inv[i - 2];
            A.xw[A.front + a_inv] = v;
            if (a_mp >= 0) A.xm[a_mp] = v;
          }
        }
      }
    }
  }

  // block 0: the scalars, the flag (a stopped iterate's from its r.r as it
  // is), the iterations run and the predicate
  if (writer && threadIdx.x == 0) {
    const float rr_c = on ? rz_n : rr_w;
    if (on) {
      *A.alpha = alpha;
      *A.beta = beta;
      *A.rz = rz_n;
      *A.rr = rz_n;
      *A.iters = it_w + 1;
    }
    const bool go_c = a0_w && rr_c > th_w;
    *A.act = go_c;
    const int it = ctl_0 + 1;
    A.ctl[0] = it;
    A.ctl[1] = go_c;
    const int go = go_c && it < A.maxiter;
    *A.cond = go;
    *A.total += 1;
    A.xs[A.nsub] = 0.f;
    if (A.handle) cudaGraphSetConditional(A.handle, go);
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
  // the direction packed as the inner product reads it: the f32 scaling,
  // the scaled vector [n_full], the band's window through the inverse
  // permutation (front: its leading zeros) and the metal vector
  const float* dsi;
  float* xs;
  float* xw;
  float* xm;
  const int* inv;
  const int* mp_inv;
  int front;
  // scratch: the tiles' partial sums of b_in . b_in and their ticket
  float* part;
  int* ticket;
  double inner_tol;
  int first, max_outer, maxiter, nsub;
  unsigned long long handle;
  unsigned long long* count;
};

// A block a tile of kTile rows.  Every thread first issues the loads of its
// rows (r, dsi, the window and metal slots), then reads the scalars, so the
// two rounds of latency overlap; warp 1's lane 0 also works out what the
// epilogue needs of them alone (the rounds, the predicate, the round's
// tolerance: the divide off the tail).  b_in and its packed value stay in
// registers while the block sums the tile's b_in . b_in; thread 0 writes the
// tile's slot and draws a ticket (last_ticket_acq_rel: one atomic that
// releases the slot and acquires the others'), and only then do the rows'
// stores go out, so no fence waits for them.  The block that drew the last ticket adds the slots
// in warp 0, in sum_partials' order over the whole block (so b_in . b_in has
// the bits the block-wide sum gives), and writes the scalars; the other
// blocks leave after their stores.
__global__ void __launch_bounds__(kThreads) transport_refine_kernel(RefineArgs A) {
  count_launch(A.count);
  __shared__ float s_warp[kWarps];
  __shared__ int s_flag, s_go;
  __shared__ float s_tol;
  __shared__ long long s_it[2];
  const int i0 = blockIdx.x * kTile + threadIdx.x;
  double rv[kRows];
  float dv[kRows];
  int wv[kRows], mv[kRows];
#pragma unroll
  for (int kk = 0; kk < kRows; ++kk) {
    const int i = i0 + kk * kThreads;
    const bool in = i < A.nsub, atom = in && i >= 2;
    rv[kk] = in ? __ldg(A.r + i) : 0.0;
    dv[kk] = in ? __ldg(A.dsi + i) : 0.f;
    wv[kk] = atom ? __ldg(A.inv + i - 2) : -1;
    mv[kk] = atom ? __ldg(A.mp_inv + i - 2) : -1;
  }
  // ||r|| and the scale in every thread; the rest of the scalars in warp
  // 1's lane 0, into shared memory for the last block's thread 0 (off the
  // path of thread 0, which sums the block and draws its ticket)
  const double rn = sqrt(*A.rsum);
  const double scale = rn > 0 ? rn : 1.0;
  if (threadIdx.x == 32) {
    long long it_out = *A.it_out, it_in = *A.it_in;
    if (!A.first) {
      it_out += 1;
      it_in += *A.iters;
    }
    const double th = *A.thresh;
    s_go = *A.go != 0 && rn > th && it_out < A.max_outer && it_in < A.maxiter;
    // the round's tolerance: a tenth of the reduction this round needs, no
    // tighter than inner_tol and no looser than 0.05, rounded to f32
    const double needed = __ddiv_rn(th, fmax(rn, 1e-300));
    s_tol = __double2float_rn(fmin(fmax(__dmul_rn(0.1, needed), A.inner_tol), 0.05));
    s_it[0] = it_out;
    s_it[1] = it_in;
  }

  // the inner CG's start: b_in = f32(r / scale), its packed value and the
  // tile's partial sum of b_in . b_in
  float bv[kRows], vv[kRows];
  float acc = 0.f;
#pragma unroll
  for (int kk = 0; kk < kRows; ++kk) {
    bv[kk] = __double2float_rn(__ddiv_rn(rv[kk], scale));
    vv[kk] = mul_rn(dv[kk], bv[kk]);
    if (i0 + kk * kThreads < A.nsub) acc = fma_rn(bv[kk], bv[kk], acc);
  }
  const float sum = block_sum(acc, s_warp);
  if (threadIdx.x == 0) {
    A.part[blockIdx.x] = sum;
    s_flag = last_ticket_acq_rel(A.ticket, 0, gridDim.x);
  }
  // x = 0, r = p = b_in, p packed
#pragma unroll
  for (int kk = 0; kk < kRows; ++kk) {
    const int i = i0 + kk * kThreads;
    if (i >= A.nsub) continue;
    A.x[i] = 0.f;
    A.rr_in[i] = bv[kk];
    A.p[i] = bv[kk];
    A.xs[i] = vv[kk];
    if (wv[kk] >= 0) A.xw[A.front + wv[kk]] = vv[kk];
    if (mv[kk] >= 0) A.xm[mv[kk]] = vv[kk];
  }
  __syncthreads();
  if (!s_flag || threadIdx.x >= 32) return;
  // the slots' sum in sum_partials' order: lane l takes the kWarps
  // "threads" l, l + 32, ..., each adding its slots t, t + kThreads, ... in
  // order; a butterfly each; then the kWarps sums in order, in lane 0
  float w[kWarps];
#pragma unroll
  for (int q = 0; q < kWarps; ++q) w[q] = 0.f;
  for (int base = 0; base < (int)gridDim.x; base += kThreads) {
    float v[kWarps];
#pragma unroll
    for (int q = 0; q < kWarps; ++q) {
      const int t = base + 32 * q + threadIdx.x;
      v[q] = t < (int)gridDim.x ? __ldcg(A.part + t) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kWarps; ++q) w[q] += v[q];
  }
#pragma unroll
  for (int q = 0; q < kWarps; ++q) w[q] = warp_sum(w[q]);
  if (threadIdx.x != 0) return;
  float rz = 0.f;
#pragma unroll
  for (int q = 0; q < kWarps; ++q) rz += w[q];
  const bool go = s_go != 0;
  const float tol = s_tol;
  const long long it_out = s_it[0], it_in = s_it[1];
  const float ref = sqrtf(rz);
  const float th = __fmul_rn(tol, ref > 0.f ? ref : 1.f);
  const float th2 = __fmul_rn(th, th);
  const bool act = go && rz > th2;
  A.xs[A.nsub] = 0.f;
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

// Blocks of a cooperative kernel of `threads` threads that the current card
// holds at once.
template <typename K>
int resident_blocks(K kernel, int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess
      || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0)
             != cudaSuccess)
    return 0;
  return per_sm * sms;
}

template <typename K, typename Args>
int launch_cooperative(K kernel, int want, int threads, const Args& args, cudaStream_t st) {
  const int cap = resident_blocks(kernel, threads);
  if (cap <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(max(1, min(want, cap)));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// One launch of stored_matvec_kernel<T, past L1>: a block of at most
// kSmPastL1L2s of the card's L2s (its size asked at each launch) loads past
// L1, a larger one through it.
template <typename T>
int launch_stored(const void* tcc, const void* xm, void* y, int n, void* count,
                  cudaStream_t st) {
  int dev = 0, l2 = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
  if (e != cudaSuccess) return (int)e;
  const int grid = (n + kSmWarps - 1) / kSmWarps;
  auto kernel = (double)n * n * sizeof(T) <= (double)kSmPastL1L2s * l2
                    ? stored_matvec_kernel<T, true>
                    : stored_matvec_kernel<T, false>;
  kernel<<<grid, kSmThreads, 0, st>>>(static_cast<const T*>(tcc), static_cast<const T*>(xm),
                                      static_cast<T*>(y), n,
                                      static_cast<unsigned long long*>(count));
  return (int)cudaGetLastError();
}

}  // namespace

// Every function launches one kernel on `stream` and returns its cudaError_t
// (0 on success).  is_f64: the f64 (refinement) build, else the f32 (inner)
// one.

// x (f64, updated by xi * scale unless first) -> xs (f64), xm.
extern "C" int dkmc_transport_pack(const void* dsi, void* x, const void* xi, const void* scale,
                                   int first, const void* mp_inv, int nsub, void* xs, void* xm,
                                   void* count, void* stream) {
  if (nsub < 2) return (int)cudaErrorInvalidValue;
  const int n_full = nsub + 1;
  transport_pack_kernel<<<(n_full + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(dsi), static_cast<double*>(x), static_cast<const float*>(xi),
      static_cast<const double*>(scale), first, static_cast<const int*>(mp_inv), nsub, n_full,
      static_cast<double*>(xs), static_cast<float*>(xm),
      static_cast<unsigned long long*>(count));
  return (int)cudaGetLastError();
}

// mode 0: the inner direction (f32 vector, f32 blocks, the bump); 1: the
// refinement's iterate (f64 vector, f32 blocks); 2: the f64 solve (f64
// vector and blocks).
extern "C" int dkmc_transport_blocks(
    int mode, const void* xs, const void* xm, const void* T_vm, const void* T_vv,
    const void* vidx, const void* n_vac, const void* dyn, const void* anb, const void* gnd,
    const void* src, int gnd_lo, int nsi, int na, int max_nn, int vcap, int n_mp, void* mv,
    void* y_vm, void* y_vv, void* y_bump, void* dots, void* col_part, void* row_part,
    void* tickets, void* count, void* stream) {
  if (na < 1 || max_nn < 1 || vcap < 1 || n_mp < 1 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const int n_ct = (n_mp + kBlockCols - 1) / kBlockCols;
  const int n_rt = (vcap + kBlockRows - 1) / kBlockRows;
  // a block an item of a full bucket
  const int grid = n_rt * n_ct + 2 * ((vcap + kWarps - 1) / kWarps) + 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto A) -> cudaError_t {
    using T = typename std::remove_const<
        typename std::remove_pointer<decltype(A.gnd)>::type>::type;
    using S = typename std::remove_pointer<decltype(A.mv)>::type;
    A.xs = static_cast<const T*>(xs);
    A.xm = static_cast<const S*>(xm);
    A.T_vm = static_cast<const S*>(T_vm);
    A.T_vv = static_cast<const S*>(T_vv);
    A.vidx = static_cast<const int*>(vidx);
    A.n_vac = static_cast<const int*>(n_vac);
    A.dyn = static_cast<const float*>(dyn);
    A.anb = static_cast<const int*>(anb);
    A.gnd = static_cast<const T*>(gnd);
    A.src = static_cast<const T*>(src);
    A.gnd_lo = gnd_lo;
    A.nsi = nsi;
    A.na = na;
    A.max_nn = max_nn;
    A.vcap = vcap;
    A.n_mp = n_mp;
    A.mv = static_cast<S*>(mv);
    A.y_vm = static_cast<S*>(y_vm);
    A.y_vv = static_cast<S*>(y_vv);
    A.y_bump = static_cast<float*>(y_bump);
    A.dots = static_cast<T*>(dots);
    A.col_part = static_cast<S*>(col_part);
    A.row_part = static_cast<S*>(row_part);
    A.tickets = static_cast<int*>(tickets);
    A.count = static_cast<unsigned long long*>(count);
    transport_blocks_kernel<T, S><<<grid, kThreads, (size_t)vcap * sizeof(S), st>>>(A);
    return cudaGetLastError();
  };
  if (mode == 0) return (int)launch(BlocksArgs<float, float>{});
  if (mode == 1) return (int)launch(BlocksArgs<double, float>{});
  return (int)launch(BlocksArgs<double, double>{});
}

// The rows of A xs (f64): the residual r = b - dsi A xs (dsi null: the
// unscaled system) and r.r.  parts_f64: the metal block's and
// transport_blocks' products are f64 (the f64 solve), else f32.  The atom
// graph's slices nb_idx / nb_start (ops/transport_cg.py atom_slices); the
// conductances from the atoms' classes cls and g_hi / g_lo.
extern "C" int dkmc_transport_rows(int parts_f64, const void* xs, const void* nb_idx,
                                   const void* nb_start, const void* cls, double g_hi,
                                   double g_lo, const void* vslot,
                                   const void* mp_inv, const void* y_cc, const void* mv,
                                   const void* y_vm, const void* y_vv, const void* dots,
                                   const void* gnd, const void* src, const void* diag,
                                   const void* dsi, double loop_G, int na, const void* b,
                                   void* r, void* rsum, void* part, void* ticket, void* count,
                                   void* stream) {
  if (na < 1 || b == nullptr) return (int)cudaErrorInvalidValue;
  auto launch = [&](auto A) {
    using P = typename std::remove_const<
        typename std::remove_pointer<decltype(A.y_cc)>::type>::type;
    A.xs = static_cast<const double*>(xs);
    A.nb_idx = static_cast<const int*>(nb_idx);
    A.nb_start = static_cast<const int*>(nb_start);
    A.cls = static_cast<const unsigned char*>(cls);
    A.g_hi = g_hi;
    A.g_lo = g_lo;
    A.vslot = static_cast<const int*>(vslot);
    A.mp_inv = static_cast<const int*>(mp_inv);
    A.y_cc = static_cast<const P*>(y_cc);
    A.mv = static_cast<const P*>(mv);
    A.y_vm = static_cast<const P*>(y_vm);
    A.y_vv = static_cast<const P*>(y_vv);
    A.dots = static_cast<const double*>(dots);
    A.gnd = static_cast<const double*>(gnd);
    A.src = static_cast<const double*>(src);
    A.diag = static_cast<const double*>(diag);
    A.dsi = static_cast<const double*>(dsi);
    A.loop_G = loop_G;
    A.na = na;
    A.nsub = na + 1;
    A.b = static_cast<const double*>(b);
    A.r = static_cast<double*>(r);
    A.rsum = static_cast<double*>(rsum);
    A.part = static_cast<double*>(part);
    A.ticket = static_cast<int*>(ticket);
    A.count = static_cast<unsigned long long*>(count);
    transport_rows_kernel<P><<<(A.nsub + kThreads - 1) / kThreads, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(A);
  };
  if (parts_f64)
    launch(RowsArgs<double>{});
  else
    launch(RowsArgs<float>{});
  return (int)cudaGetLastError();
}

// The stored metal block's product y = T_cc xm (n x n, row-major; f32 or
// f64 storage and sums).
extern "C" int dkmc_transport_stored(int is_f64, const void* tcc, const void* xm, void* y,
                                     int n, void* count, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64) return launch_stored<double>(tcc, xm, y, n, count, st);
  return launch_stored<float>(tcc, xm, y, n, count, st);
}

// The f64 solve's tail (one cooperative launch): the rows of ap = A p of
// the direction p = xs, alpha, the update, direction and packing, also the
// condition of the WHILE node `handle` (0: none).  part_pap holds ceil(nsub
// / 256) doubles, part ceil(nsub / 512).
extern "C" int dkmc_transport_tail64(
    void* xs, const void* nb_idx, const void* nb_start, const void* cls, double g_hi,
    double g_lo, const void* vslot, const void* mp_inv, const void* y_cc, const void* mv,
    const void* y_vm, const void* y_vv, const void* dots, const void* gnd, const void* src,
    const void* diag, double loop_G, int na, void* ap, void* part_pap, void* x, void* r,
    const void* minv, void* xm, void* act, void* alpha, void* beta, void* rz,
    const void* thresh2, void* iters, void* cond, void* total, unsigned long long handle,
    int maxiter, void* part, void* bar, void* count, void* stream) {
  if (na < 1) return (int)cudaErrorInvalidValue;
  Tail64Args A = {};
  RowsArgs<double>& R = A.R;
  R.xs = static_cast<const double*>(xs);
  R.nb_idx = static_cast<const int*>(nb_idx);
  R.nb_start = static_cast<const int*>(nb_start);
  R.cls = static_cast<const unsigned char*>(cls);
  R.g_hi = g_hi;
  R.g_lo = g_lo;
  R.vslot = static_cast<const int*>(vslot);
  R.mp_inv = static_cast<const int*>(mp_inv);
  R.y_cc = static_cast<const double*>(y_cc);
  R.mv = static_cast<const double*>(mv);
  R.y_vm = static_cast<const double*>(y_vm);
  R.y_vv = static_cast<const double*>(y_vv);
  R.dots = static_cast<const double*>(dots);
  R.gnd = static_cast<const double*>(gnd);
  R.src = static_cast<const double*>(src);
  R.diag = static_cast<const double*>(diag);
  R.loop_G = loop_G;
  R.na = na;
  R.nsub = na + 1;
  R.part = static_cast<double*>(part_pap);
  A.x = static_cast<double*>(x);
  A.r = static_cast<double*>(r);
  A.p = static_cast<double*>(xs);
  A.ap = static_cast<double*>(ap);
  A.minv = static_cast<const double*>(minv);
  A.xm = static_cast<double*>(xm);
  A.mp_inv = static_cast<const int*>(mp_inv);
  A.act = static_cast<unsigned char*>(act);
  A.alpha = static_cast<double*>(alpha);
  A.beta = static_cast<double*>(beta);
  A.rz = static_cast<double*>(rz);
  A.thresh2 = static_cast<const double*>(thresh2);
  A.iters = static_cast<long long*>(iters);
  A.cond = static_cast<int*>(cond);
  A.total = static_cast<unsigned long long*>(total);
  A.handle = handle;
  A.nsub = na + 1;
  A.maxiter = maxiter;
  A.part = static_cast<double*>(part);
  A.bar = static_cast<unsigned*>(bar);
  A.count = static_cast<unsigned long long*>(count);
  // as few tiles a block as the blocks the card holds allow, and no block
  // without one
  const int n_tiles = (A.nsub + kUpThreads - 1) / kUpThreads;
  const int cap = resident_blocks(transport_tail64_kernel, kUpThreads);
  if (cap <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  A.per = (n_tiles + cap - 1) / cap;
  return launch_cooperative(transport_tail64_kernel, (n_tiles + A.per - 1) / A.per, kUpThreads,
                            A, static_cast<cudaStream_t>(stream));
}

// The inner iteration's tail (f32): the rows of ap = A p from the products
// of the packed direction xs, then the update, the direction and its
// packing, the flags, counts and predicate (also the condition of the WHILE
// node `handle`, 0: none); one cooperative launch.  `part` holds 2
// ceil(nsub / 128) + 4 floats, 16-byte aligned.
extern "C" int dkmc_transport_rows_update(
    const void* band_y, const void* inv, const void* row_fix, const void* y_bump,
    const void* vslot, const void* mp_inv, const void* y_cc, const void* mv, const void* y_vm,
    const void* y_vv, const void* dots, const void* gnd, const void* src, const void* diag,
    const void* dsi, double loop_G, int na, void* x, void* r, void* p, void* ap, void* act,
    const void* act0, void* alpha, void* beta, void* rz, void* rr, const void* thresh2,
    void* iters, void* ctl, void* cond, void* total, unsigned long long handle, int maxiter,
    void* xs, void* xw, void* xm, int front, void* part, void* bar, void* count,
    void* stream) {
  if (na < 1) return (int)cudaErrorInvalidValue;
  RowsUpdateArgs A;
  A.xs = static_cast<float*>(xs);
  A.xw = static_cast<float*>(xw);
  A.xm = static_cast<float*>(xm);
  A.front = front;
  A.band_y = static_cast<const float*>(band_y);
  A.inv = static_cast<const int*>(inv);
  A.row_fix = static_cast<const float*>(row_fix);
  A.y_bump = static_cast<const float*>(y_bump);
  A.vslot = static_cast<const int*>(vslot);
  A.mp_inv = static_cast<const int*>(mp_inv);
  A.y_cc = static_cast<const float*>(y_cc);
  A.mv = static_cast<const float*>(mv);
  A.y_vm = static_cast<const float*>(y_vm);
  A.y_vv = static_cast<const float*>(y_vv);
  A.dots = static_cast<const float*>(dots);
  A.gnd = static_cast<const float*>(gnd);
  A.src = static_cast<const float*>(src);
  A.diag = static_cast<const float*>(diag);
  A.dsi = static_cast<const float*>(dsi);
  A.loop_G = loop_G;
  A.nsub = na + 1;
  A.maxiter = maxiter;
  A.x = static_cast<float*>(x);
  A.r = static_cast<float*>(r);
  A.p = static_cast<float*>(p);
  A.ap = static_cast<float*>(ap);
  A.act = static_cast<unsigned char*>(act);
  A.act0 = static_cast<const unsigned char*>(act0);
  A.alpha = static_cast<float*>(alpha);
  A.beta = static_cast<float*>(beta);
  A.rz = static_cast<float*>(rz);
  A.rr = static_cast<float*>(rr);
  A.thresh2 = static_cast<const float*>(thresh2);
  A.iters = static_cast<long long*>(iters);
  A.ctl = static_cast<int*>(ctl);
  A.cond = static_cast<int*>(cond);
  A.total = static_cast<unsigned long long*>(total);
  A.handle = handle;
  A.part = static_cast<float*>(part);
  A.bar = static_cast<unsigned*>(bar);
  A.count = static_cast<unsigned long long*>(count);
  // as few tiles a block as the blocks the card holds allow, and no block
  // without one
  const int n_tiles = (A.nsub + kRuTile - 1) / kRuTile;
  const int cap = resident_blocks(transport_rows_update_kernel, kRuThreads);
  if (cap <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  A.per = (n_tiles + cap - 1) / cap;
  return launch_cooperative(transport_rows_update_kernel, (n_tiles + A.per - 1) / A.per,
                            kRuThreads, A, static_cast<cudaStream_t>(stream));
}

extern "C" int dkmc_transport_refine(
    const void* r, const void* rsum, const void* thresh, const void* go, void* it_out,
    void* it_in, void* rnorm, void* scale, void* rnorm0, void* cond_out, void* x, void* rr_in,
    void* p, void* rz, void* rr, void* thresh2, void* act0, void* act, void* iters, void* ctl,
    void* cond_in, const void* dsi, void* xs, void* xw, void* xm, const void* inv,
    const void* mp_inv, int front, void* part, void* ticket, double inner_tol, int first,
    int max_outer, int maxiter, int nsub, unsigned long long handle, void* count,
    void* stream) {
  if (nsub < 2) return (int)cudaErrorInvalidValue;
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
  A.dsi = static_cast<const float*>(dsi);
  A.xs = static_cast<float*>(xs);
  A.xw = static_cast<float*>(xw);
  A.xm = static_cast<float*>(xm);
  A.inv = static_cast<const int*>(inv);
  A.mp_inv = static_cast<const int*>(mp_inv);
  A.front = front;
  A.part = static_cast<float*>(part);
  A.ticket = static_cast<int*>(ticket);
  A.inner_tol = inner_tol;
  A.first = first;
  A.max_outer = max_outer;
  A.maxiter = maxiter;
  A.nsub = nsub;
  A.handle = handle;
  A.count = static_cast<unsigned long long*>(count);
  transport_refine_kernel<<<(nsub + kTile - 1) / kTile, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(A);
  return (int)cudaGetLastError();
}
