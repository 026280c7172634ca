// The residence-time KMC event loop of one superstep in one launch, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the device loop of the JAX package: the lax.while_loop of
// devicekmc_tpu/physics/events.py:609 (execute_superstep_incremental, body
// :503-603).  It is not a Pallas kernel; the port ran it as a host loop that
// read ten scalars back per event.  Per event, line for line with that body:
//
//   key, k_sel, k_time = split(key, 3); u = uniform_f64(k_sel)
//   hierarchical selection over the f64 sums: blocks of kBlock rows, then
//     the rows of the block, then the slots of the row, each level
//     searchsorted(cum, target, right) clamped to its last index;
//   valid = psum > 0 and prob[r, s] > 0, else event_time = inf and stop;
//   the two-site event of (element[i], element[j]) (generation, recombination,
//     vacancy or ion diffusion);
//   conflict zeroing: the reverse slot of i and of j in every active
//     neighbouring row, invalid or fill slots redirected into row r, rows r
//     and rj_row wiped (every write is a zero, so their order is free);
//   the touched row sums recomputed from the zeroed table (never by
//     subtraction: removing an exp(+70) rate leaves noise larger than the
//     rates that survive), then the touched block sums from the row sums;
//   event_time = -log(u_t) in the table's type, cast to the working type,
//     divided by psum; stop when event_time >= t_window or count reaches
//     max_events.
//
// Bound on this card: not bytes.  An event touches 2m+2 rows of m entries
// (some 40 KB at max_nn 51), but every event depends on the one before it,
// so the loop is a chain of dependent steps: the key split, three searches,
// the zeroing, the sums, each behind a barrier.  Design: ONE persistent block
// of kThreads threads runs every event, with __syncthreads between the
// phases: no grid-wide sync, no host.  The block sums live in shared memory;
// the table and the row sums stay in device memory (L2-resident at the
// crossbar's 22 MB).  Warp 0 draws the random numbers (three lanes split the
// key at once) and walks the three levels of the selection; each level is a
// warp scan whose lanes own consecutive runs of the level, added lane after
// lane, so the cumulative sums are monotone and the last one is the total.
// All threads zero the conflicts; one thread a touched row recomputes its
// sum; one warp a touched block recomputes the block's sum.  Every sum has a
// fixed order, so a launch repeats bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch_count.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBlock = 128;  // rows a block of the sum hierarchy (events.py _BLOCK)
constexpr unsigned kFull = 0xffffffffu;

// element codes (structure.Element)
constexpr int kD = 0, kOD = 1, kV = 2, kO = 3;

struct Pick {
  int idx;      // searchsorted(cum, t, right), clamped to n - 1
  double base;  // cum[idx - 1], 0 for idx == 0
  double total; // cum[n - 1]
  double t;     // the target searched for
};

// searchsorted(cumsum(a[0..n)), t, right) in warp 0, with t = u * total when
// `frac` (the first level, whose target scales the total) else t = u.  Lane
// l owns a[l*c .. l*c + c), c = ceil(n / 32); cum[k] = excl_l + (the lane's
// sum up to k), where excl_l is the running sum of the lanes' totals, added
// lane after lane: every cum is a sum of non-negative terms rounded the same
// way, so cum never decreases and cum[n-1] is the total.
template <typename F>
__device__ __forceinline__ Pick warp_search(F a, int n, double u, bool frac) {
  const int lane = threadIdx.x & 31;
  const int c = (n + 31) / 32;
  const int lo = min(lane * c, n), hi = min(lo + c, n);
  double loc = 0.0;
  for (int k = lo; k < hi; ++k) loc += a(k);
  double run = 0.0, excl = 0.0;
#pragma unroll
  for (int l = 0; l < 32; ++l) {
    const double v = __shfl_sync(kFull, loc, l);
    if (lane == l) excl = run;
    run += v;
  }
  Pick p;
  p.total = run;
  p.t = frac ? u * run : u;
  unsigned cnt = 0;
  double part = 0.0;
  for (int k = lo; k < hi; ++k) {
    part += a(k);
    cnt += (excl + part) <= p.t;
  }
  const int idx = min((int)__reduce_add_sync(kFull, cnt), n - 1);
  p.idx = idx;
  double base = 0.0;
  if (idx > 0 && idx - 1 >= lo && idx - 1 < hi) {
    part = 0.0;
    for (int k = lo; k < idx; ++k) part += a(k);
    base = excl + part;
  }
  p.base = idx > 0 ? __shfl_sync(kFull, base, (idx - 1) / c) : 0.0;
  return p;
}

struct Shared {
  int go;       // 1 while the loop runs
  int r, i, j, rj_row;
};

// The loop of one superstep in this block; key_out (if not null) receives
// the new key's two words.
template <typename T>
__device__ __forceinline__ void event_loop(T* prob, double* row_sums,
                                           const double* __restrict__ block_sums,
                                           const int* __restrict__ aidx,
                                           const int* __restrict__ inv,
                                           const int* __restrict__ neigh_idx,
                                           const int* __restrict__ rev_slot, int* element,
                                           int* charge, int n_rows, int n_blocks, int m,
                                           uint32_t k0, uint32_t k1, double t_window,
                                           int max_events, int wd_f32, double* out,
                                           uint32_t* key_out) {
  extern __shared__ double s_dyn[];
  double* s_blk = s_dyn;                                   // [n_blocks]
  int* s_touch = reinterpret_cast<int*>(s_dyn + n_blocks);  // [2m + 2] touched rows
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int b = tid; b < n_blocks; b += kThreads) s_blk[b] = block_sums[b];

  // warp 0's registers: the stream and the clock
  TfKey key = {k0, k1};
  double event_time = 0.0;
  int count = 0;
  __syncthreads();

  for (;;) {
    if (warp == 0) {
      int go = event_time < t_window && count < max_events;
      if (go) {
        // lanes 0, 1, 2 take key i of split(key, 3); every lane draws both
        // uniforms of its key (uniform code, no divergence)
        const TfKey kk = tf_split(key, (uint32_t)lane);
        uint32_t b0, b1;
        threefry2x32(kk, 0u, 0u, b0, b1);
        const uint64_t bits64 = (((uint64_t)b0 << 32) | b1) >> 12 | 0x3FF0000000000000ull;
        const uint32_t bits32 = ((b0 ^ b1) >> 9) | 0x3F800000u;
        const double ud = __longlong_as_double((long long)bits64) - 1.0;
        const float uf = __int_as_float((int)bits32) - 1.0f;
        key.k0 = __shfl_sync(kFull, kk.k0, 0);
        key.k1 = __shfl_sync(kFull, kk.k1, 0);
        const double u_sel = __shfl_sync(kFull, ud, 1);
        const double u_t64 = __shfl_sync(kFull, ud, 2);
        const float u_t32 = __shfl_sync(kFull, uf, 2);

        // the hierarchical selection: blocks, rows of the block, slots
        const Pick pb = warp_search([&](int k) { return s_blk[k]; }, n_blocks, u_sel, true);
        const double psum = pb.total;
        const double* rows_here = row_sums + (int64_t)pb.idx * kBlock;
        const Pick pr = warp_search([&](int k) { return rows_here[k]; }, kBlock,
                                    pb.t - pb.base, false);
        const int r = min(pb.idx * kBlock + pr.idx, n_rows - 1);
        const T* prow = prob + (int64_t)r * m;
        const Pick ps = warp_search([&](int k) { return (double)prow[k]; }, m,
                                    pr.t - pr.base, false);
        const int s = ps.idx;
        const bool valid = psum > 0.0 && prow[s] > (T)0;
        if (!valid) {
          event_time = INFINITY;
          go = 0;
        } else {
          const int i = aidx[r];
          const int j = neigh_idx[(int64_t)i * m + s];
          const int jc = max(j, 0);
          const int rj = inv[jc];
          if (lane == 0) {
            // the two-site event (events.py _execute_event)
            const int e_i = element[i], e_j = element[jc];
            const int q_i = charge[i], q_j = charge[jc];
            if (e_i == kD && e_j == kO) {
              element[i] = kOD; element[j] = kV; charge[i] = -2; charge[j] = 2;
            } else if (e_i == kOD && e_j == kV) {
              element[i] = kD; element[j] = kO; charge[i] = 0; charge[j] = 0;
            } else if ((e_i == kV && e_j == kO) || (e_i == kOD && e_j == kD)) {
              element[i] = e_j; element[j] = e_i; charge[i] = q_j; charge[j] = q_i;
            }
            sh.r = r;
            sh.i = i;
            sh.j = j;
            sh.rj_row = (j >= 0 && rj >= 0) ? rj : r;
          }
          // event_time = -log(u_t) in the table's type, then the working type
          if constexpr (sizeof(T) == 8) {
            const double lg = log(u_t64);
            event_time = wd_f32 ? (double)(-(float)lg / (float)psum) : -lg / psum;
          } else {
            const float lg = (float)log((double)u_t32);
            event_time = wd_f32 ? (double)(-lg / (float)psum) : -(double)lg / psum;
          }
          ++count;
        }
      }
      if (lane == 0) sh.go = go;
    }
    __syncthreads();
    if (!sh.go) break;

    // conflict zeroing: slot t < m is i's neighbour t, m <= t < 2m j's
    const int r = sh.r, i = sh.i, j = sh.j, rj_row = sh.rj_row;
    for (int t = tid; t < 2 * m; t += kThreads) {
      const int site = t < m ? i : j;
      const int slot = t < m ? t : t - m;
      const int64_t e = (int64_t)site * m + slot;
      const int nbr = neigh_idx[e], sl = rev_slot[e];
      const int crow = inv[max(nbr, 0)];
      const bool ok = nbr >= 0 && sl >= 0 && crow >= 0;
      const int row = ok ? crow : r;
      prob[(int64_t)row * m + (ok ? sl : 0)] = (T)0;
      s_touch[t] = row;
      prob[(int64_t)(t < m ? r : rj_row) * m + slot] = (T)0;
    }
    if (tid == 0) {
      s_touch[2 * m] = r;
      s_touch[2 * m + 1] = rj_row;
    }
    __syncthreads();

    // the touched rows' sums from the zeroed table, one thread a row
    for (int t = tid; t < 2 * m + 2; t += kThreads) {
      const int row = s_touch[t];
      const T* p = prob + (int64_t)row * m;
      double acc = 0.0;
      for (int c = 0; c < m; ++c) acc += (double)p[c];
      row_sums[row] = acc;
    }
    __syncthreads();

    // the touched blocks' sums from the row sums, one warp a block
    for (int t = warp; t < 2 * m + 2; t += kWarps) {
      const int blk = s_touch[t] / kBlock;
      const double* rs = row_sums + (int64_t)blk * kBlock;
      double acc = ((rs[lane] + rs[lane + 32]) + rs[lane + 64]) + rs[lane + 96];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
      if (lane == 0) s_blk[blk] = acc;
    }
    __syncthreads();
  }

  if (tid == 0) {
    out[0] = event_time;
    out[1] = (double)count;
    out[2] = (double)key.k0;
    out[3] = (double)key.k1;
    if (key_out != nullptr) {
      key_out[0] = key.k0;
      key_out[1] = key.k1;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
kmc_event_loop_kernel(T* prob, double* row_sums, const double* __restrict__ block_sums,
                      const int* __restrict__ aidx, const int* __restrict__ inv,
                      const int* __restrict__ neigh_idx, const int* __restrict__ rev_slot,
                      int* element, int* charge, int n_rows, int n_blocks, int m,
                      uint32_t k0, uint32_t k1, double t_window, int max_events,
                      int wd_f32, double* out) {
  event_loop<T>(prob, row_sums, block_sums, aidx, inv, neigh_idx, rev_slot, element, charge,
                n_rows, n_blocks, m, k0, k1, t_window, max_events, wd_f32, out, nullptr);
}

// B replicas, block b the loop of replica b on its own table, sums, element,
// charge and key: prob [B, n_rows, m], row_sums [B, n_blocks * kBlock],
// block_sums [B, n_blocks], element and charge [B, n_sites], keys [B, 2]
// (read at the start, the new key written back), out [B, 4].  aidx and inv
// are shared (stride 0) or one a replica (strides n_rows and n_sites).
// Each block is the single launch's block, so replica b's events are the
// single loop's on replica b's inputs, bit for bit.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
kmc_event_loop_batched_kernel(T* prob, double* row_sums, const double* __restrict__ block_sums,
                              const int* __restrict__ aidx, int64_t aidx_stride,
                              const int* __restrict__ inv, int64_t inv_stride,
                              const int* __restrict__ neigh_idx,
                              const int* __restrict__ rev_slot, int* element, int* charge,
                              int n_sites, int n_rows, int n_blocks, int m, uint32_t* keys,
                              double t_window, int max_events, int wd_f32, double* out,
                              unsigned long long* launches) {
  count_launch(launches);
  const int64_t b = blockIdx.x;
  event_loop<T>(prob + b * n_rows * m, row_sums + b * n_blocks * kBlock,
                block_sums + b * n_blocks, aidx + b * aidx_stride, inv + b * inv_stride,
                neigh_idx, rev_slot, element + b * n_sites, charge + b * n_sites, n_rows,
                n_blocks, m, keys[2 * b], keys[2 * b + 1], t_window, max_events, wd_f32,
                out + 4 * b, keys + 2 * b);
}

// 10^4-scale check of the device stream: from `key`, n successive
// (key, k_sel, k_time) = split(key, 3) with the draws of both keys in f64 and
// f32, one thread in order.
__global__ void threefry_draws_kernel(uint32_t k0, uint32_t k1, int n, uint32_t* keys,
                                      double* u64, float* u32) {
  TfKey key = {k0, k1};
  for (int e = 0; e < n; ++e) {
    const TfKey ks = tf_split(key, 1u), kt = tf_split(key, 2u);
    key = tf_split(key, 0u);
    keys[2 * e] = key.k0;
    keys[2 * e + 1] = key.k1;
    u64[2 * e] = tf_uniform_f64(ks);
    u64[2 * e + 1] = tf_uniform_f64(kt);
    u32[2 * e] = tf_uniform_f32(ks);
    u32[2 * e + 1] = tf_uniform_f32(kt);
  }
}

size_t shared_bytes(int n_blocks, int m) {
  return (size_t)n_blocks * sizeof(double) + (size_t)(2 * m + 2) * sizeof(int);
}

// Above 48 KB a kernel takes dynamic shared memory only after this call.
template <typename K>
cudaError_t allow_shared(K kernel, size_t smem) {
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return cudaSuccess;
}

template <typename T>
int launch_batched(void* prob, void* row_sums, const void* block_sums, const void* aidx,
                   long long aidx_stride, const void* inv, long long inv_stride,
                   const void* neigh_idx, const void* rev_slot, void* element, void* charge,
                   int batch, int n_sites, int n_rows, int n_blocks, int m, void* keys,
                   double t_window, int max_events, int wd_f32, void* out, void* launches,
                   cudaStream_t st) {
  const size_t smem = shared_bytes(n_blocks, m);
  const cudaError_t e = allow_shared(kmc_event_loop_batched_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  kmc_event_loop_batched_kernel<T><<<batch, kThreads, smem, st>>>(
      static_cast<T*>(prob), static_cast<double*>(row_sums),
      static_cast<const double*>(block_sums), static_cast<const int*>(aidx), aidx_stride,
      static_cast<const int*>(inv), inv_stride, static_cast<const int*>(neigh_idx),
      static_cast<const int*>(rev_slot), static_cast<int*>(element), static_cast<int*>(charge),
      n_sites, n_rows, n_blocks, m, static_cast<uint32_t*>(keys), t_window, max_events,
      wd_f32, static_cast<double*>(out), static_cast<unsigned long long*>(launches));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(void* prob, void* row_sums, const void* block_sums, const void* aidx,
           const void* inv, const void* neigh_idx, const void* rev_slot, void* element,
           void* charge, int n_rows, int n_blocks, int m, uint32_t k0, uint32_t k1,
           double t_window, int max_events, int wd_f32, void* out, cudaStream_t st) {
  const size_t smem = shared_bytes(n_blocks, m);
  const cudaError_t e = allow_shared(kmc_event_loop_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  kmc_event_loop_kernel<T><<<1, kThreads, smem, st>>>(
      static_cast<T*>(prob), static_cast<double*>(row_sums),
      static_cast<const double*>(block_sums), static_cast<const int*>(aidx),
      static_cast<const int*>(inv), static_cast<const int*>(neigh_idx),
      static_cast<const int*>(rev_slot), static_cast<int*>(element),
      static_cast<int*>(charge), n_rows, n_blocks, m, k0, k1, t_window, max_events,
      wd_f32, static_cast<double*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// The event loop of one superstep.  prob [n_rows, m] (f64 if is_f64, else
// f32) and row_sums [n_blocks * 128] (f64) are overwritten; block_sums
// [n_blocks] (f64) is read; aidx [n_rows], inv [N], neigh_idx and rev_slot
// [N, m] are int32; element and charge [N] (int32) are updated in place; out
// [4] (f64) receives event_time, the event count and the new key's two words.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int dkmc_kmc_event_loop(void* prob, int is_f64, void* row_sums,
                                   const void* block_sums, const void* aidx,
                                   const void* inv, const void* neigh_idx,
                                   const void* rev_slot, void* element, void* charge,
                                   int n_rows, int n_blocks, int m, unsigned k0,
                                   unsigned k1, double t_window, int max_events,
                                   int wd_f32, void* out, void* stream) {
  if (n_rows <= 0 || m <= 0 || n_blocks * kBlock < n_rows || (n_blocks - 1) * kBlock >= n_rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(prob, row_sums, block_sums, aidx, inv, neigh_idx, rev_slot,
                                 element, charge, n_rows, n_blocks, m, k0, k1, t_window,
                                 max_events, wd_f32, out, st)
                : launch<float>(prob, row_sums, block_sums, aidx, inv, neigh_idx, rev_slot,
                                element, charge, n_rows, n_blocks, m, k0, k1, t_window,
                                max_events, wd_f32, out, st);
}

// B replicas in one launch, one block a replica (kmc_event_loop_batched_kernel):
// prob [B, n_rows, m], row_sums [B, n_blocks * 128] (overwritten),
// block_sums [B, n_blocks] (read), aidx [n_rows] or [B, n_rows] (aidx_stride
// 0 or n_rows), inv [N] or [B, N] (inv_stride 0 or N), neigh_idx and
// rev_slot [N, m] shared, element and charge [B, N] updated in place, keys
// [B, 2] (uint32) read and overwritten with the new keys, out [B, 4];
// launches: a uint64 the launch adds one to on the card
// (csrc/launch_count.cuh), or null.  Returns the cudaError_t of the launch.
extern "C" int dkmc_kmc_event_loop_batched(void* prob, int is_f64, void* row_sums,
                                           const void* block_sums, const void* aidx,
                                           long long aidx_stride, const void* inv,
                                           long long inv_stride, const void* neigh_idx,
                                           const void* rev_slot, void* element, void* charge,
                                           int batch, int n_sites, int n_rows, int n_blocks,
                                           int m, void* keys, double t_window,
                                           int max_events, int wd_f32, void* out,
                                           void* launches, void* stream) {
  if (batch <= 0 || n_sites <= 0 || n_rows <= 0 || m <= 0 || n_blocks * kBlock < n_rows
      || (n_blocks - 1) * kBlock >= n_rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch_batched<double>(prob, row_sums, block_sums, aidx, aidx_stride, inv,
                                         inv_stride, neigh_idx, rev_slot, element, charge,
                                         batch, n_sites, n_rows, n_blocks, m, keys, t_window,
                                         max_events, wd_f32, out, launches, st)
                : launch_batched<float>(prob, row_sums, block_sums, aidx, aidx_stride, inv,
                                        inv_stride, neigh_idx, rev_slot, element, charge,
                                        batch, n_sites, n_rows, n_blocks, m, keys, t_window,
                                        max_events, wd_f32, out, launches, st);
}

// keys [n, 2] (uint32), u64 and u32 [n, 2]: the new key of each step and the
// draws of its k_sel and k_time.  Returns the cudaError_t of the launch.
extern "C" int dkmc_threefry_draws(unsigned k0, unsigned k1, int n, void* keys, void* u64,
                                   void* u32, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  threefry_draws_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      k0, k1, n, static_cast<uint32_t*>(keys), static_cast<double*>(u64),
      static_cast<float*>(u32));
  return (int)cudaGetLastError();
}
