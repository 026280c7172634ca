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
//     searchsorted(cum, target, right) clamped to its last index (here: the
//     entry the target falls in, found by a descent of a tree of sums, the
//     blocks first in 32 runs);
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
// Bound on this card: latency, not bytes.  An event touches 2m+2 rows of m
// entries (some 40 KB at max_nn 51), but every event depends on the one
// before it: the rows of the chosen block, the chosen row and its site, the
// site's neighbours (j), j's neighbours, the rows of those neighbours, the
// zeroed rows' sums are six dependent round trips to memory, and the
// selection needs the sums of the event before: at least two barriers.  A
// clock64() probe (tools/probe_cg_events.py, on an H100 80GB HBM3 at 700 W)
// found the first design's 21,400 cycles an event spread over every phase:
// the 852 block sums walked by one warp, three 32-step shuffle chains, one
// thread a touched row adding its 51 entries one after another, a warp a
// touched row for the block sums (some 40 distinct blocks an event: with
// site_order "x" a site's neighbours lie thousands of rows apart).  Design:
//
//   * ONE persistent block of kThreads threads runs every event: no
//     grid-wide sync, no host.  The block sums live in shared memory, the
//     table and the row sums in device memory;
//   * warp 0 selects: the blocks in 32 runs (a lane sums its run in shared
//     memory), the blocks of the chosen run, the rows of the block, the
//     slots of the row, each level a fixed tree of the lanes' sums (five
//     shuffles) that every lane then walks down its own path, a ballot
//     picking the lane whose path holds, then a walk of that lane's run; the
//     row's site aidx[r] is loaded with the row, and the site's neighbour
//     and reverse-slot rows as soon as it is known, so that the slot search
//     runs while they are in flight; j's rows, element and charge and the
//     rows of i's neighbours in one round trip;
//   * warp 0 also zeroes the conflicts (rows r and rj_row, the reverse slot
//     of i and of j in every neighbouring row that has one) and lists the
//     touched rows without the fill slots (they fall into row r);
//   * the warps then recompute the touched rows' sums, kGroup lanes a row
//     and four rows a warp at once (a lane's slots in order, then three
//     butterfly steps), marking each row's block in a bitmap in shared
//     memory; then the marked blocks' sums from the row sums, four a warp in
//     the same way (site_order "x" spreads an event's ~56 touched rows over
//     some 40 blocks);
//   * the last warp draws the next event's random numbers (key, k_sel,
//     k_time = split(key, 3), both uniforms and the time draw's log) while
//     the sums are recomputed: they do not depend on the table;
//   * sums are recomputed from the zeroed table, never by subtraction, and
//     each has a fixed order, so a launch repeats bit for bit.
//
// The first kRegSlots (128) slots of a row are held in registers: a table of
// longer rows runs the loop's kWide build, which takes a row's other slots
// from memory, 32 at a time in the zeroing and kRegSlots at a time in the
// sums, in the same orders.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch_count.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBlock = 128;   // rows a block of the sum hierarchy (events.py _BLOCK)
constexpr int kChunks = 4;    // slots a row held in registers, in chunks of 32
constexpr int kRegSlots = 32 * kChunks;
constexpr int kGroup = 8;     // lanes a touched row when its sum is recomputed
constexpr int kRowsAtOnce = 32 / kGroup;   // touched rows a warp at once
constexpr int kGroupSlots = kRegSlots / kGroup;  // slots a lane of such a group a pass
constexpr int kDrawWarp = kWarps - 1;  // draws the next event's numbers
constexpr unsigned kFull = 0xffffffffu;

// element codes (structure.Element)
constexpr int kD = 0, kOD = 1, kV = 2, kO = 3;

// The descent of one level of the selection in a warp.  Lane l holds the
// sum x of its run of the level's entries; a fixed tree over the lanes
// (pairs, fours, ... the lower half first) gives each node's sum, the root
// the level's total; then from the root the target t goes to the left child
// while it is below that child's sum, else it loses that sum and goes right.
// A zero-sum subtree is never entered while t is below the root's sum.
// Returns the lane reached (the same in every lane) and leaves in t what is
// left of the target; `total` is the root's sum, and t starts as u * total
// when `frac` (the first level), else as u.  Each lane walks its own path
// with the sums the up-sweep gave it (its own groups' and their siblings'),
// so the descent needs no shuffle: the lane whose every step holds is the
// one reached, with the same comparisons and subtractions.
__device__ __forceinline__ int tree_descent(double x, double u, bool frac, double& t,
                                            double& total) {
  const int lane = threadIdx.x & 31;
  double node[6], sib[5];
  node[0] = x;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    sib[k] = __shfl_xor_sync(kFull, node[k], 1 << k);
    node[k + 1] = (lane >> k) & 1 ? sib[k] + node[k] : node[k] + sib[k];
  }
  total = node[5];
  t = frac ? u * total : u;
  double rest = t;
  bool on_path = true;
#pragma unroll
  for (int k = 4; k >= 0; --k) {
    if ((lane >> k) & 1) {  // the right child: the left one is the sibling
      on_path = on_path && rest >= sib[k];
      rest -= sib[k];
    } else {
      on_path = on_path && rest < node[k];
    }
  }
  const int a = __ffs(__ballot_sync(kFull, on_path)) - 1;
  t = __shfl_sync(kFull, rest, a);
  return a;
}

// Within a lane's run of `cnt` entries v[0..cnt): the entry the target t
// falls in, walking the run in order (t loses each entry it passes; the last
// entry takes whatever is left).  Returns its place and leaves the rest in
// t and the entry's value in vsel.
template <int C>
__device__ __forceinline__ int run_walk(const double (&v)[C], int cnt, double& t,
                                        double& vsel) {
  int kk = 0;
  bool stop = false;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    if (!stop && k < cnt - 1 && t >= v[k]) {
      t -= v[k];
      kk = k + 1;
    } else {
      stop = true;
    }
  }
  vsel = 0.0;
#pragma unroll
  for (int k = 0; k < C; ++k)
    if (k == kk) vsel = v[k];
  return kk;
}

// run_walk of a run read from memory, for rows whose runs do not fit in
// registers: the same comparisons in the same order.
template <typename T>
__device__ __forceinline__ int run_walk_mem(const T* v, int cnt, double& t, double& vsel) {
  int kk = 0;
  for (; kk < cnt - 1; ++kk) {
    const double x = (double)v[kk];
    if (t < x) break;
    t -= x;
  }
  vsel = cnt > 0 ? (double)v[kk] : 0.0;
  return kk;
}

struct Shared {
  int go;       // 1 while the loop runs
  int n_touch;  // rows in s_touch
  // the next event's numbers (the draw warp): its key, the uniform of k_sel
  // (f64) and the log of k_time's uniform (in f64, and in f32 from the f32
  // draw: the time's numerator for an f64 and an f32 table)
  uint32_t k0, k1;
  double u_sel, lg64;
  float lg32;
};

// In the calling warp: key, k_sel, k_time = split(key, 3), the draws of
// k_sel and k_time and the logs of the latter into sh (lanes 0-2 take the
// three keys at once).
__device__ __forceinline__ void draw_next(TfKey& key, Shared& sh) {
  const int lane = threadIdx.x & 31;
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
  if (lane == 0) {
    sh.k0 = key.k0;
    sh.k1 = key.k1;
    sh.u_sel = u_sel;
    sh.lg64 = log(u_t64);
    sh.lg32 = (float)log((double)u_t32);
  }
}

// The bits set in a bitmap of n_words words, read by one warp: nth(k) is
// the index of the k-th bit set (k the same in every lane, below total).
// Lane l keeps word l of a chunk of 32 words and the count of the bits set
// in the chunk's words 0..l (a scan of five shuffles), made once for the
// first chunk.
struct Marks {
  const unsigned* bits;
  int n_words, total;
  unsigned word;  // the first chunk's word of this lane
  int incl;       // bits set in the first chunk's words 0..lane

  __device__ __forceinline__ static void chunk(const unsigned* bits, int n_words, int base,
                                               unsigned& w, int& in) {
    const int lane = threadIdx.x & 31;
    w = base + lane < n_words ? bits[base + lane] : 0u;
    in = __popc(w);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, in, o);
      if (lane >= o) in += y;
    }
  }

  __device__ __forceinline__ Marks(const unsigned* b, int n) : bits(b), n_words(n) {
    chunk(bits, n_words, 0, word, incl);
    total = __shfl_sync(kFull, incl, 31);
    for (int base = 32; base < n_words; base += 32) {
      const int lane = threadIdx.x & 31;
      total += __reduce_add_sync(kFull, (unsigned)__popc(base + lane < n_words
                                                          ? bits[base + lane] : 0u));
    }
  }

  __device__ __forceinline__ int nth(int k) const {
    unsigned w = word;
    int in = incl;
    for (int base = 0;; base += 32) {
      if (base > 0) chunk(bits, n_words, base, w, in);
      const unsigned past = __ballot_sync(kFull, in > k);
      if (past) {
        const int l = __ffs(past) - 1;
        unsigned wl = __shfl_sync(kFull, w, l);
        for (int skip = k - __shfl_sync(kFull, in - __popc(w), l); skip > 0; --skip)
          wl &= wl - 1;
        return (base + l) * 32 + __ffs(wl) - 1;
      }
      k -= __shfl_sync(kFull, in, 31);
    }
  }
};

// The loop of one superstep in this block; key_out (if not null) receives
// the new key's two words.  kWide: m > kRegSlots.
template <typename T, bool kWide>
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
  double* s_blk = s_dyn;                                    // [n_blocks]
  const int n_words = (n_blocks + 31) / 32;
  int* s_touch = reinterpret_cast<int*>(s_blk + n_blocks);  // [2m + 2] touched rows
  // the blocks that touched rows lie in, a bit each
  unsigned* s_mark = reinterpret_cast<unsigned*>(s_touch + 2 * m + 2);  // [n_words]
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int b = tid; b < n_blocks; b += kThreads) s_blk[b] = block_sums[b];
  for (int k = tid; k < n_words; k += kThreads) s_mark[k] = 0u;

  // warp 0's registers: the stream and the clock; the draw warp's: its key
  TfKey key = {k0, k1}, key_d = {k0, k1};
  double event_time = 0.0;
  int count = 0;
  if (warp == kDrawWarp) draw_next(key_d, sh);
  __syncthreads();

  const int c_slot = (m + 31) / 32;  // slots a lane at level 3
  for (int ev = 0;; ++ev) {
    if (warp == 0) {
      int go = event_time < t_window && count < max_events;
      if (go) {
        key.k0 = sh.k0;
        key.k1 = sh.k1;
        const double u_sel = sh.u_sel, lg64 = sh.lg64;
        const float lg32 = sh.lg32;

        // the selection: the blocks in 32 runs (a lane's run: n_run blocks,
        // its sum four partial sums in a fixed order), the blocks of the
        // chosen run, the rows of the block, the slots of the row
        double t, psum, tot;
        const int n_run = (n_blocks + 31) / 32;
        double x;
        {
          const double* bl = s_blk + lane * n_run;
          const int cnt = max(0, min(n_run, n_blocks - lane * n_run));
          double p4[4] = {0.0, 0.0, 0.0, 0.0};
          for (int k0 = 0; k0 < cnt; k0 += 4)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (k0 + q < cnt) p4[q] += bl[k0 + q];
          x = (p4[0] + p4[1]) + (p4[2] + p4[3]);
        }
        const int a0 = tree_descent(x, u_sel, true, t, psum);
        // the chosen run's blocks, c1 a lane (one while n_blocks <= 1,024)
        const int first = a0 * n_run, n1 = max(0, min(n_run, n_blocks - first));
        const int c1 = (n_run + 31) / 32;
        const int lo1 = first + lane * c1, cnt1 = max(0, min(c1, first + n1 - lo1));
        double x1 = 0.0;
        for (int k = 0; k < cnt1; ++k) x1 += s_blk[lo1 + k];
        const int a1 = tree_descent(x1, t, false, t, tot);
        int k1 = 0;
        for (const int last = min(c1, first + n1 - (first + a1 * c1)) - 1; k1 < last; ++k1) {
          const double v = s_blk[first + a1 * c1 + k1];
          if (t < v) break;
          t -= v;
        }
        const int blk = min(first + a1 * c1 + k1, n_blocks - 1);
        const double* rs = row_sums + (int64_t)blk * kBlock + 4 * lane;
        double vr[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) vr[q] = rs[q];
        const int a2 = tree_descent(((vr[0] + vr[1]) + vr[2]) + vr[3], t, false, t, tot);
        double vsel;
        int kk = run_walk(vr, 4, t, vsel);
        kk = __shfl_sync(kFull, kk, a2);
        t = __shfl_sync(kFull, t, a2);
        const int r = min(blk * kBlock + 4 * a2 + kk, n_rows - 1);

        // the row's slots, a run of c_slot a lane (in registers while it
        // fits), and at once the row's site and its neighbours
        const T* prow = prob + (int64_t)r * m;
        const int lo3 = lane * c_slot, cnt3 = max(0, min(c_slot, m - lo3));
        double vs[kChunks];
#pragma unroll
        for (int q = 0; q < kChunks; ++q)
          vs[q] = !kWide && q < cnt3 ? (double)prow[lo3 + q] : 0.0;
        const int i = aidx[r];
        int nb_i[kChunks], rv_i[kChunks];
#pragma unroll
        for (int q = 0; q < kChunks; ++q) {
          const int c = lane + 32 * q;
          nb_i[q] = c < m ? neigh_idx[(int64_t)i * m + c] : -1;
          rv_i[q] = c < m ? rev_slot[(int64_t)i * m + c] : -1;
        }
        const int e_i = element[i], q_i = charge[i];
        double xs = 0.0;
        if constexpr (!kWide) {
#pragma unroll
          for (int q = 0; q < kChunks; ++q) xs += vs[q];
        } else {
          for (int q = 0; q < cnt3; ++q) xs += (double)prow[lo3 + q];
        }
        const int a3 = tree_descent(xs, t, false, t, tot);
        if constexpr (!kWide)
          kk = run_walk(vs, cnt3, t, vsel);
        else
          kk = run_walk_mem(prow + lo3, cnt3, t, vsel);
        kk = __shfl_sync(kFull, kk, a3);
        vsel = __shfl_sync(kFull, vsel, a3);
        const int s = min(a3 * c_slot + kk, m - 1);
        const bool valid = psum > 0.0 && vsel > 0.0;
        if (!valid) {
          event_time = INFINITY;
          go = 0;
        } else {
          // j, its row, its neighbours; the rows of i's neighbours
          int j = 0;
#pragma unroll
          for (int q = 0; q < kChunks; ++q) {
            const int o = __shfl_sync(kFull, nb_i[q], s & 31);
            if (q == (s >> 5)) j = o;
          }
          if constexpr (kWide)
            if (s >= kRegSlots) j = neigh_idx[(int64_t)i * m + s];
          const int jc = max(j, 0);
          int nb_j[kChunks], rv_j[kChunks], cr_i[kChunks];
#pragma unroll
          for (int q = 0; q < kChunks; ++q) {
            const int c = lane + 32 * q;
            nb_j[q] = c < m ? neigh_idx[(int64_t)jc * m + c] : -1;
            rv_j[q] = c < m ? rev_slot[(int64_t)jc * m + c] : -1;
            cr_i[q] = nb_i[q] >= 0 ? inv[nb_i[q]] : -1;
          }
          const int rj = inv[jc], e_j = element[jc], q_j = charge[jc];
          int cr_j[kChunks];
#pragma unroll
          for (int q = 0; q < kChunks; ++q) cr_j[q] = nb_j[q] >= 0 ? inv[nb_j[q]] : -1;
          const int rj_row = (j >= 0 && rj >= 0) ? rj : r;
          if (lane == 0) {
            // the two-site event (events.py _execute_event)
            if (e_i == kD && e_j == kO) {
              element[i] = kOD; element[j] = kV; charge[i] = -2; charge[j] = 2;
            } else if (e_i == kOD && e_j == kV) {
              element[i] = kD; element[j] = kO; charge[i] = 0; charge[j] = 0;
            } else if ((e_i == kV && e_j == kO) || (e_i == kOD && e_j == kD)) {
              element[i] = e_j; element[j] = e_i; charge[i] = q_j; charge[j] = q_i;
            }
          }
          // conflict zeroing: rows r and rj_row, the reverse slot of i and
          // of j in each neighbouring row that has one (an invalid or fill
          // slot falls into row r, which is wiped); the touched rows listed
          int n_touch = 0;
          // slot c of rows r and rj_row wiped; the reverse slot sl of i
          // (h = 0) or of j (h = 1) in the row `row` of its neighbour nbr
          // zeroed and the row listed
          auto zero = [&](int c, const int (&nbr)[2], const int (&sl)[2], const int (&row)[2]) {
            if (c < m) {
              prob[(int64_t)r * m + c] = (T)0;
              prob[(int64_t)rj_row * m + c] = (T)0;
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const bool ok = nbr[h] >= 0 && sl[h] >= 0 && row[h] >= 0;
              if (ok) prob[(int64_t)row[h] * m + sl[h]] = (T)0;
              const unsigned mask = __ballot_sync(kFull, ok);
              if (ok) s_touch[n_touch + __popc(mask & ((1u << lane) - 1))] = row[h];
              n_touch += __popc(mask);
            }
          };
#pragma unroll
          for (int q = 0; q < kChunks; ++q) {
            if (32 * q >= m) break;
            zero(lane + 32 * q, {nb_i[q], nb_j[q]}, {rv_i[q], rv_j[q]}, {cr_i[q], cr_j[q]});
          }
          if constexpr (kWide) {
            for (int c0 = kRegSlots; c0 < m; c0 += 32) {  // a row past the registers
              const int c = c0 + lane;
              int nb[2], rv[2], cr[2];
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int64_t at = (int64_t)(h ? jc : i) * m + c;
                nb[h] = c < m ? neigh_idx[at] : -1;
                rv[h] = c < m ? rev_slot[at] : -1;
                cr[h] = nb[h] >= 0 ? inv[nb[h]] : -1;
              }
              zero(c, nb, rv, cr);
            }
          }
          if (lane == 0) {
            s_touch[n_touch] = r;
            s_touch[n_touch + 1] = rj_row;
            sh.n_touch = n_touch + 2;
          }
          // event_time = -log(u_t) in the table's type, then the working type
          if constexpr (sizeof(T) == 8)
            event_time = wd_f32 ? (double)(-(float)lg64 / (float)psum) : -lg64 / psum;
          else
            event_time = wd_f32 ? (double)(-lg32 / (float)psum) : -(double)lg32 / psum;
          ++count;
        }
      }
      if (lane == 0) sh.go = go;
    } else {
      // the marks of the event before, cleared while warp 0 selects
      for (int k = tid - 32; k < n_words; k += kThreads - 32) s_mark[k] = 0u;
    }
    __syncthreads();
    if (!sh.go) break;
    const int n_touch = sh.n_touch;

    // the touched rows' sums from the zeroed table, kGroup lanes a row and
    // 32 / kGroup rows a warp at once (a lane adds its slots in order,
    // kRegSlots of the row a pass, then a butterfly in the group), each
    // row's block marked in the bitmap
    for (int t0 = warp * kRowsAtOnce; t0 < n_touch; t0 += kThreads / kGroup) {
      const int t = t0 + lane / kGroup, gl = lane % kGroup;
      const int row = t < n_touch ? s_touch[t] : -1;
      double acc = 0.0;
      for (int base = 0; base < (kWide ? m : 1); base += kRegSlots) {
        T v[kGroupSlots];
#pragma unroll
        for (int k = 0; k < kGroupSlots; ++k) {
          const int c = base + gl + kGroup * k;
          v[k] = row >= 0 && c < m ? prob[(int64_t)row * m + c] : (T)0;
        }
#pragma unroll
        for (int k = 0; k < kGroupSlots; ++k) acc += (double)v[k];
      }
#pragma unroll
      for (int o = kGroup / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
      if (gl == 0 && row >= 0) {
        row_sums[row] = acc;
        const int blk = row / kBlock;
        atomicOr(s_mark + (blk >> 5), 1u << (blk & 31));
      }
    }
    __syncthreads();

    // the marked blocks' sums from the row sums, kGroup lanes a block and
    // 32 / kGroup blocks a warp at once (a lane adds its row sums in order,
    // then a butterfly in the group); the draw warp draws the next event's
    // numbers meanwhile
    if (warp == kDrawWarp) {
      draw_next(key_d, sh);
    } else {
      const Marks marks(s_mark, n_words);
      for (int k0 = warp * kRowsAtOnce; k0 < marks.total; k0 += (kWarps - 1) * kRowsAtOnce) {
        int blk = -1;
#pragma unroll
        for (int g = 0; g < kRowsAtOnce; ++g) {
          const int b = k0 + g < marks.total ? marks.nth(k0 + g) : -1;
          if (lane / kGroup == g) blk = b;
        }
        const int gl = lane % kGroup;
        double x[kBlock / kGroup];
#pragma unroll
        for (int k = 0; k < kBlock / kGroup; ++k)
          x[k] = blk >= 0 ? row_sums[(int64_t)blk * kBlock + gl + kGroup * k] : 0.0;
        double acc = 0.0;
#pragma unroll
        for (int k = 0; k < kBlock / kGroup; ++k) acc += x[k];
#pragma unroll
        for (int o = kGroup / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
        if (gl == 0 && blk >= 0) s_blk[blk] = acc;
      }
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

template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads, 1)
kmc_event_loop_kernel(T* prob, double* row_sums, const double* __restrict__ block_sums,
                      const int* __restrict__ aidx, const int* __restrict__ inv,
                      const int* __restrict__ neigh_idx, const int* __restrict__ rev_slot,
                      int* element, int* charge, int n_rows, int n_blocks, int m,
                      uint32_t k0, uint32_t k1, double t_window, int max_events,
                      int wd_f32, double* out) {
  event_loop<T, kWide>(prob, row_sums, block_sums, aidx, inv, neigh_idx, rev_slot, element,
                       charge, n_rows, n_blocks, m, k0, k1, t_window, max_events, wd_f32, out,
                       nullptr);
}

// B replicas, block b the loop of replica b on its own table, sums, element,
// charge and key: prob [B, n_rows, m], row_sums [B, n_blocks * kBlock],
// block_sums [B, n_blocks], element and charge [B, n_sites], keys [B, 2]
// (read at the start, the new key written back), out [B, 4].  aidx and inv
// are shared (stride 0) or one a replica (strides n_rows and n_sites).
// Each block is the single launch's block, so replica b's events are the
// single loop's on replica b's inputs, bit for bit.
template <typename T, bool kWide>
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
  event_loop<T, kWide>(prob + b * n_rows * m, row_sums + b * n_blocks * kBlock,
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

// The block sums, the touched rows, the marks of their blocks.
size_t shared_bytes(int n_blocks, int m) {
  return (size_t)n_blocks * sizeof(double) + (size_t)(2 * m + 2) * sizeof(int)
         + (size_t)((n_blocks + 31) / 32) * sizeof(unsigned);
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
  const auto kernel = m > kRegSlots ? kmc_event_loop_batched_kernel<T, true>
                                    : kmc_event_loop_batched_kernel<T, false>;
  const cudaError_t e = allow_shared(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<batch, kThreads, smem, st>>>(
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
  const auto kernel = m > kRegSlots ? kmc_event_loop_kernel<T, true>
                                    : kmc_event_loop_kernel<T, false>;
  const cudaError_t e = allow_shared(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<1, kThreads, smem, st>>>(
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
  if (n_rows <= 0 || m <= 0 || n_blocks * kBlock < n_rows
      || (n_blocks - 1) * kBlock >= n_rows)
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
