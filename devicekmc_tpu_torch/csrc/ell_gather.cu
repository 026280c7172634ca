// ELL neighbour gather for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel devicekmc_tpu/ops/ell_gather_pallas.py:
// ell_gather_pallas (_gather_call -> _kernel), a page/lane shuffle that the
// TPU needed because its vector unit has no general gather.  Here every
// thread loads its neighbours' words directly.
//
//   out_c[p] = src_c[max(idx[p], 0)]   for every (site, slot) pair p, c < nch
//
// The kernel moves 32-bit words and never does arithmetic on them, so f32
// values and int32 codes pass unchanged.  Pad slots (idx -1) hold site 0's
// word, as the plain path does; callers mask them with neigh_valid.
//
// Bound on this card: bytes.  Each pair reads one int32 index and writes nch
// 4-byte words; the per-site sources (4 bytes a site and channel, ~0.44 MB
// at 109k sites) stay resident in the 50 MB L2, so the index stream and the
// output streams are the traffic.
//
// What the design does about it.  Measured at the headline shape, a form
// with 16 bytes of indices a lane ran as fast as its streams alone when
// every source was local (idx[r, s] = r) and half as slow again with the
// real neighbour list: what the gather costs is the source lines that each
// load instruction touches and L1 does not hold.  So:
//   * a warp takes tiles of 32 * K consecutive slots, K words a lane, lane
//     l on slots l, l + 32, ..., and two tiles a step: 2K index loads a
//     thread are issued before any gather, then all 2K * nch gathers, then
//     the stores.  Every index load and store instruction of a warp covers
//     32 consecutive words, and every gather instruction the neighbours of
//     one or two sites, whose words lie close together (16 bytes of indices
//     a lane spread each gather instruction over four times as many slots
//     and lines).  K = 4 where the tiles fill every SM's blocks; K = 1 for
//     short calls (the rate table's compacted rows), which are latency
//     bound and run four times the warps (the wrapper's gather_grid);
//   * each block sweeps one contiguous range of tiles, its warps side by
//     side, so the sources its rows need (a window of about twice the
//     x-bandwidth of sites) stay in L1 from one step to the next; the grid
//     is a few blocks an SM;
//   * the index and output streams are touched once: loaded with
//     ld.global.cs and stored with st.global.cs (evict first), so that they
//     do not push the sources out of L2; the sources go through the cached
//     read-only path;
//   * a pad slot reads site 0's word, the one line that every warp shares
//     (measured faster than a select from a word read before the loop);
//   * any alignment and any count of pairs: every slot is checked against
//     n_pairs, and the word accesses need no alignment beyond 4 bytes.
// The copy entry (dkmc_ell_stream_copy) runs the same loop with the gather
// left out (out_c[p] = idx[p]): a measurement aid, launched on no path, that
// gives the streams' floor beside the gather.
//
// The batched entry (dkmc_ell_gather_batched) gathers B replicas of each
// channel, src_c [B, n_src], into dst_c [B, n_pairs], in one launch over the
// same tiles: out_c[b, p] = src_c[b, max(idx[p], 0)].  This is the JAX
// package's vmap of the gather (a batch axis of the grid) for an ensemble of
// devices on one geometry.  With a shared index plan (idx [n_pairs]) each
// lane loads its K indices once and gathers the B x nch words at them, so
// the index stream is read once for all replicas and the bound is its bytes
// plus B x nch x (sources + outputs); with one plan a replica (idx [B,
// n_pairs], the compacted rate-table rows of each replica) the lane loads
// the replica's indices before its gathers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_count.cuh"

namespace {

constexpr int kMaxChannels = 2;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct Channels {
  const uint32_t* src[kMaxChannels];
  uint32_t* dst[kMaxChannels];
};

Channels channels(const void* s0, const void* s1, void* d0, void* d1) {
  Channels ch;
  const void* srcs[kMaxChannels] = {s0, s1};
  void* dsts[kMaxChannels] = {d0, d1};
  for (int c = 0; c < kMaxChannels; ++c) {
    ch.src[c] = static_cast<const uint32_t*>(srcs[c]);
    ch.dst[c] = static_cast<uint32_t*>(dsts[c]);
  }
  return ch;
}

template <bool GATHER>
__device__ __forceinline__ uint32_t word(const uint32_t* __restrict__ src, int32_t j) {
  if (!GATHER) return (uint32_t)j;
  return __ldg(src + (j >= 0 ? j : 0));
}

// U tiles of this warp, t, t + kWarps, ...: all index loads, then all
// gathers, then all stores.
template <int U, int K, int NCH, bool GATHER>
__device__ __forceinline__ void tiles(const int32_t* __restrict__ idx, int64_t n_pairs,
                                      const Channels& ch, int64_t t, int lane) {
  int64_t p[U][K];
  int32_t j[U][K];
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      p[u][k] = (t + u * kWarps) * (32 * K) + k * 32 + lane;
      j[u][k] = p[u][k] < n_pairs ? __ldcs(idx + p[u][k]) : -1;
    }
  }
  uint32_t w[U][K][NCH];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int c = 0; c < NCH; ++c) w[u][k][c] = word<GATHER>(ch.src[c], j[u][k]);
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (p[u][k] < n_pairs) {
#pragma unroll
        for (int c = 0; c < NCH; ++c) __stcs(ch.dst[c] + p[u][k], w[u][k][c]);
      }
}

// The batched form of tiles(): the indices of the U tiles once (SHARED) or
// per replica, then replica after replica all gathers and all stores.
template <int U, int K, int NCH, bool SHARED>
__device__ __forceinline__ void tiles_batched(const int32_t* __restrict__ idx, int64_t n_pairs,
                                              const Channels& ch, int64_t t, int lane,
                                              int batch, int64_t n_src) {
  int64_t p[U][K];
  int32_t j[U][K];
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      p[u][k] = (t + u * kWarps) * (32 * K) + k * 32 + lane;
      if (SHARED) j[u][k] = p[u][k] < n_pairs ? __ldcs(idx + p[u][k]) : -1;
    }
  }
  for (int b = 0; b < batch; ++b) {
    const int64_t so = b * n_src, po = b * n_pairs;
    if (!SHARED) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < K; ++k) j[u][k] = p[u][k] < n_pairs ? __ldcs(idx + po + p[u][k]) : -1;
    }
    uint32_t w[U][K][NCH];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int c = 0; c < NCH; ++c) w[u][k][c] = word<true>(ch.src[c] + so, j[u][k]);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (p[u][k] < n_pairs) {
#pragma unroll
          for (int c = 0; c < NCH; ++c) __stcs(ch.dst[c] + po + p[u][k], w[u][k][c]);
        }
  }
}

// Block b sweeps the contiguous range of tiles [t0, t1): base tiles, one
// more for the first rem blocks.  The host divides (a 64-bit division here
// would delay every load of a short call).
template <int K, int NCH, bool GATHER>
__global__ void __launch_bounds__(kThreads)
ell_gather_kernel(const int32_t* __restrict__ idx, int64_t n_pairs, int64_t base, int rem,
                  Channels ch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int b = blockIdx.x;
  const int64_t t0 = base * b + min(b, rem);
  const int64_t t1 = t0 + base + (b < rem ? 1 : 0);
  int64_t t = t0 + warp;
  for (; t + kWarps < t1; t += 2 * kWarps) tiles<2, K, NCH, GATHER>(idx, n_pairs, ch, t, lane);
  if (t < t1) tiles<1, K, NCH, GATHER>(idx, n_pairs, ch, t, lane);
}

template <int K, int NCH, bool SHARED>
__global__ void __launch_bounds__(kThreads)
ell_gather_batched_kernel(const int32_t* __restrict__ idx, int64_t n_pairs, int64_t base,
                          int rem, Channels ch, int batch, int64_t n_src,
                          unsigned long long* launches) {
  count_launch(launches);
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int b = blockIdx.x;
  const int64_t t0 = base * b + min(b, rem);
  const int64_t t1 = t0 + base + (b < rem ? 1 : 0);
  int64_t t = t0 + warp;
  for (; t + kWarps < t1; t += 2 * kWarps)
    tiles_batched<2, K, NCH, SHARED>(idx, n_pairs, ch, t, lane, batch, n_src);
  if (t < t1) tiles_batched<1, K, NCH, SHARED>(idx, n_pairs, ch, t, lane, batch, n_src);
}

template <int K, bool SHARED>
void launch_batched_k(const int32_t* idx, long long n_pairs, int nch, const Channels& ch,
                      int blocks, int batch, long long n_src, unsigned long long* launches,
                      cudaStream_t s) {
  const int64_t n_tiles = (n_pairs + 32 * K - 1) / (32 * K);
  const int64_t base = n_tiles / blocks;
  const int rem = (int)(n_tiles % blocks);
  if (nch == 1)
    ell_gather_batched_kernel<K, 1, SHARED><<<(unsigned)blocks, kThreads, 0, s>>>(
        idx, n_pairs, base, rem, ch, batch, n_src, launches);
  else
    ell_gather_batched_kernel<K, 2, SHARED><<<(unsigned)blocks, kThreads, 0, s>>>(
        idx, n_pairs, base, rem, ch, batch, n_src, launches);
}

template <int K, bool GATHER>
void launch_k(const int32_t* idx, long long n_pairs, int nch, const Channels& ch, int blocks,
              cudaStream_t s) {
  const int64_t n_tiles = (n_pairs + 32 * K - 1) / (32 * K);
  const int64_t base = n_tiles / blocks;
  const int rem = (int)(n_tiles % blocks);
  if (nch == 1)
    ell_gather_kernel<K, 1, GATHER><<<(unsigned)blocks, kThreads, 0, s>>>(idx, n_pairs, base,
                                                                         rem, ch);
  else
    ell_gather_kernel<K, 2, GATHER><<<(unsigned)blocks, kThreads, 0, s>>>(idx, n_pairs, base,
                                                                         rem, ch);
}

int launch(const void* idx, long long n_pairs, int nch, const void* s0, const void* s1,
           void* d0, void* d1, int slots_per_lane, int blocks, void* stream, bool gather) {
  if (nch < 1 || nch > kMaxChannels || n_pairs <= 0 || blocks <= 0
      || (slots_per_lane != 1 && slots_per_lane != 4)) {
    return (int)cudaErrorInvalidValue;
  }
  const Channels ch = channels(s0, s1, d0, d1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  if (slots_per_lane == 4 && gather)
    launch_k<4, true>(ip, n_pairs, nch, ch, blocks, s);
  else if (slots_per_lane == 4)
    launch_k<4, false>(ip, n_pairs, nch, ch, blocks, s);
  else if (gather)
    launch_k<1, true>(ip, n_pairs, nch, ch, blocks, s);
  else
    launch_k<1, false>(ip, n_pairs, nch, ch, blocks, s);
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks of the gather kernel (four slots a lane) for nch channels that one
// SM holds at once (its registers decide), or -1 on an error.
extern "C" int dkmc_ell_gather_blocks_per_sm(int nch) {
  int per_sm = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (nch == 1)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ell_gather_kernel<4, 1, true>,
                                                        kThreads, 0);
  else if (nch == 2)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ell_gather_kernel<4, 2, true>,
                                                        kThreads, 0);
  return err == cudaSuccess ? per_sm : -1;
}

// Both return the cudaError_t of the launch (0 on success).  slots_per_lane:
// 1 or 4; blocks: the grid (512 threads a block; any count covers all pairs).

extern "C" int dkmc_ell_gather(const void* idx, long long n_pairs, int nch,
                               const void* s0, const void* s1, void* d0,
                               void* d1, int slots_per_lane, int blocks, void* stream) {
  return launch(idx, n_pairs, nch, s0, s1, d0, d1, slots_per_lane, blocks, stream, true);
}

// The same streams without the gather: out_c[p] = idx[p] (a measurement aid).
extern "C" int dkmc_ell_stream_copy(const void* idx, long long n_pairs, int nch,
                                    void* d0, void* d1, int slots_per_lane, int blocks,
                                    void* stream) {
  return launch(idx, n_pairs, nch, nullptr, nullptr, d0, d1, slots_per_lane, blocks, stream,
                false);
}

// B replicas in one launch: src_c [batch, n_src], dst_c [batch, n_pairs];
// idx [n_pairs] shared by the replicas (idx_per_replica 0) or [batch,
// n_pairs] (1); launches: a uint64 the launch adds one to on the card
// (csrc/launch_count.cuh), or null.  Returns the cudaError_t of the launch
// (0 on success).
extern "C" int dkmc_ell_gather_batched(const void* idx, long long n_pairs, int nch,
                                       const void* s0, const void* s1, void* d0, void* d1,
                                       int slots_per_lane, int blocks, int batch,
                                       long long n_src, int idx_per_replica, void* launches,
                                       void* stream) {
  if (nch < 1 || nch > kMaxChannels || n_pairs <= 0 || blocks <= 0 || batch <= 0
      || n_src <= 0 || (slots_per_lane != 1 && slots_per_lane != 4)) {
    return (int)cudaErrorInvalidValue;
  }
  const Channels ch = channels(s0, s1, d0, d1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  unsigned long long* lc = static_cast<unsigned long long*>(launches);
  if (slots_per_lane == 4 && !idx_per_replica)
    launch_batched_k<4, true>(ip, n_pairs, nch, ch, blocks, batch, n_src, lc, s);
  else if (slots_per_lane == 4)
    launch_batched_k<4, false>(ip, n_pairs, nch, ch, blocks, batch, n_src, lc, s);
  else if (!idx_per_replica)
    launch_batched_k<1, true>(ip, n_pairs, nch, ch, blocks, batch, n_src, lc, s);
  else
    launch_batched_k<1, false>(ip, n_pairs, nch, ch, blocks, batch, n_src, lc, s);
  return (int)cudaGetLastError();
}
