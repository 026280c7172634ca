// Contact->trap window-integral tunnel block for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel devicekmc_tpu/ops/wkb_pallas.py: wkb_window_block
// (_window_kernel).  Assembles the [n_vac, n_mp] vacancy x metal block of
// the blocked transport operator: for every eligible pair the WKB
// transmission summed over the occupied energy window in steps of dE_step
// (the reference's contact->trap integration), in f32:
//
//   T = sum_{k < n_steps, k*dE_step < |dE|} wkb(qV0 + k*dE_step, |dE|)
//
// with the pair rules of the on-the-fly kernels (y/z minimum image with
// rintf, eligible when |dE| > ctol and not neighbours, x^1.5 as x*sqrt(x)).
// Rows whose v_ok is 0 and the ragged edge hold exact 0 (the TPU kernel
// displaced their positions instead, a need of its tiling, not of the
// function).
//
// Two bounds.  The data-sheet bound counts 13 FP32 operations a step (the
// steps each pair needs, about 53 on the transport path) against the
// card's 67 TFLOP/s.  The issue bound is what the compiled step loop
// allows: its instructions a step against 4 warp instructions a clock an
// SM, and its two special-function instructions (a square root and an
// exp2) against 16 lanes a clock an SM, which bind (tools/fly_sass.py).
//
// What the design does about it.
//
//   * Half of a step's work does not depend on the pair: e1 = qV0 + k dE and
//     e15 = e1 sqrtf(e1) depend on k alone.  Each block builds them once for
//     the steps its pairs need, with the correctly rounded operations of the
//     plain version (window_step_table in ops/wkb_window.py makes the same
//     table), in shared memory, 256 steps at a time; a step reads one float2.
//   * How many steps a pair takes, the first k with k dE >= |dE| (k dE does
//     not decrease with k, and every later term is the exact 0 that the TPU
//     kernel adds), is found once a pair, so the step loop has a trip count
//     and no test; a warp runs the longest window of its 32 pairs (32
//     columns of one row; the metal atoms of a contact share their CB edge
//     closely, so their windows are nearly equal: window_lane_share in
//     ops/wkb_window.py measures it).
//   * A step has no branch: the trapezoidal and triangular barriers are one
//     expression (the clamped e2 is 0 for the triangle), the e2 == 0 term is
//     an exact 0 by a select; sqrt.approx for e2's root and ex2.approx with
//     log2(e) folded into the pair's s (each within 2 ulp; built without
//     --use_fast_math, the PTX names each one).  What decides the exact
//     zeros (distance, eligibility, the window's length, e2 == 0) is
//     computed with the correctly rounded operations of the plain version,
//     in its order.
//   * A block owns 128 columns of one row: the partial assembly's 16 rows
//     run in one wave of 448 blocks.  (Blocks of 2 or 4 rows, which build
//     the table once for more pairs, were slower on an H100 at the full
//     bucket and the partial shape, and gained little at 24,768 metal
//     atoms.)  A row with v_ok 0 costs one load and a store of zeros.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // columns a block
constexpr int kSteps = 256;    // steps of the table in shared memory at a time
constexpr unsigned kFull = 0xffffffffu;

struct Scal {
  float prefac, qV0, ctol, nn, ly, lz, dE, inv_dE;
  int pbc, n_steps;
};

__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ float ex2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// fl(k * dE), the energy offset of step k, as the plain version rounds it
__device__ __forceinline__ float step_offset(int k, const Scal& sc) {
  return __fmul_rn((float)k, sc.dE);
}

// Steps the window of a pair with |dE| = safe takes: the first k with
// k dE >= safe, at most n_steps.  A guess from the quotient, then moved to
// the exact place (the offsets do not decrease with k).
__device__ __forceinline__ int window_steps(float safe, const Scal& sc) {
  int k = (int)fminf(ceilf(safe * sc.inv_dE), (float)sc.n_steps);
  k = max(k, 0);
  while (k > 0 && !(step_offset(k - 1, sc) < safe)) --k;
  while (k < sc.n_steps && step_offset(k, sc) < safe) ++k;
  return k;
}

// The pair (vacancy row, metal column): s2 = s log2(e) and the window's
// steps, 0 for an ineligible pair; the distance, |dE| and s as the plain
// version computes them.
__device__ __forceinline__ int pair_setup(float vx, float vy, float vz, float vcb, float px,
                                          float py, float pz, float pcb, const Scal& sc,
                                          float& safe, float& s2) {
  const float dx = vx - px;
  float dy = vy - py;
  float dz = vz - pz;
  if (sc.pbc) {
    dy = __fsub_rn(dy, __fmul_rn(rintf(__fdiv_rn(dy, sc.ly)), sc.ly));
    dz = __fsub_rn(dz, __fmul_rn(rintf(__fdiv_rn(dz, sc.lz)), sc.lz));
  }
  const float dist = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                          __fmul_rn(dz, dz)));
  safe = fabsf(vcb - pcb);
  if (!(safe > sc.ctol) || dist < sc.nn) return 0;
  const float s = __fdiv_rn(__fmul_rn(sc.prefac, __fmul_rn(dist, 1e-10f)), safe);
  s2 = s * 1.4426950408889634f;
  return window_steps(safe, sc);
}

// T over steps [0, ke) of the table, added to acc in step order.  tab[j] =
// (e1, e15) of one step.
__device__ __forceinline__ float window_sum(const float2* tab, int ke, float safe, float s2,
                                            float acc) {
#pragma unroll 4
  for (int j = 0; j < ke; ++j) {
    const float2 t = tab[j];
    const float e2 = t.x - safe;
    const float e2p = fmaxf(e2, 0.f);
    const float term = ex2_approx(s2 * (t.y - e2p * sqrt_approx(e2p)));
    acc += e2 != 0.f ? term : 0.f;
  }
  return acc;
}

// Grid (rows, column tiles of 128): a block owns 128 columns of one row.
__global__ void __launch_bounds__(kThreads)
window_block_kernel(const float* __restrict__ vpos, const float* __restrict__ vcb,
                    const uint8_t* __restrict__ v_ok, int n_vac,
                    const float* __restrict__ pos, const float* __restrict__ cb,
                    int n_mp, Scal sc, float* __restrict__ out) {
  __shared__ float2 tab[kSteps];
  __shared__ int s_kmax;
  const int tid = threadIdx.x;
  const int v = blockIdx.x;
  const int m = blockIdx.y * kThreads + tid;
  const bool col_ok = m < n_mp;
  float* o = out + (int64_t)v * n_mp + m;
  if (!v_ok[v]) {
    // a row out of the bucket: zeros, nothing else
    if (col_ok) *o = 0.f;
    return;
  }
  float safe = 0.f, s2 = 0.f;
  int nk = 0;
  if (col_ok) {
    nk = pair_setup(vpos[3 * (int64_t)v], vpos[3 * (int64_t)v + 1], vpos[3 * (int64_t)v + 2],
                    vcb[v], pos[3 * (int64_t)m], pos[3 * (int64_t)m + 1],
                    pos[3 * (int64_t)m + 2], cb[m], sc, safe, s2);
  }
  // the longest window of the block
  if (tid == 0) s_kmax = 0;
  __syncthreads();
  const int wmax = (int)__reduce_max_sync(kFull, (unsigned)nk);
  if ((tid & 31) == 0) atomicMax(&s_kmax, wmax);
  __syncthreads();
  const int kmax = s_kmax;
  float T = 0.f;
  for (int k0 = 0; k0 < kmax; k0 += kSteps) {
    const int kn = min(kSteps, kmax - k0);
    if (k0 > 0) __syncthreads();  // every thread is done with the last part
    for (int j = tid; j < kn; j += kThreads) {
      const float e1 = __fadd_rn(sc.qV0, step_offset(k0 + j, sc));
      tab[j] = make_float2(e1, __fmul_rn(e1, __fsqrt_rn(e1)));
    }
    __syncthreads();
    T = window_sum(tab, min(nk - k0, kn), safe, s2, T);
  }
  // an eligible pair takes at least step 0 (0 < |dE|)
  if (col_ok) *o = nk > 0 ? -T : 0.f;
}

}  // namespace

// out [n_vac, n_mp] row-major.  Returns the cudaError_t of the launch.
extern "C" int dkmc_wkb_window_block(const void* vpos, const void* vcb,
                                     const void* v_ok, int n_vac, const void* pos,
                                     const void* cb, int n_mp, float prefac,
                                     float qV0, float ctol, float nn, float ly,
                                     float lz, float dE_step, int pbc, int n_steps,
                                     void* out, void* stream) {
  if (n_vac <= 0 || n_mp <= 0 || n_steps < 0) return (int)cudaErrorInvalidValue;
  const int col_tiles = (n_mp + kThreads - 1) / kThreads;
  if (col_tiles > 65535) return (int)cudaErrorInvalidValue;
  Scal sc;
  sc.prefac = prefac;
  sc.qV0 = qV0;
  sc.ctol = ctol;
  sc.nn = nn;
  sc.ly = ly;
  sc.lz = lz;
  sc.dE = dE_step;
  sc.inv_dE = 1.0f / dE_step;
  sc.pbc = pbc;
  sc.n_steps = n_steps;
  window_block_kernel<<<dim3((unsigned)n_vac, (unsigned)col_tiles), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vpos), static_cast<const float*>(vcb),
      static_cast<const uint8_t*>(v_ok), n_vac, static_cast<const float*>(pos),
      static_cast<const float*>(cb), n_mp, sc, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
