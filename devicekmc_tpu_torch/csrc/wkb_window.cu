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
// rintf, eligible when |dE| > ctol and not neighbours, x^1.5 as x*sqrtf(x)),
// built without --use_fast_math.  Rows whose v_ok is 0 and the ragged edge
// are masked by index and hold exact 0 (the TPU kernel displaced their
// positions instead, a need of its tiling, not of the function).
//
// Bound on this card: operations (about 12 FP32 operations, two sqrtf and
// one expf per energy step and pair; the output is written once).  Design:
// one thread per (vacancy, metal) pair, the step loop in registers, the
// vacancy's data broadcast from one load per block row, the metal atoms read
// coalesced.  The loop leaves at the first step with k*dE_step >= |dE|:
// k*dE_step does not decrease with k, so every later term is the exact 0.0
// that the TPU kernel adds; the sum is bit-equal to the full loop's and its
// length follows the data.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
window_block_kernel(const float* __restrict__ vpos, const float* __restrict__ vcb,
                    const uint8_t* __restrict__ v_ok, int n_vac,
                    const float* __restrict__ pos, const float* __restrict__ cb,
                    int n_mp, float prefac, float qV0, float ctol, float nn,
                    float ly, float lz, float dE_step, int pbc, int n_steps,
                    float* __restrict__ out) {
  const int tiles = (n_mp + kThreads - 1) / kThreads;
  const int v = blockIdx.x / tiles;
  const int m = (blockIdx.x % tiles) * kThreads + threadIdx.x;
  if (v >= n_vac || m >= n_mp) return;
  float* o = out + (int64_t)v * n_mp + m;
  if (!v_ok[v]) {
    *o = 0.f;
    return;
  }
  const float dx = vpos[3 * (int64_t)v] - pos[3 * (int64_t)m];
  float dy = vpos[3 * (int64_t)v + 1] - pos[3 * (int64_t)m + 1];
  float dz = vpos[3 * (int64_t)v + 2] - pos[3 * (int64_t)m + 2];
  if (pbc) {
    dy = dy - rintf(dy / ly) * ly;
    dz = dz - rintf(dz / lz) * lz;
  }
  const float dist = sqrtf(dx * dx + dy * dy + dz * dz);
  const float abs_dE = fabsf(vcb[v] - cb[m]);
  const bool elig = (abs_dE > ctol) && !(dist < nn);
  if (!elig) {
    *o = 0.f;
    return;
  }
  const float safe = abs_dE;
  const float s = prefac * (dist * 1e-10f) / safe;
  float T = 0.f;
  for (int k = 0; k < n_steps; ++k) {
    const float iv = (float)k * dE_step;
    if (!(iv < safe)) break;
    const float e1 = qV0 + iv;
    const float e2 = e1 - safe;
    const float e15 = e1 * sqrtf(e1);
    float term;
    if (e2 > 0.f) {
      term = expf(s * (e15 - e2 * sqrtf(e2)));
    } else if (e2 < 0.f) {
      term = expf(s * e15);
    } else {
      term = 0.f;
    }
    T += term;
  }
  *o = -T;
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
  const int64_t blocks = (int64_t)n_vac * ((n_mp + kThreads - 1) / kThreads);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  window_block_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vpos), static_cast<const float*>(vcb),
      static_cast<const uint8_t*>(v_ok), n_vac, static_cast<const float*>(pos),
      static_cast<const float*>(cb), n_mp, prefac, qV0, ctol, nn, ly, lz, dE_step,
      pbc, n_steps, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
