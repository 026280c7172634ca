// The JAX random stream on the device: Threefry-2x32 (20 rounds) with the
// key split and the uniform draws of devicekmc_tpu_torch/rng.py, which is
// bit-equal to jax.random (jax_threefry_partitionable, 64-bit seeds).
//
//   split(key, n): key i = threefry2x32(key, (0, i))
//   uniform f64:   (b0 << 32 | b1) >> 12 | 0x3FF0000000000000, minus 1
//   uniform f32:   (b0 ^ b1) >> 9 | 0x3F800000, minus 1
//
// with (b0, b1) = threefry2x32(key, (0, 0)).  Integer arithmetic only, so the
// bits do not depend on the compiler's floating-point choices; the final
// subtraction of 1 is exact in either type.
#pragma once

#include <stdint.h>
#include <string.h>

struct TfKey {
  uint32_t k0, k1;
};

__host__ __device__ __forceinline__ uint32_t tf_rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// The 20-round Threefry-2x32 block function of (k0, k1) on the counter
// (c0, c1), as jax._src.prng.threefry2x32: rotations (13, 15, 26, 6) and
// (17, 29, 16, 24) in turns, a key injection after every 4 rounds.
__host__ __device__ __forceinline__ void threefry2x32(TfKey key, uint32_t c0, uint32_t c1,
                                                      uint32_t& o0, uint32_t& o1) {
  const uint32_t ks[3] = {key.k0, key.k1, key.k0 ^ key.k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = c0 + ks[0], x1 = c1 + ks[1];
#pragma unroll
  for (int step = 0; step < 5; ++step) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      x0 += x1;
      x1 = tf_rotl(x1, rot[step & 1][q]) ^ x0;
    }
    x0 += ks[(step + 1) % 3];
    x1 += ks[(step + 2) % 3] + (uint32_t)(step + 1);
  }
  o0 = x0;
  o1 = x1;
}

// Key i of split(key, n).
__host__ __device__ __forceinline__ TfKey tf_split(TfKey key, uint32_t i) {
  TfKey out;
  threefry2x32(key, 0u, i, out.k0, out.k1);
  return out;
}

// One uniform draw in [0, 1) as a double.
__host__ __device__ __forceinline__ double tf_uniform_f64(TfKey key) {
  uint32_t b0, b1;
  threefry2x32(key, 0u, 0u, b0, b1);
  const uint64_t bits = (((uint64_t)b0 << 32) | b1) >> 12 | 0x3FF0000000000000ull;
  double f;
  memcpy(&f, &bits, sizeof f);
  return f - 1.0;
}

// One uniform draw in [0, 1) as a float.
__host__ __device__ __forceinline__ float tf_uniform_f32(TfKey key) {
  uint32_t b0, b1;
  threefry2x32(key, 0u, 0u, b0, b1);
  const uint32_t bits = ((b0 ^ b1) >> 9) | 0x3F800000u;
  float f;
  memcpy(&f, &bits, sizeof f);
  return f - 1.0f;
}
