// threefry2x32 (20 rounds; Salmon et al. 2011), the generator JAX uses,
// shared by the port's CUDA kernels.  Pure 32-bit integer arithmetic, so
// the plain-torch twin (photonic_matmul.py::threefry2x32) draws the same
// words bit for bit.
#pragma once

#include <stdint.h>

namespace repro_torch {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// (key k0, k1; counter x0, x1) -> two words, in place.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  const uint32_t ks[3] = {k0, k1, 0x1BD11BDAu ^ k0 ^ k1};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int r = 0; r < 20; ++r) {
    x0 += x1;
    x1 = rotl32(x1, rot[r % 8]);
    x1 ^= x0;
    if (r % 4 == 3) {
      const int i = r / 4 + 1;
      x0 += ks[i % 3];
      x1 += ks[(i + 1) % 3] + static_cast<uint32_t>(i);
    }
  }
}

}  // namespace repro_torch
