// Threefry-2x32 uniforms in device code, shared by uniform.cu and
// walk_step.cu (entry (b)): the one copy of the generator on the card.
//
// Per element i of a draw, as jax.random.uniform in partitionable mode:
// threefry-2x32 (20 rounds) under the key words (k0, k1) of the 64-bit
// counter i, split into the words (i >> 32, i & 0xFFFFFFFF); the xor of the
// two output words, >> 9, | 0x3F800000 (23 random mantissa bits under the
// exponent of 1.0), as a float, minus 1. Native uint32 arithmetic and one
// exact float subtraction, so it is bit-exact with the plain version
// (kernels/uniform/ref.py) whatever the compiler's flags.
//
// Each rotation is a funnel shift (one SHF). Below 2^32 elements a caller
// passes the counter's high word as the constant 0 (uniform_lo), which
// takes the first key injection of the high word off the critical path.

#pragma once

#include <cstdint>

namespace threefry {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry-2x32, 20 rounds, of the counter words (x0, x1); returns the xor
// of the two output words
__device__ __forceinline__ uint32_t xor_bits(uint32_t k0, uint32_t k1,
                                             uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x0 += x1;
      x1 = rotl32(x1, rot[i % 2][k]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return x0 ^ x1;
}

__device__ __forceinline__ float to_unit(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// the uniform of the 64-bit counter i
__device__ __forceinline__ float uniform(uint32_t k0, uint32_t k1,
                                        unsigned long long i) {
  return to_unit(xor_bits(k0, k1, static_cast<uint32_t>(i >> 32),
                          static_cast<uint32_t>(i)));
}

// the uniform of a counter below 2^32: the high word is the constant 0
__device__ __forceinline__ float uniform_lo(uint32_t k0, uint32_t k1,
                                           uint32_t i) {
  return to_unit(xor_bits(k0, k1, 0u, i));
}

}  // namespace threefry
