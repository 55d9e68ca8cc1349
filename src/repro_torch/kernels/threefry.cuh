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
// Pipes. A round step is x0 += x1; x1 = rotl(x1, r) ^ x0: a funnel shift
// (SHF) and a LOP3 on the integer ALU pipe, 16 lanes a scheduler, beside
// the add, which ptxas puts on the ALU pipe (IADD3) or the FMA pipe (IMAD,
// VIADD). The ALU pipe is the floor of a draw. Written out as templates,
// one per step and round, the draw compiles to fewer ALU-pipe instructions
// than the same arithmetic as an unrolled loop did (PERF.md). Rotating by a
// 32x32->64 product (x * 2^r: low word | high word, one IMAD.WIDE and one
// LOP3) moves the shifts to the FMA pipe, but measured slower on the H100,
// every round or a half or a third of them (PERF.md). Below 2^32 elements
// a caller passes the counter's high word as the constant 0 (uniform_lo),
// which takes the first key injection of the high word off the critical
// path.

#pragma once

#include <cstdint>

namespace threefry {

// step s (0..19) of the 20: x0 += x1; x1 = rotl(x1, r) ^ x0
template <int kStep>
__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1) {
  constexpr int kRot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, kRot[(kStep / 4) % 2 * 4 + kStep % 4]) ^ x0;
}

// round i (0..4) of five: four steps, then a key injection
template <int kRound>
__device__ __forceinline__ void round4(uint32_t& x0, uint32_t& x1,
                                       const uint32_t (&ks)[3]) {
  mix<4 * kRound + 0>(x0, x1);
  mix<4 * kRound + 1>(x0, x1);
  mix<4 * kRound + 2>(x0, x1);
  mix<4 * kRound + 3>(x0, x1);
  x0 += ks[(kRound + 1) % 3];
  x1 += ks[(kRound + 2) % 3] + static_cast<uint32_t>(kRound + 1);
}

// threefry-2x32, 20 rounds, of the counter words (x0, x1); returns the xor
// of the two output words
__device__ __forceinline__ uint32_t xor_bits(uint32_t k0, uint32_t k1,
                                             uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
  round4<0>(x0, x1, ks);
  round4<1>(x0, x1, ks);
  round4<2>(x0, x1, ks);
  round4<3>(x0, x1, ks);
  round4<4>(x0, x1, ks);
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
