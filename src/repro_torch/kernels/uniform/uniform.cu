// Threefry-2x32 uniforms for Hopper (sm_90a): prng.uniform on the card.
//
// Replaces no TPU kernel: the JAX package draws with jax.random.uniform,
// which XLA fuses into its consumers on the TPU (e.g.
// src/repro/core/engine_walks.py:59). The port's plain version
// (ref.py::uniform_ref) runs threefry as int64 torch passes over the whole
// draw, which set the single-device walk engine's and Algorithm 2's time.
//
// Per element i of a draw of `size` float32 (row-major flat index), as
// jax.random.uniform in partitionable mode: threefry-2x32 (20 rounds)
// under the key words (k0, k1) of the 64-bit counter i, split into the
// words (i >> 32, i & 0xFFFFFFFF); the xor of the two output words, >> 9,
// | 0x3F800000 (23 random mantissa bits under the exponent of 1.0), as a
// float, minus 1. Native uint32 arithmetic, so it is bit-exact with the
// plain version.
//
// Bound on this card: 4 B written a draw against ~115 32-bit integer
// operations (20 rounds of add, rotate, xor; 6 key injections; the float
// conversion), so operations bound it: at 1.46e8 draws 0.58 GB of bytes
// (0.174 ms) against 1.7e10 operations.
//
// Design: one thread per element in a grid-stride loop; neighbouring
// threads write neighbouring floats, so the stores coalesce. Nothing is
// read but the two key words, which travel as arguments.
//
// The device functions are those of walk_step.cu (entry (b)), copied so
// that each source builds alone.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry-2x32, 20 rounds; returns the xor of the two output words
__device__ __forceinline__ uint32_t threefry_xor(uint32_t k0, uint32_t k1,
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

__device__ __forceinline__ float uniform_at(uint32_t k0, uint32_t k1,
                                            long long i) {
  const uint32_t bits = threefry_xor(
      k0, k1, static_cast<uint32_t>(static_cast<unsigned long long>(i) >> 32),
      static_cast<uint32_t>(i));
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

__global__ void uniform_kernel(uint32_t k0, uint32_t k1, long long size,
                               float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < size; i += stride) {
    out[i] = uniform_at(k0, k1, i);
  }
}

}  // namespace

extern "C" {

// out[i] = uniform of counter i under (k0, k1), i < size. Returns the
// launch's cudaError_t.
int uniform_launch(uint32_t k0, uint32_t k1, long long size, float* out,
                   int sms, cudaStream_t stream) {
  if (size == 0) return 0;
  const long long want = (size + kThreads - 1) / kThreads;
  const long long most = 32LL * sms;
  const int grid = static_cast<int>(want < most ? want : most);
  uniform_kernel<<<grid, kThreads, 0, stream>>>(k0, k1, size, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
