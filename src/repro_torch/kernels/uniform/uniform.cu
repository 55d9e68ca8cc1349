// Threefry-2x32 uniforms for Hopper (sm_90a): prng.uniform on the card.
//
// Replaces no TPU kernel: the JAX package draws with jax.random.uniform,
// which XLA fuses into its consumers on the TPU (e.g.
// src/repro/core/engine_walks.py:59). The port does the same where it can:
// the walk engines draw inside walk_step's keyed entry (walk_step.cu (b)),
// which calls the same device code (../threefry.cuh). This kernel serves
// the draws that stay standalone, such as the three-phase engine's Phase-1
// priorities; its plain version (ref.py::uniform_ref) runs threefry as
// int64 torch passes over the whole draw.
//
// The function: element i of a draw of `size` float32 (row-major flat
// index) is the uniform of the 64-bit counter i (threefry.cuh).
//
// Bound on this card: 4 B written a draw against ~115 32-bit integer
// operations (20 rounds of add, rotate, xor; 6 key injections; the float
// conversion), so operations bound it: at 1.46e8 draws 0.58 GB of bytes
// (0.174 ms) against 1.7e10 operations.
//
// Design: everything goes to issuing the integer instructions of the hash.
//  * Below 2^32 elements the counters are 32-bit and the high word is the
//    constant 0: no 64-bit index arithmetic, one key injection fewer.
//  * Each thread draws the four consecutive counters of one 16-byte quad
//    of the output, four independent chains of the hash that the
//    scheduler interleaves, and writes them with one 16-byte store. The
//    output is a fresh allocation, so 16-byte aligned (the launch refuses
//    any other); the up to three floats after the last whole quad are
//    drawn one at a time by block 0.
//  * Rotations are funnel shifts, one SHF each (threefry.cuh).
//  * A draw of 2^32 elements or more takes a plain grid-stride loop over
//    64-bit counters, one float a thread at a time.
// Nothing is read but the two key words, which travel as arguments.

#include <cstdint>
#include <cuda_runtime.h>

#include "../threefry.cuh"

namespace {

constexpr int kThreads = 256;

// size < 2^32, `out` 16-byte aligned: quad q is out[4q .. 4q + 3]; the
// size % 4 elements after the last quad are the tail
__global__ void uniform_quad_kernel(uint32_t k0, uint32_t k1, uint32_t size,
                                    float* __restrict__ out) {
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t quads = size / 4u;
  if (t < (size & 3u)) {
    const uint32_t i = 4u * quads + t;
    out[i] = threefry::uniform_lo(k0, k1, i);
  }
  float4* __restrict__ body = reinterpret_cast<float4*>(out);
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t q = t; q < quads; q += stride) {
    const uint32_t c = 4u * q;
    float4 v;
    v.x = threefry::uniform_lo(k0, k1, c);
    v.y = threefry::uniform_lo(k0, k1, c + 1u);
    v.z = threefry::uniform_lo(k0, k1, c + 2u);
    v.w = threefry::uniform_lo(k0, k1, c + 3u);
    body[q] = v;
  }
}

// size >= 2^32: one float a thread, 64-bit counters
__global__ void uniform_wide_kernel(uint32_t k0, uint32_t k1, long long size,
                                    float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < size; i += stride) {
    out[i] = threefry::uniform(k0, k1, static_cast<unsigned long long>(i));
  }
}

int grid_for(long long items, int sms) {
  const long long want = (items + kThreads - 1) / kThreads;
  const long long most = 32LL * sms;
  return static_cast<int>(want < 1 ? 1 : (want < most ? want : most));
}

}  // namespace

extern "C" {

// out[i] = uniform of counter i under (k0, k1), i < size. `out` must be
// 16-byte aligned, as every fresh allocation is: any other address returns
// cudaErrorMisalignedAddress and launches nothing. Returns the launch's
// cudaError_t.
int uniform_launch(uint32_t k0, uint32_t k1, long long size, float* out,
                   int sms, cudaStream_t stream) {
  if (size <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(out) & 15u) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (size >= (1LL << 32)) {
    uniform_wide_kernel<<<grid_for(size, sms), kThreads, 0, stream>>>(
        k0, k1, size, out);
  } else {
    const uint32_t n = static_cast<uint32_t>(size);
    uniform_quad_kernel<<<grid_for(n / 4u, sms), kThreads, 0, stream>>>(
        k0, k1, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
