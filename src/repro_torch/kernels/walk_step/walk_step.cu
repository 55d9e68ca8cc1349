// Fused PageRank walk step for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/walk_step/walk_step.py:
// walk_step_pallas (body _walk_kernel), which mapped one shard's whole CSR
// table into VMEM and streamed the walk arrays through it in blocks.
// Per walk slot i:
//   deg      = out_deg[clip(pos)]
//   survive  = alive && u_term >= eps && deg > 0      (dangling = reset)
//   j        = min(trunc(u_edge * float(max(deg, 1))), max(deg - 1, 0))
//   new_pos  = survive ? col_idx[clip(row_ptr[clip(pos)] + j)] : pos
//   new_alive = survive
//
// Two entry points:
//  (a) walk_step_launch: the uniforms are inputs, the contract of
//      walk_step_pallas (used by the parity tests);
//  (b) walk_step_keyed_launch: the kernel draws u_term and u_edge itself
//      with threefry-2x32 (20 rounds) on the 64-bit counter i under each
//      key, as jax.random.uniform does in partitionable mode: the xor of
//      the two output words, >> 9, | 0x3F800000, as a float, minus 1.
//      This is what routing.advance_owned launches. A slot that is not
//      alive skips both draws and a slot that terminates skips the edge
//      draw: their outputs do not depend on them.
//
// Bound on this card. (a) moves bytes: 24 B a slot (four 4-byte inputs,
// two 4-byte outputs) plus the tables once; there are a handful of
// integer operations a slot. (b) moves 16 B a slot but spends ~200 32-bit
// integer operations on each of its (up to) two threefry draws, so at
// H100 rates it is bound by operations: 2.9e8 eligible slots x 2 draws
// x ~200 ops is ~1.2e11 ops, against ~4.7 GB of bytes.
//
// Design: one thread per slot, a grid-stride loop. deg, row_ptr and
// col_idx are gathered straight from global memory through the read-only
// path (__ldg): a shard's CSR at 2^20 vertices is tens of MB, far beyond
// what shared memory could stage, and the gathers are random anyway.
//
// Exactness: the edge pick is one float32 multiply rounded to nearest,
// then a truncation toward zero; nothing follows the multiply that an FMA
// could fuse, and the sources are built with --fmad=false and without
// fast math. The threefry is native uint32 arithmetic. Both entry points
// are bit-exact with the plain torch version.

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

// The edge pick of a surviving walk at local vertex p of degree deg.
__device__ __forceinline__ int32_t pick(int32_t p, int32_t deg, float u_edge,
                                        const int32_t* __restrict__ row_ptr,
                                        const int32_t* __restrict__ col_idx,
                                        long long m) {
  const float scaled = __fmul_rn(u_edge, static_cast<float>(deg));
  int32_t j = static_cast<int32_t>(scaled);  // truncation toward zero
  j = min(j, deg - 1);
  long long eid = static_cast<long long>(__ldg(row_ptr + p)) + j;
  eid = eid < 0 ? 0 : (eid > m - 1 ? m - 1 : eid);
  return __ldg(col_idx + eid);
}

__global__ void walk_step_kernel(const int32_t* __restrict__ pos,
                                 const int32_t* __restrict__ alive,
                                 const float* __restrict__ u_term,
                                 const float* __restrict__ u_edge,
                                 const int32_t* __restrict__ row_ptr,
                                 const int32_t* __restrict__ col_idx,
                                 const int32_t* __restrict__ out_deg,
                                 long long w, int n, long long m, float eps,
                                 int32_t* __restrict__ new_pos,
                                 int32_t* __restrict__ new_alive) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < w; i += stride) {
    const int32_t p0 = pos[i];
    const int32_t p = min(max(p0, 0), n - 1);
    const int32_t deg = __ldg(out_deg + p);
    const bool survive = alive[i] != 0 && u_term[i] >= eps && deg > 0;
    new_pos[i] = survive ? pick(p, deg, u_edge[i], row_ptr, col_idx, m) : p0;
    new_alive[i] = survive ? 1 : 0;
  }
}

__global__ void walk_step_keyed_kernel(const int32_t* __restrict__ pos,
                                       const int32_t* __restrict__ alive,
                                       uint32_t kt0, uint32_t kt1,
                                       uint32_t ke0, uint32_t ke1,
                                       const int32_t* __restrict__ row_ptr,
                                       const int32_t* __restrict__ col_idx,
                                       const int32_t* __restrict__ out_deg,
                                       long long w, int n, long long m,
                                       float eps,
                                       int32_t* __restrict__ new_pos,
                                       int32_t* __restrict__ new_alive) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < w; i += stride) {
    const int32_t p0 = pos[i];
    bool survive = false;
    int32_t out = p0;
    if (alive[i] != 0) {
      const int32_t p = min(max(p0, 0), n - 1);
      const int32_t deg = __ldg(out_deg + p);
      if (deg > 0 && uniform_at(kt0, kt1, i) >= eps) {
        survive = true;
        out = pick(p, deg, uniform_at(ke0, ke1, i), row_ptr, col_idx, m);
      }
    }
    new_pos[i] = out;
    new_alive[i] = survive ? 1 : 0;
  }
}

int grid_for(long long w, int sms) {
  const long long want = (w + kThreads - 1) / kThreads;
  const long long most = 32LL * sms;
  return static_cast<int>(want < most ? want : most);
}

}  // namespace

extern "C" {

// (a) uniforms as inputs. Returns the launch's cudaError_t.
int walk_step_launch(const int32_t* pos, const int32_t* alive,
                     const float* u_term, const float* u_edge,
                     const int32_t* row_ptr, const int32_t* col_idx,
                     const int32_t* out_deg, long long w, int n, long long m,
                     float eps, int32_t* new_pos, int32_t* new_alive, int sms,
                     cudaStream_t stream) {
  if (w == 0) return 0;
  walk_step_kernel<<<grid_for(w, sms), kThreads, 0, stream>>>(
      pos, alive, u_term, u_edge, row_ptr, col_idx, out_deg, w, n, m, eps,
      new_pos, new_alive);
  return static_cast<int>(cudaGetLastError());
}

// (b) key words as inputs: the kernel draws its own uniforms.
int walk_step_keyed_launch(const int32_t* pos, const int32_t* alive,
                           uint32_t kt0, uint32_t kt1, uint32_t ke0,
                           uint32_t ke1, const int32_t* row_ptr,
                           const int32_t* col_idx, const int32_t* out_deg,
                           long long w, int n, long long m, float eps,
                           int32_t* new_pos, int32_t* new_alive, int sms,
                           cudaStream_t stream) {
  if (w == 0) return 0;
  walk_step_keyed_kernel<<<grid_for(w, sms), kThreads, 0, stream>>>(
      pos, alive, kt0, kt1, ke0, ke1, row_ptr, col_idx, out_deg, w, n, m, eps,
      new_pos, new_alive);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
