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
//      This is what routing.advance_owned, the single-device walk engine
//      (engine_walks.advance) and Algorithm 2's Phase 1
//      (improved_pagerank._phase1_scan) launch. A slot that is not alive
//      skips both draws and a slot that terminates skips the edge draw:
//      their outputs do not depend on them. On request it also writes
//      edge = row_ptr[pos] + j where the slot moves and -1 elsewhere, the
//      single-device engines' CONGEST payload and Phase 1's edge table.
//
// Bound on this card. (a) moves bytes: 24 B a slot (four 4-byte inputs,
// two 4-byte outputs) plus the tables once; there are a handful of
// integer operations a slot. (b) moves 16 B a slot with int32 `alive`,
// 10 B with bool (4 B more with the edge output), and spends ~115 32-bit
// integer operations on each of its (up to) two threefry draws
// (threefry.cuh, the same device code as uniform.cu).
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

#include "../threefry.cuh"

namespace {

constexpr int kThreads = 256;

// The edge a surviving walk at local vertex p of degree deg takes:
// row_ptr[p] + j, not clipped (walk_step_keyed's `edge` output).
__device__ __forceinline__ long long edge_of(
    int32_t p, int32_t deg, float u_edge, const int32_t* __restrict__ row_ptr) {
  const float scaled = __fmul_rn(u_edge, static_cast<float>(deg));
  int32_t j = static_cast<int32_t>(scaled);  // truncation toward zero
  j = min(j, deg - 1);
  return static_cast<long long>(__ldg(row_ptr + p)) + j;
}

// The head of edge `eid`, clipped to the table.
__device__ __forceinline__ int32_t head_of(long long eid,
                                           const int32_t* __restrict__ col_idx,
                                           long long m) {
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
    new_pos[i] = survive
        ? head_of(edge_of(p, deg, u_edge[i], row_ptr), col_idx, m) : p0;
    new_alive[i] = survive ? 1 : 0;
  }
}

// Alive: the type of alive and new_alive, int32_t (the sharded engines) or
// uint8_t (a torch bool tensor: the single-device engines). kEdges: also
// write edge[i], the edge id the slot moved along, -1 where it did not move
template <typename Alive, bool kEdges>
__global__ void walk_step_keyed_kernel(const int32_t* __restrict__ pos,
                                       const Alive* __restrict__ alive,
                                       uint32_t kt0, uint32_t kt1,
                                       uint32_t ke0, uint32_t ke1,
                                       const int32_t* __restrict__ row_ptr,
                                       const int32_t* __restrict__ col_idx,
                                       const int32_t* __restrict__ out_deg,
                                       long long w, int n, long long m,
                                       float eps,
                                       int32_t* __restrict__ new_pos,
                                       Alive* __restrict__ new_alive,
                                       int32_t* __restrict__ edge) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < w; i += stride) {
    const unsigned long long c = static_cast<unsigned long long>(i);
    const int32_t p0 = pos[i];
    bool survive = false;
    int32_t out = p0;
    long long eid = -1;
    if (alive[i] != 0) {
      const int32_t p = min(max(p0, 0), n - 1);
      const int32_t deg = __ldg(out_deg + p);
      if (deg > 0 && threefry::uniform(kt0, kt1, c) >= eps) {
        survive = true;
        eid = edge_of(p, deg, threefry::uniform(ke0, ke1, c), row_ptr);
        out = head_of(eid, col_idx, m);
      }
    }
    new_pos[i] = out;
    new_alive[i] = survive ? 1 : 0;
    if (kEdges) edge[i] = static_cast<int32_t>(eid);
  }
}

template <typename Alive>
void launch_keyed(const int32_t* pos, const void* alive, uint32_t kt0,
                  uint32_t kt1, uint32_t ke0, uint32_t ke1,
                  const int32_t* row_ptr, const int32_t* col_idx,
                  const int32_t* out_deg, long long w, int n, long long m,
                  float eps, int32_t* new_pos, void* new_alive, int32_t* edge,
                  int grid, cudaStream_t stream) {
  const Alive* a = static_cast<const Alive*>(alive);
  Alive* na = static_cast<Alive*>(new_alive);
  if (edge == nullptr) {
    walk_step_keyed_kernel<Alive, false><<<grid, kThreads, 0, stream>>>(
        pos, a, kt0, kt1, ke0, ke1, row_ptr, col_idx, out_deg, w, n, m, eps,
        new_pos, na, edge);
  } else {
    walk_step_keyed_kernel<Alive, true><<<grid, kThreads, 0, stream>>>(
        pos, a, kt0, kt1, ke0, ke1, row_ptr, col_idx, out_deg, w, n, m, eps,
        new_pos, na, edge);
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

// (b) key words as inputs: the kernel draws its own uniforms. `alive` and
// `new_alive` hold int32 or, with alive_bytes == 1, bytes (torch bool).
// `edge` may be null; otherwise it receives each slot's edge id (-1 where
// the slot did not move).
int walk_step_keyed_launch(const int32_t* pos, const void* alive,
                           uint32_t kt0, uint32_t kt1, uint32_t ke0,
                           uint32_t ke1, const int32_t* row_ptr,
                           const int32_t* col_idx, const int32_t* out_deg,
                           long long w, int n, long long m, float eps,
                           int alive_bytes, int32_t* new_pos, void* new_alive,
                           int32_t* edge, int sms, cudaStream_t stream) {
  if (w == 0) return 0;
  if (alive_bytes != 1 && alive_bytes != 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = grid_for(w, sms);
  if (alive_bytes == 1) {
    launch_keyed<uint8_t>(pos, alive, kt0, kt1, ke0, ke1, row_ptr, col_idx,
                          out_deg, w, n, m, eps, new_pos, new_alive, edge,
                          grid, stream);
  } else {
    launch_keyed<int32_t>(pos, alive, kt0, kt1, ke0, ke1, row_ptr, col_idx,
                          out_deg, w, n, m, eps, new_pos, new_alive, edge,
                          grid, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
