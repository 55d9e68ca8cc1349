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
//      walk_step_pallas (used by the parity tests); one thread a slot.
//      Edge ids are int32 sums, as the plain version adds them.
//  (b) walk_step_keyed_launch: in place, and the kernel draws u_term and
//      u_edge itself with threefry-2x32 (20 rounds, ../threefry.cuh) on
//      the counter i under each key, as jax.random.uniform does in
//      partitionable mode. A survivor's pos gets its new vertex, a slot
//      that ends gets alive = 0, and a dead slot is read for its alive
//      flag only and never written. On request it also writes
//      edge[i] = row_ptr[pos] + j where the slot moved and -1 elsewhere
//      (every slot), and appends each survivor's new vertex to `arrivals`
//      in no fixed order, with the number appended in `count`. This is
//      what routing.advance_owned, the single-device walk engine
//      (engine_walks._step_core) and Algorithm 2's Phase 1
//      (improved_pagerank._phase1_scan) launch.
//
// Bound on this card, (b): alive is read over all W slots (1 or 4 B);
// each live slot reads pos (4 B) and either writes it (a survivor) or its
// alive flag (a slot that ends); it gathers out_deg, and a survivor
// row_ptr and col_idx; edge adds 4 B a slot, arrivals 4 B a survivor. The
// live slots spend ~115 32-bit integer operations on each of their two
// threefry draws. Three things bound it in practice. In the rounds where
// most walks are alive the draws' integer ALU pipe is the floor (SHF and
// LOP3 of 20 rounds a draw; a rotation by multiply, which moves them to
// the FMA pipe, measured slower: ../threefry.cuh). In the late rounds, a
// live walk's 4-byte reads and writes of pos and alive each cost a 32-byte
// sector, since its neighbours are dead. And the gathers of a round after
// the first are random.
//
// Design of (b): persistent blocks, one tile of 4096 slots (16 a thread)
// at a time. A thread reads its 16 flags with one to four 16-byte loads
// (scalar loads where the tensor is not 16-byte aligned or the tile is
// ragged), the next tile's while it packs this one; warp scans and a block
// prefix pack the live slots into a list in shared memory, and the block
// steps the list once it holds a thousand or more: so the bytes and the
// draws of a round follow the live walks, not W, and a warp that draws
// has every lane busy. A thread steps four packed slots at once, its
// lanes on neighbouring list entries: it loads the next four positions
// while it draws for these, gathers out_deg and row_ptr before the draws
// (four independent chains of each, which hide the gathers' latency) and
// the four heads together after them. Both draws are made for every live
// slot: the edge draw of a slot that ends is wasted (a fifth of them at
// eps = 0.2), as it would be in a lane that idles beside a survivor. The
// survivors' new vertices are staged in shared memory and appended with
// one atomicAdd on the global count a batch of a thousand or more (same-
// address atomics serialise in one L2 slice). Each slot's edge id is
// written once: -1 by the pack for a dead slot, by the step for a live
// one. Below 2^31 slots indices are 32-bit and the counter's high word is
// the constant 0 (threefry::uniform_lo); the wide instantiation keeps
// 64-bit indices and counters.
//
// Exactness: the edge pick is one float32 multiply rounded to nearest,
// then a truncation toward zero; nothing follows the multiply that an FMA
// could fuse, and the sources are built with --fmad=false and without
// fast math. The threefry is native uint32 arithmetic. Both entry points
// are bit-exact with the plain torch version.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "../threefry.cuh"

namespace {

constexpr int kThreads = 256;

// The edge a surviving walk at local vertex p of degree deg takes from
// its row start rp: rp + j in int32, as the plain version adds them, not
// clipped (the `edge` output).
__device__ __forceinline__ int32_t edge_from(int32_t rp, int32_t deg,
                                             float u_edge) {
  const float scaled = __fmul_rn(u_edge, static_cast<float>(deg));
  int32_t j = static_cast<int32_t>(scaled);  // truncation toward zero
  j = min(j, deg - 1);
  return static_cast<int32_t>(static_cast<uint32_t>(rp) +
                              static_cast<uint32_t>(j));
}

// The head of edge `eid`, clipped to the table's last entry `last`.
__device__ __forceinline__ int32_t head_of(int32_t eid,
                                           const int32_t* __restrict__ col_idx,
                                           int32_t last) {
  return __ldg(col_idx + min(max(eid, 0), last));
}

// The last entry of a table of m, as an int32 (int32 edge ids reach no
// further)
__host__ __device__ __forceinline__ int32_t last_of(long long m) {
  return m - 1 > 0x7FFFFFFF ? 0x7FFFFFFF : static_cast<int32_t>(m - 1);
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
        ? head_of(edge_from(__ldg(row_ptr + p), deg, u_edge[i]), col_idx,
                  last_of(m))
        : p0;
    new_alive[i] = survive ? 1 : 0;
  }
}

// ---------------------------------------------------------------- (b)

constexpr int kSlotsPerThread = 16;
constexpr int kTile = kThreads * kSlotsPerThread;  // slots a tile
// a list entry is (tile number << kTileBits | offset in the tile)
constexpr int kTileBits = 12;
static_assert(kTile == 1 << kTileBits, "a tile offset takes kTileBits");
constexpr int kBatch = 4;                          // slots a thread steps
constexpr int kWarps = kThreads / 32;
// a block steps its list of live slots once it holds kTrigger; a tile
// adds at most kTile, so the list never holds more than kList
constexpr int kTrigger = 1024;
constexpr int kList = kTrigger + kTile;
constexpr unsigned kFull = 0xFFFFFFFFu;

// bit b set where flag b of the 16 bytes in v is not 0
__device__ __forceinline__ uint32_t nonzero_bytes(uint4 v) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
  uint32_t mask = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // 0x80 in each byte of words[q] that is not 0
    const uint32_t x = words[q];
    const uint32_t hi = ((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x;
    const uint32_t bits = hi & 0x80808080u;
    mask |= ((bits >> 7) & 1u) << (4 * q) | ((bits >> 15) & 1u) << (4 * q + 1)
          | ((bits >> 23) & 1u) << (4 * q + 2)
          | ((bits >> 31) & 1u) << (4 * q + 3);
  }
  return mask;
}

// The live mask of slots first .. first + 15 (bit b: slot first + b);
// slots at or past w are dead. `vec`: the flags are 16-byte aligned and
// all 16 slots exist, so they are read with 16-byte loads.
template <typename Alive>
__device__ __forceinline__ uint32_t live_mask(const Alive* alive,
                                              long long first, long long w,
                                              bool vec);

template <>
__device__ __forceinline__ uint32_t live_mask<uint8_t>(const uint8_t* alive,
                                                       long long first,
                                                       long long w, bool vec) {
  if (vec) {
    return nonzero_bytes(*reinterpret_cast<const uint4*>(alive + first));
  }
  uint32_t mask = 0;
  for (int b = 0; b < kSlotsPerThread; ++b) {
    if (first + b < w && alive[first + b] != 0) mask |= 1u << b;
  }
  return mask;
}

template <>
__device__ __forceinline__ uint32_t live_mask<int32_t>(const int32_t* alive,
                                                       long long first,
                                                       long long w, bool vec) {
  uint32_t mask = 0;
  if (vec) {
    const int4* v = reinterpret_cast<const int4*>(alive + first);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int4 x = v[q];
      mask |= (x.x != 0 ? 1u : 0u) << (4 * q)
            | (x.y != 0 ? 1u : 0u) << (4 * q + 1)
            | (x.z != 0 ? 1u : 0u) << (4 * q + 2)
            | (x.w != 0 ? 1u : 0u) << (4 * q + 3);
    }
    return mask;
  }
  for (int b = 0; b < kSlotsPerThread; ++b) {
    if (first + b < w && alive[first + b] != 0) mask |= 1u << b;
  }
  return mask;
}

template <bool kWide>
__device__ __forceinline__ float draw(uint32_t k0, uint32_t k1,
                                      long long i) {
  if constexpr (kWide) {
    return threefry::uniform(k0, k1, static_cast<unsigned long long>(i));
  } else {
    return threefry::uniform_lo(k0, k1, static_cast<uint32_t>(i));
  }
}

// Writes -1 to the edge ids of the dead slots among first .. first + 15
// (those below w; bit b of `live` set: slot first + b is live, and its
// step writes its edge id). `vec`: 16-byte stores where all 16 are dead.
__device__ __forceinline__ void clear_edges(int32_t* __restrict__ edge,
                                            long long first, long long w,
                                            uint32_t live, bool vec) {
  if (vec && live == 0) {
    int4* v = reinterpret_cast<int4*>(edge + first);
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = make_int4(-1, -1, -1, -1);
    return;
  }
  for (int b = 0; b < kSlotsPerThread; ++b) {
    if (((live >> b) & 1u) == 0 && first + b < w) edge[first + b] = -1;
  }
}

// Alive: the flags' type, uint8_t (a torch bool tensor) or int32_t.
// kWide: w >= 2^31, so slot indices and counters are 64-bit. `edge` and
// `arrivals` may be null; `count` is read only with `arrivals`.
//
// A persistent block takes the tiles b, b + G, b + 2G, ... (G blocks) and
// packs each tile's live slots into a list in shared memory, as
// (the block's tile number << kTileBits | offset in the tile); once the list
// holds kTrigger entries or more (and after the last tile) the block steps
// them, dense, kBatch a thread at once. So a block's warps step full
// batches whatever the share of live walks, and the next tile's flags are
// loaded while a tile is packed. Dynamic shared memory: kList uint32 list
// entries, then (with `arrivals`) kList int32 staged arrivals.
template <typename Alive, bool kWide>
__global__ void __launch_bounds__(kThreads)
walk_step_inplace_kernel(int32_t* __restrict__ pos, Alive* __restrict__ alive,
                         uint32_t kt0, uint32_t kt1, uint32_t ke0,
                         uint32_t ke1, const int32_t* __restrict__ row_ptr,
                         const int32_t* __restrict__ col_idx,
                         const int32_t* __restrict__ out_deg, long long w,
                         int n, long long m, float eps, bool vec,
                         bool vec_edge, int32_t* __restrict__ edge,
                         int32_t* __restrict__ arrivals,
                         unsigned long long* __restrict__ count) {
  using Index = typename std::conditional<kWide, long long, int>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_warp[2][kWarps];
  __shared__ int s_moved;
  __shared__ unsigned long long s_base;
  uint32_t* s_list = reinterpret_cast<uint32_t*>(smem);
  int32_t* s_arr = reinterpret_cast<int32_t*>(s_list + kList);

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int32_t last = last_of(m);
  const long long tiles = (w + kTile - 1) / kTile;
  const long long step = gridDim.x;
  int listed = 0;  // entries in s_list; the same in every thread

  // the slots of packed entries e0 + 32 j + lane, j < kBatch (entry j is
  // listed where 32 j < listed - e0 - lane), and their positions
  auto load_group = [&](int e0, Index (&slot)[kBatch],
                        int32_t (&p0)[kBatch]) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = min(e0 + 32 * j + lane, listed - 1);
      const uint32_t entry = s_list[e];
      slot[j] = (static_cast<Index>(blockIdx.x) +
                 static_cast<Index>(entry >> kTileBits) *
                 static_cast<Index>(step))
                    * kTile + (entry & (kTile - 1));
      p0[j] = pos[slot[j]];
    }
  };

  // step the `listed` entries of s_list, then append the survivors' new
  // vertices to `arrivals`. A warp takes groups of 32 kBatch entries, and
  // loads the next group's positions while it draws for this one.
  auto step_list = [&]() {
    if (arrivals != nullptr && t == 0) s_moved = 0;
    __syncthreads();
    Index slot[kBatch];
    int32_t p0[kBatch];
    int e0 = warp * 32 * kBatch;
    if (e0 < listed) load_group(e0, slot, p0);
    for (; e0 < listed; e0 += kThreads * kBatch) {
      const int rest = listed - e0 - lane;  // entry j is listed: 32 j < rest
      int32_t deg[kBatch], rp[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int32_t p = min(max(p0[j], 0), n - 1);
        deg[j] = __ldg(out_deg + p);
        rp[j] = __ldg(row_ptr + p);
      }
      Index next_slot[kBatch];
      int32_t next_p0[kBatch];
      if (e0 + kThreads * kBatch < listed) {
        load_group(e0 + kThreads * kBatch, next_slot, next_p0);
      }
      float ut[kBatch], ue[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) ut[j] = draw<kWide>(kt0, kt1, slot[j]);
#pragma unroll
      for (int j = 0; j < kBatch; ++j) ue[j] = draw<kWide>(ke0, ke1, slot[j]);
      int32_t eid[kBatch], dst[kBatch];
      bool survive[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        survive[j] = 32 * j < rest && deg[j] > 0 && ut[j] >= eps;
        eid[j] = edge_from(rp[j], deg[j], ue[j]);
      }
      // the heads' gathers all in flight at once, then the writes
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        dst[j] = survive[j] ? head_of(eid[j], col_idx, last) : 0;
      }
      int moved = 0;
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const bool listed_j = 32 * j < rest;
        if (survive[j]) pos[slot[j]] = dst[j];
        if (listed_j && !survive[j]) alive[slot[j]] = 0;
        if (edge != nullptr && listed_j) {
          edge[slot[j]] = survive[j] ? eid[j] : -1;
        }
        moved += survive[j] ? 1 : 0;
      }
      if (arrivals != nullptr) {
        // the warp's survivors take consecutive entries of the staged list
        int before = moved;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int v = __shfl_up_sync(kFull, before, d);
          if (lane >= d) before += v;
        }
        int base = 0;
        if (lane == 31) base = atomicAdd(&s_moved, before);
        base = __shfl_sync(kFull, base, 31) + before - moved;
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (survive[j]) s_arr[base++] = dst[j];
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        slot[j] = next_slot[j];
        p0[j] = next_p0[j];
      }
    }
    if (arrivals != nullptr) {
      // one atomicAdd on the global count for the whole batch
      __syncthreads();
      if (t == 0 && s_moved > 0) {
        s_base = atomicAdd(count, static_cast<unsigned long long>(s_moved));
      }
      __syncthreads();
      const int moved = s_moved;
      for (int k = t; k < moved; k += kThreads) {
        arrivals[static_cast<long long>(s_base) + k] = s_arr[k];
      }
    }
    listed = 0;
  };

  long long tile = blockIdx.x;
  long long first = tile * kTile + kSlotsPerThread * t;
  uint32_t mask = tile < tiles
      ? live_mask<Alive>(alive, first, w, vec && first + kSlotsPerThread <= w)
      : 0;
  for (int k = 0; tile < tiles; ++k, tile += step) {
    // this tile's flags are in `mask`: load the next tile's now
    const long long next = tile + step;
    const long long next_first = next * kTile + kSlotsPerThread * t;
    const uint32_t next_mask = next < tiles
        ? live_mask<Alive>(alive, next_first, w,
                           vec && next_first + kSlotsPerThread <= w)
        : 0;
    if (edge != nullptr) {
      clear_edges(edge, first, w, mask,
                  vec_edge && first + kSlotsPerThread <= w);
    }
    const int mine = __popc(mask);
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) s_warp[k & 1][warp] = incl;
    __syncthreads();
    int at = listed + incl - mine, total = 0;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) {
      const int c = s_warp[k & 1][q];
      at += q < warp ? c : 0;
      total += c;
    }
    const uint32_t head = static_cast<uint32_t>(k) << kTileBits;
    for (uint32_t rest = mask; rest != 0; rest &= rest - 1) {
      s_list[at++] = head | (kSlotsPerThread * t + __ffs(rest) - 1);
    }
    listed += total;
    if (listed >= kTrigger) step_list();
    mask = next_mask;
    first = next_first;
  }
  if (listed > 0) step_list();
}

template <typename Alive, bool kWide>
cudaError_t launch_keyed(int32_t* pos, void* alive, uint32_t kt0,
                         uint32_t kt1, uint32_t ke0, uint32_t ke1,
                         const int32_t* row_ptr, const int32_t* col_idx,
                         const int32_t* out_deg, long long w, int n,
                         long long m, float eps, int32_t* edge,
                         int32_t* arrivals, long long* count, int sms,
                         cudaStream_t stream) {
  auto* kernel = walk_step_inplace_kernel<Alive, kWide>;
  // resident blocks an SM at the most shared memory (under the 48 KB a
  // block takes without opting in)
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, 2 * kList * sizeof(int32_t));
    if (err != cudaSuccess) return err;
    per_sm = per_sm < 1 ? 1 : per_sm;
  }
  const long long tiles = (w + kTile - 1) / kTile;
  const long long resident = static_cast<long long>(per_sm) * sms;
  const unsigned blocks =
      static_cast<unsigned>(tiles < resident ? tiles : resident);
  const size_t shared =
      kList * sizeof(int32_t) * (arrivals != nullptr ? 2 : 1);
  const bool vec = reinterpret_cast<uintptr_t>(alive) % 16 == 0;
  const bool vec_edge = reinterpret_cast<uintptr_t>(edge) % 16 == 0;
  kernel<<<blocks, kThreads, shared, stream>>>(
      pos, static_cast<Alive*>(alive), kt0, kt1, ke0, ke1, row_ptr, col_idx,
      out_deg, w, n, m, eps, vec, vec_edge, edge, arrivals,
      reinterpret_cast<unsigned long long*>(count));
  return cudaGetLastError();
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

// (b) in place, key words as inputs: the kernel draws its own uniforms.
// `alive` holds int32 or, with alive_bytes == 1, bytes (torch bool).
// `edge` and `arrivals` may be null; with `arrivals`, `count` (int64, set
// to 0 by the caller) receives the number of entries appended.
int walk_step_keyed_launch(int32_t* pos, void* alive, uint32_t kt0,
                           uint32_t kt1, uint32_t ke0, uint32_t ke1,
                           const int32_t* row_ptr, const int32_t* col_idx,
                           const int32_t* out_deg, long long w, int n,
                           long long m, float eps, int alive_bytes,
                           int32_t* edge, int32_t* arrivals,
                           long long* count, int sms, cudaStream_t stream) {
  if (w == 0) return 0;
  if ((alive_bytes != 1 && alive_bytes != 4)
      || (arrivals != nullptr && count == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool wide = w >= (1LL << 31);
  cudaError_t err;
  if (alive_bytes == 1) {
    err = wide ? launch_keyed<uint8_t, true>(
                     pos, alive, kt0, kt1, ke0, ke1, row_ptr, col_idx,
                     out_deg, w, n, m, eps, edge, arrivals, count, sms,
                     stream)
               : launch_keyed<uint8_t, false>(
                     pos, alive, kt0, kt1, ke0, ke1, row_ptr, col_idx,
                     out_deg, w, n, m, eps, edge, arrivals, count, sms,
                     stream);
  } else {
    err = wide ? launch_keyed<int32_t, true>(
                     pos, alive, kt0, kt1, ke0, ke1, row_ptr, col_idx,
                     out_deg, w, n, m, eps, edge, arrivals, count, sms,
                     stream)
               : launch_keyed<int32_t, false>(
                     pos, alive, kt0, kt1, ke0, ke1, row_ptr, col_idx,
                     out_deg, w, n, m, eps, edge, arrivals, count, sms,
                     stream);
  }
  return static_cast<int>(err);
}

}  // extern "C"
