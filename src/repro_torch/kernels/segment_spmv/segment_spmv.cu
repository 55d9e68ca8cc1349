// Segment sum for Hopper (sm_90a): the power-iteration push, and the count
// engines' sums of per-edge counts per destination vertex.
//
// Replaces the TPU kernel src/repro/kernels/segment_spmv/segment_spmv.py:
// segment_spmv_pallas (body _spmv_kernel), which turned the scatter into a
// blocked one-hot matrix product on the TPU's MXU:
//   y[v] = sum of values[e] over the edges e with dst[e] == v,
// a float32 result (or, instantiated for int32, an exact integer sum).
// Ids outside [0, n) are dropped.
//
// Bound on this card: bytes. Each edge's value and id are read once (8 B)
// and each output written once (4 B): (8 E + 4 n) / HBM rate. A one-hot
// product would spend E * n operations on it, so the port scatters.
// What stands in the way is the scatter itself: E read-modify-writes at
// data-dependent addresses, most of them at a few in-degree hubs (vertex 0
// of doc_link_graph(2^20) takes 18.5% of the edges, 15 vertices 70%), and
// atomics on one address run one after another in one L2 slice. The count
// engines' flat bucketed adjacency adds its padding slots, all pointing at
// vertex 0 with a count of 0.
//
// Design: the recipe histogram.cu measured on this card.
//  * The caller passes the hot ids of dst: the table that histogram's
//    sample and hot-list passes build (2^bits slots of id + 1, 0 when
//    empty), built once for a dst that stays the same over many calls.
//  * Persistent blocks copy the table into shared memory with an
//    accumulator per slot (float64 for float values, int32 for integer
//    ones), then stream the (value, id) pairs as int4 loads of both. A hot
//    id's value goes into the block's accumulator, any other id's into
//    global memory, one lane one atomic. Integer hot values too take one
//    shared atomic a lane (the hardware absorbs a warp's lanes on one
//    address; matching equal ids across a warp first cost more than it
//    saved, PERF.md). A float64 shared
//    atomic is a compare-and-swap loop on this card, so each warp first
//    sums the float values of each hot slot among its lanes. At the end
//    each block adds its non-zero accumulators to the output: one global
//    atomic per block and hot id.
//  * A value of 0 changes no sum and is skipped, which drops the count
//    engines' padding slots and every slot that carried nothing this round.
//  * Which ids make the list changes the time only: an id left off is
//    summed in global memory.
//
// Float values are summed into a float64 scratch, then rounded once to
// float32 by a second pass over the n outputs. A hub of doc_link_graph(2**20)
// takes a million contributions, most of them one of a dozen values
// (1/(n deg) for small degrees): added one by one into a float32 sum,
// their rounding errors do not cancel but pile up, and the hub of the
// power-iteration push came out 1.5e-3 off. In float64 the sum is
// exact to far below a float32 ulp, so the result hardly depends on the
// order in which the atomics land. Integer sums are exact.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// slot of `id` in a table of 2^bits slots: histogram.cu's hash, which
// built the table
__device__ __forceinline__ unsigned slot_of(int id, int bits) {
  return (static_cast<unsigned>(id) * 0x9E3779B1u) >> (32 - bits);
}

// Returns the slot of `id`, or -1 when it is not in the table (the table
// is never full).
__device__ __forceinline__ int find(const int32_t* keys, int id, int bits) {
  const unsigned mask = (1u << bits) - 1;
  for (unsigned s = slot_of(id, bits);; s = (s + 1) & mask) {
    const int k = keys[s];
    if (k == id + 1) return static_cast<int>(s);
    if (k == 0) return -1;
  }
}

template <typename T>
__device__ __forceinline__ T from_bits(int x);
template <>
__device__ __forceinline__ float from_bits<float>(int x) {
  return __int_as_float(x);
}
template <>
__device__ __forceinline__ int32_t from_bits<int32_t>(int x) {
  return x;
}

// Calls visit(values[i], dst[i]) for every i < e across the grid, in
// whole warps: every lane of a warp makes the same calls, a lane past the
// end with (0, -1). Where both arrays start at the same offset from a
// 16-byte boundary, the whole int4s of both are read as such; the ids
// before and after them, or every id when the offsets differ, one by one.
template <typename T, class Visit>
__device__ __forceinline__ void for_each_edge(const T* __restrict__ values,
                                              const int32_t* __restrict__ dst,
                                              long long e, Visit visit) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long lanes = static_cast<long long>(gridDim.x) * blockDim.x;
  const uintptr_t off = reinterpret_cast<uintptr_t>(dst) & 15;
  long long head = e, nvec = 0;
  if ((reinterpret_cast<uintptr_t>(values) & 15) == off) {
    head = min(e, static_cast<long long>(((16 - off) & 15) >> 2));
    nvec = (e - head) >> 2;
  }
  const int4* vv = reinterpret_cast<const int4*>(values + head);
  const int4* dv = reinterpret_cast<const int4*>(dst + head);
  for (long long base = warp * 32; base < nvec; base += lanes) {
    const long long i = base + lane;
    int4 v = make_int4(0, 0, 0, 0), d = make_int4(-1, -1, -1, -1);
    if (i < nvec) {
      v = __ldg(vv + i);
      d = __ldg(dv + i);
    }
    visit(from_bits<T>(v.x), d.x);
    visit(from_bits<T>(v.y), d.y);
    visit(from_bits<T>(v.z), d.z);
    visit(from_bits<T>(v.w), d.w);
  }
  const long long rest = e - 4 * nvec;
  for (long long base = warp * 32; base < rest; base += lanes) {
    const long long k = base + lane;
    T v = T(0);
    int id = -1;
    if (k < rest) {
      const long long i = k < head ? k : k + 4 * nvec;
      v = values[i];
      id = dst[i];
    }
    visit(v, id);
  }
}

// Adds v into the block's accumulator of hot slot s (s < 0: nothing); the
// whole warp calls it. An int32 shared atomic is one instruction, and
// lanes on one address meet in the hardware.
__device__ __forceinline__ void add_hot(int32_t* sums, int s, int32_t v) {
  if (s >= 0) atomicAdd(sums + s, v);
}

// A float64 shared atomic is a compare-and-swap loop on this card
// (ATOMS.CAST.SPIN.64): lanes and warps on one address, as on a hub, take
// turns. So the warp first sums each hot slot's values, in lane order, and
// one lane adds the sum: one shared add per warp and slot.
__device__ __forceinline__ void add_hot(double* sums, int s, double v) {
  const int lane = threadIdx.x & 31;
  for (unsigned pending = __ballot_sync(kFull, s >= 0); pending;) {
    const int leader = __ffs(pending) - 1;
    const int slot = __shfl_sync(kFull, s, leader);
    const unsigned group = __ballot_sync(kFull, s == slot);
    double sum = 0.0;
    for (unsigned m = group; m; m &= m - 1)
      sum += __shfl_sync(kFull, v, __ffs(m) - 1);
    if (lane == leader) atomicAdd(sums + slot, sum);
    pending &= ~group;
  }
}

// smem: 2^bits accumulators, then the table's 2^bits keys; hot_keys ==
// nullptr means no table (every id global).
template <typename T, typename Acc>
__global__ void __launch_bounds__(kThreads, 2)
segment_sum_kernel(const T* __restrict__ values,
                   const int32_t* __restrict__ dst, long long e, int n,
                   const int32_t* __restrict__ hot_keys, int bits,
                   Acc* __restrict__ acc) {
  extern __shared__ __align__(8) unsigned char smem[];
  const int slots = hot_keys ? 1 << bits : 0;
  Acc* sums = reinterpret_cast<Acc*>(smem);
  int32_t* keys = reinterpret_cast<int32_t*>(sums + slots);
  for (int s = threadIdx.x; s < slots; s += blockDim.x) {
    sums[s] = Acc(0);
    keys[s] = hot_keys[s];
  }
  __syncthreads();
  for_each_edge(values, dst, e, [&](T v, int id) {
    const bool live =
        v != T(0) && static_cast<unsigned>(id) < static_cast<unsigned>(n);
    const int s = live && slots ? find(keys, id, bits) : -1;
    if (live && s < 0) atomicAdd(acc + id, static_cast<Acc>(v));
    add_hot(sums, s, static_cast<Acc>(v));
  });
  __syncthreads();
  for (int s = threadIdx.x; s < slots; s += blockDim.x) {
    const Acc sum = sums[s];
    if (sum != Acc(0)) atomicAdd(acc + keys[s] - 1, sum);
  }
}

__global__ void round_to_float(const double* __restrict__ acc, int n,
                               float* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    out[i] = static_cast<float>(acc[i]);
  }
}

// Dynamic shared memory above 48 KB needs the opt-in; then as many blocks
// as fit on the card, but no more than there is work for (a block takes
// at least kThreads int4s).
template <typename T, typename Acc>
cudaError_t launch_sum(const T* values, const int32_t* dst, long long e,
                       int n, const int32_t* hot_keys, int bits, Acc* acc,
                       int sms, cudaStream_t stream) {
  auto kernel = segment_sum_kernel<T, Acc>;
  const size_t smem =
      hot_keys ? (sizeof(Acc) + sizeof(int32_t)) << bits : 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long most = static_cast<long long>(per_sm) * sms;
  const long long want = (e / 4 + kThreads - 1) / kThreads;
  const int blocks =
      static_cast<int>(want < 1 ? 1 : (want < most ? want : most));
  kernel<<<blocks, kThreads, smem, stream>>>(values, dst, e, n, hot_keys,
                                             bits, acc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// scratch[0..n) must be zero on entry; out is written whole. hot_keys is a
// table of 2^bits slots, or null for none. Returns the first launch error
// (cudaError_t).
int segment_spmv_f32_launch(const float* values, const int32_t* dst,
                            long long e, int n, const int32_t* hot_keys,
                            int bits, double* scratch, float* out, int sms,
                            cudaStream_t stream) {
  if (n == 0) return 0;
  if (e > 0) {
    const cudaError_t err = launch_sum(values, dst, e, n, hot_keys, bits,
                                       scratch, sms, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int want = (n + 255) / 256;
  round_to_float<<<want < 8 * sms ? want : 8 * sms, 256, 0, stream>>>(
      scratch, n, out);
  return static_cast<int>(cudaGetLastError());
}

// out[0..n) must be zero on entry; hot_keys as above. Returns the launch's
// cudaError_t.
int segment_spmv_i32_launch(const int32_t* values, const int32_t* dst,
                            long long e, int n, const int32_t* hot_keys,
                            int bits, int32_t* out, int sms,
                            cudaStream_t stream) {
  if (e == 0 || n == 0) return 0;
  return static_cast<int>(
      launch_sum(values, dst, e, n, hot_keys, bits, out, sms, stream));
}

}  // extern "C"
