// Visit-count histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/histogram/histogram.py:
// histogram_pallas (body _hist_kernel), a blocked one-hot reduction on the
// TPU's vector units:  counts[v] = #{w : ids[w] == v},  v in [0, n).
// Ids outside [0, n), including the -1 of dead walks, are ignored.
//
// Bound on this card: bytes. Each id is read once (4 B) and each count
// written once, so the floor is (4 W + 4 n) / HBM rate; there is no
// arithmetic to speak of. What stands in the way is the scatter: W
// read-modify-writes at data-dependent addresses, and on web graphs most of
// them at a few hub vertices (on doc_link_graph vertex 0 takes a fifth of a
// round's arrivals and about a hundred vertices nine tenths). Atomics on
// one address run one after another in one L2 slice, so a hub's global
// atomics alone would set the time.
//
// Design: no hot id costs more than one global atomic per block.
//  * All-shared path, n up to the opt-in shared memory of a block (227 KB,
//    58,112 counters on the H100): each block counts into its own n
//    counters in shared memory and adds its non-zero counters to the output
//    once at the end.
//  * Hot-list path, larger n:
//     1. sample: one warp reads each 32-id chunk that starts at a multiple
//        of the sample stride (32 x 509 ids, so about 1/509 of the ids,
//        coalesced; the odd factor keeps the sample from locking onto a
//        buffer laid out with a power-of-two period, as the walk buffers
//        are) and counts it into a zeroed scratch array of n counters,
//        warp-aggregated (__match_any_sync), since the hubs' counters take
//        these atomics in L2;
//     2. hot list, two launches: the ids whose sampled count reaches a high
//        threshold (at most cap / 2 ids can), then those that reach a low
//        one while there is room, go into an open-addressing hash table of
//        2 cap slots (load <= 0.5) in global memory;
//     3. main pass: persistent blocks copy the table into shared memory with
//        a counter per slot, then stream the ids. A hot id adds into the
//        block's shared counter, any other id into global memory; at the end
//        each block adds its non-zero hot counters to the output.
//    Which ids make the list changes the time only: an id left off is
//    counted in global memory, exactly.
//  * Both main passes read the ids as int4 with streaming loads, the next
//    one issued before the current one is counted, and add one id per lane
//    with no warp aggregation: shared-memory atomics absorb a warp's lanes on
//    one address in hardware, and __match_any_sync cost more than it saved
//    (its time grows with the distinct ids in a warp).
//  * What is left for global atomics is the tail, ids that take too few hits
//    to make the list. Spread over n = 2^20 they run at the L2's atomic
//    rate, which on ids with no hub sets the time, not the bytes (PERF.md).
// Integer atomics are exact, so the result is bit-exact in any order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kSampleWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

// slot of `id` in a table of 2^bits slots (Fibonacci hashing)
__device__ __forceinline__ unsigned slot_of(int id, int bits) {
  return (static_cast<unsigned>(id) * 0x9E3779B1u) >> (32 - bits);
}

// A table slot holds id + 1, or 0 when empty. Returns the slot of `id`, or
// -1 when it is not in the table (the table is never full).
__device__ __forceinline__ int find(const int32_t* keys, int id, int bits) {
  const unsigned mask = (1u << bits) - 1;
  for (unsigned s = slot_of(id, bits);; s = (s + 1) & mask) {
    const int k = keys[s];
    if (k == id + 1) return static_cast<int>(s);
    if (k == 0) return -1;
  }
}

// Calls count(id) for every id; lanes past the end call it with -1.
template <class Count>
__device__ __forceinline__ void for_each_id(const int32_t* __restrict__ ids,
                                            long long w, Count count) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long warps = (static_cast<long long>(gridDim.x) * blockDim.x)
                          >> 5;
  // ids before the first 16-byte boundary and after the last whole int4
  const long long head = min(
      w, static_cast<long long>(
             ((16 - (reinterpret_cast<uintptr_t>(ids) & 15)) & 15) >> 2));
  const long long nvec = (w - head) >> 2;
  const int4* vec = reinterpret_cast<const int4*>(ids + head);
  const int4 none = make_int4(-1, -1, -1, -1);
  long long i = warp * 32 + lane;
  int4 v = i < nvec ? __ldcs(vec + i) : none;
  for (long long base = warp * 32; base < nvec; base += warps * 32) {
    i += warps * 32;
    const int4 next = i < nvec ? __ldcs(vec + i) : none;
    count(v.x);
    count(v.y);
    count(v.z);
    count(v.w);
    v = next;
  }
  if (warp == 0) {  // at most 3 + 3 ids
    const long long tail = head + 4 * nvec;
    const long long j = lane < 3 ? lane : tail + lane - 3;
    const bool in = lane < 3 ? j < head : (lane < 6 && j < w);
    count(in ? ids[j] : -1);
  }
}

// kAllShared: smem holds the block's n counters.
// otherwise:  smem holds the hot table's 2^bits keys, then one counter per
//             slot; hot_keys == nullptr means no table (every id global).
template <bool kAllShared>
__global__ void __launch_bounds__(kThreads, 2)
histogram_kernel(const int32_t* __restrict__ ids, long long w, int n,
                 const int32_t* __restrict__ hot_keys, int bits,
                 int32_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  const int slots = kAllShared ? n : (hot_keys ? 1 << bits : 0);
  int32_t* keys = smem;
  int32_t* counters = kAllShared ? smem : smem + slots;
  for (int s = threadIdx.x; s < slots; s += blockDim.x) {
    counters[s] = 0;
    if (!kAllShared) keys[s] = hot_keys[s];
  }
  __syncthreads();
  for_each_id(ids, w, [&](int id) {
    if (static_cast<unsigned>(id) >= static_cast<unsigned>(n)) return;
    if (kAllShared) {
      atomicAdd(counters + id, 1);
      return;
    }
    const int s = slots ? find(keys, id, bits) : -1;
    if (s >= 0) {
      atomicAdd(counters + s, 1);
    } else {
      atomicAdd(out + id, 1);
    }
  });
  __syncthreads();
  for (int s = threadIdx.x; s < slots; s += blockDim.x) {
    const int c = counters[s];
    if (c) atomicAdd(out + (kAllShared ? s : keys[s] - 1), c);
  }
}

// One warp per sampled chunk: ids [c * stride, c * stride + 32).
__global__ void __launch_bounds__(kSampleWarps * 32)
sample_kernel(const int32_t* __restrict__ ids, long long w, int n,
              long long stride, long long chunks,
              int32_t* __restrict__ sample) {
  const long long c =
      static_cast<long long>(blockIdx.x) * kSampleWarps + (threadIdx.x >> 5);
  if (c >= chunks) return;  // whole warps
  const int lane = threadIdx.x & 31;
  const long long i = c * stride + lane;
  const int id = i < w ? ids[i] : -1;
  const bool valid = static_cast<unsigned>(id) < static_cast<unsigned>(n);
  const unsigned peers = __match_any_sync(kFull, valid ? id : -1);
  if (valid && lane == __ffs(peers) - 1) atomicAdd(sample + id, __popc(peers));
}

// Puts the ids whose sampled count c has lo <= c < hi into the table of
// 2^bits >= 2 cap slots while it holds fewer than `cap`; *hot counts them
// all (it may pass cap: the rest stay off the list).
__global__ void hot_kernel(const int32_t* __restrict__ sample, int n, int lo,
                           int hi, int cap, int bits,
                           int32_t* __restrict__ keys,
                           int32_t* __restrict__ hot) {
  const unsigned mask = (1u << bits) - 1;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       v < n; v += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int id = static_cast<int>(v);
    const int c = sample[id];
    if (c < lo || c >= hi || atomicAdd(hot, 1) >= cap) continue;
    unsigned s = slot_of(id, bits);
    while (atomicCAS(keys + s, 0, id + 1) != 0) s = (s + 1) & mask;
  }
}

// Dynamic shared memory above 48 KB needs the opt-in; then as many blocks
// as fit on the card, but no more than there is work for.
template <class Kernel>
cudaError_t plan(Kernel kernel, size_t smem, int sms, long long want,
                 int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long most = static_cast<long long>(per_sm) * sms;
  *blocks = static_cast<int>(want < 1 ? 1 : (want < most ? want : most));
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Counters a block can hold in the opt-in shared memory of `device`.
int histogram_shared_max(int device, int* counters) {
  int bytes = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  *counters = bytes / static_cast<int>(sizeof(int32_t));
  return static_cast<int>(err);
}

// All-shared path. out[0..n) must be zero on entry and n at most
// histogram_shared_max. Returns a cudaError_t.
int histogram_shared_launch(const int32_t* ids, long long w, int n,
                            int32_t* out, int sms, cudaStream_t stream) {
  if (w == 0 || n == 0) return 0;
  const size_t smem = static_cast<size_t>(n) * sizeof(int32_t);
  // a block's merge adds up to n atomics, so give each block about 2 n ids
  int blocks = 0;
  cudaError_t err = plan(histogram_kernel<true>, smem, sms,
                         (w + 2LL * n - 1) / (2LL * n), &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  histogram_kernel<true><<<blocks, kThreads, smem, stream>>>(
      ids, w, n, nullptr, 0, out);
  return static_cast<int>(cudaGetLastError());
}

// Sample pass: sample[0..n) (zero on entry) counts the ids of every chunk
// of 32 that starts at a multiple of `stride`.
int histogram_sample_launch(const int32_t* ids, long long w, int n,
                            long long stride, int32_t* sample,
                            cudaStream_t stream) {
  if (w == 0 || n == 0) return 0;
  const long long chunks = (w + stride - 1) / stride;
  const long long blocks = (chunks + kSampleWarps - 1) / kSampleWarps;
  sample_kernel<<<static_cast<unsigned>(blocks), kSampleWarps * 32, 0,
                  stream>>>(ids, w, n, stride, chunks, sample);
  return static_cast<int>(cudaGetLastError());
}

// Hot-list pass: adds the ids with lo <= sampled count < hi to the table
// of 2^bits >= 2 cap slots (zero, with *hot, before the first such pass).
int histogram_hot_launch(const int32_t* sample, int n, int lo, int hi,
                         int cap, int bits, int32_t* keys, int32_t* hot,
                         int sms, cudaStream_t stream) {
  if (n == 0) return 0;
  const int want = (n + 255) / 256;
  const int blocks = want < 8 * sms ? want : 8 * sms;
  hot_kernel<<<blocks, 256, 0, stream>>>(sample, n, lo, hi, cap, bits, keys,
                                         hot);
  return static_cast<int>(cudaGetLastError());
}

// Main pass of the hot-list path. out[0..n) must be zero on entry; keys is
// the hot-list pass's table of 2^bits slots, or null for none.
int histogram_global_launch(const int32_t* ids, long long w, int n,
                            const int32_t* keys, int bits, int32_t* out,
                            int sms, cudaStream_t stream) {
  if (w == 0 || n == 0) return 0;
  const size_t smem = keys ? (sizeof(int32_t) * 2) << bits : 0;
  int blocks = 0;
  cudaError_t err = plan(histogram_kernel<false>, smem, sms,
                         (w / 4 + kThreads - 1) / kThreads, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  histogram_kernel<false><<<blocks, kThreads, smem, stream>>>(
      ids, w, n, keys, bits, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
