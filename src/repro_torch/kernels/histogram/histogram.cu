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
// read-modify-writes at data-dependent addresses, and on web graphs a large
// share of them at the same few hub vertices (a power-law in-degree sends
// about a fifth of all arrivals to vertex 0 of doc_link_graph).
//
// Design:
//  * a grid-stride loop over the ids, one id per lane, whole warps in step;
//  * warp aggregation: __match_any_sync groups the lanes that carry the
//    same id, and one lane adds the group's size. A hub that a warp hits k
//    times costs one atomic instead of k;
//  * when the n counters fit in shared memory, each block counts into its
//    own copy there and merges it into the output once at the end;
//    otherwise the groups add straight into global memory (L2 atomics).
// Integer atomics are exact, so the result is bit-exact in any order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

template <bool kShared>
__global__ void histogram_kernel(const int32_t* __restrict__ ids, long long w,
                                 int n, int32_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  int32_t* counts = kShared ? smem : out;
  if (kShared) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) smem[i] = 0;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x) >> 5;
  const long long stride = (static_cast<long long>(gridDim.x) * blockDim.x);
  // the loop bound depends on the warp only, so every lane takes part in
  // every __match_any_sync
  for (long long base = warp * 32; base < w; base += stride) {
    const long long i = base + lane;
    const int id = i < w ? ids[i] : -1;
    const bool valid = id >= 0 && id < n;
    const unsigned peers = __match_any_sync(kFull, valid ? id : -1);
    if (valid && lane == __ffs(peers) - 1) {
      atomicAdd(counts + id, __popc(peers));
    }
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      if (smem[i]) atomicAdd(out + i, smem[i]);
    }
  }
}

}  // namespace

extern "C" {

// Largest n counted in shared memory (48 KB needs no opt-in).
int histogram_shared_max() { return 48 * 1024 / 4; }

// out[0..n) must be zero on entry. Returns the launch's cudaError_t.
int histogram_launch(const int32_t* ids, long long w, int n, int32_t* out,
                     int sms, cudaStream_t stream) {
  if (w == 0 || n == 0) return 0;
  long long want = (w + kThreads - 1) / kThreads;
  if (n <= histogram_shared_max()) {
    // few blocks, so the per-block merge stays small next to the ids
    int blocks = static_cast<int>(want < 2LL * sms ? want : 2LL * sms);
    histogram_kernel<true><<<blocks, kThreads, n * sizeof(int32_t), stream>>>(
        ids, w, n, out);
  } else {
    int blocks = static_cast<int>(want < 8LL * sms ? want : 8LL * sms);
    histogram_kernel<false><<<blocks, kThreads, 0, stream>>>(ids, w, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
