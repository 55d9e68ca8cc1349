// Segment-sum SpMV for Hopper (sm_90a): the power-iteration push.
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
// data-dependent addresses, many of them at the in-degree hubs.
//
// Design: a grid-stride loop over the edges, one edge per lane, whole warps
// in step. __match_any_sync groups the lanes with the same destination;
// in a warp where some id repeats, each group sums its values in lane
// order through full-warp shuffles, and one lane adds the sum to the
// output with one atomic. A hub hit k times by a warp costs one atomic
// instead of k.
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

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

template <typename T, typename Acc>
__global__ void segment_sum_kernel(const T* __restrict__ values,
                                   const int32_t* __restrict__ dst,
                                   long long e, int n, Acc* __restrict__ acc) {
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x) >> 5;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // the loop bound depends on the warp only, so every lane takes part in
  // every warp-wide intrinsic
  for (long long base = warp * 32; base < e; base += stride) {
    const long long i = base + lane;
    const int id = i < e ? dst[i] : -1;
    const Acc v = i < e ? static_cast<Acc>(values[i]) : Acc(0);
    const bool valid = id >= 0 && id < n;
    const unsigned peers = __match_any_sync(kFull, valid ? id : -1);
    Acc sum = v;
    // warp-uniform branch: only a warp with a repeated id sums its groups;
    // every lane runs all 32 full-warp shuffles and keeps its group's values
    if (__any_sync(kFull, valid && peers != (1u << lane))) {
      sum = Acc(0);
      for (int src = 0; src < 32; ++src) {
        const Acc w = __shfl_sync(kFull, v, src);
        if ((peers >> src) & 1u) sum += w;
      }
    }
    if (valid && lane == __ffs(peers) - 1) atomicAdd(acc + id, sum);
  }
}

__global__ void round_to_float(const double* __restrict__ acc, int n,
                               float* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    out[i] = static_cast<float>(acc[i]);
  }
}

int blocks_for(long long items, int sms) {
  long long want = (items + kThreads - 1) / kThreads;
  return static_cast<int>(want < 8LL * sms ? want : 8LL * sms);
}

}  // namespace

extern "C" {

// scratch[0..n) must be zero on entry; out is written whole. Returns the
// first launch error (cudaError_t).
int segment_spmv_f32_launch(const float* values, const int32_t* dst,
                            long long e, int n, double* scratch, float* out,
                            int sms, cudaStream_t stream) {
  if (n == 0) return 0;
  if (e > 0) {
    segment_sum_kernel<float, double>
        <<<blocks_for(e, sms), kThreads, 0, stream>>>(values, dst, e, n,
                                                      scratch);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  round_to_float<<<blocks_for(n, sms), kThreads, 0, stream>>>(scratch, n,
                                                              out);
  return static_cast<int>(cudaGetLastError());
}

// out[0..n) must be zero on entry. Returns the launch's cudaError_t.
int segment_spmv_i32_launch(const int32_t* values, const int32_t* dst,
                            long long e, int n, int32_t* out, int sms,
                            cudaStream_t stream) {
  if (e == 0 || n == 0) return 0;
  segment_sum_kernel<int32_t, int32_t>
      <<<blocks_for(e, sms), kThreads, 0, stream>>>(values, dst, e, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
