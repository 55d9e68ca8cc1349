// Fused aggregate-multinomial sampler for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/multinomial_rows/multinomial_rows.py:
// multinomial_rows_pallas (body _mn_kernel -> _math.sample_rows_math),
// which evaluated every row's chain as vector operations over a block of
// rows in VMEM. Per row (count c, degree d, row id, key words k0 k1):
//   term ~ Bin(c, eps) (a row with d == 0 terminates whole), then the
//   conditional-binomial chain t_j ~ Bin(rem, 1/(d - j)) for j < width.
// Each Binomial takes one counter-hash uniform: the BINV inverse-CDF walk
// (at most 48 steps) when the mean is <= 10, else a normal approximation
// with Acklam's inverse normal CDF. p == 0 and p == 1 are exact, so every
// row with d <= width conserves its count exactly. Output T[r, 0] is the
// termination count, T[r, 1 + j] the count sent down out-edge slot j.
//
// Bound on this card: bytes, with a long dependent chain per row. A row
// reads 12 B and writes 4 (width + 1) B; its arithmetic is a few dozen
// float and integer operations per draw, far below the card's rate. The
// cost that remains is latency: each draw depends on the previous one.
// The fused entry reads 4 B of the permutation a slot and 12 B a row, and
// writes 4 B a per-edge word.
//
// Design: one thread per row runs the whole chain in registers, so there
// is no shared state and rows finish independently. The chain stops as
// soon as the row's count is spent or its degree is reached, and the BINV
// walk stops at the first CDF value the uniform does not clear (the CDF
// never decreases, so no later step would count); the slots left are
// zeros. Both shortcuts return exactly what the full 48-step, full-width
// evaluation returns. Only the branch a draw uses is evaluated.
//
// Two entry points share that chain:
//  * multinomial_rows_launch, the counterpart of the TPU kernel: the rows
//    of one degree bucket in, T[R, width + 1] out;
//  * multinomial_buckets_launch, a whole round of the degree-bucketed
//    sampler in one launch. Its Python caller issued six calls of the
//    first entry a round, each wrapped in a dozen gathers, selects and
//    reductions, then copied the per-edge columns into one flat tensor:
//    some 80 short launches, which set the round's time, not the draws.
//    Here one thread takes one slot s of the bucket-grouped permutation,
//    gathers its row's count, degree and id itself (perm[s] = -1 is a
//    padding slot: zeros), finds its bucket b in the per-bucket table,
//    and writes its width(b) edge counts straight to their place in the
//    flat per-edge layout of the bucketed adjacency:
//        i = s - row_start(b),  p = i / cap(b)  (the shard; cap is one
//        shard's slots of the bucket, the shards' slots follow each other;
//        0 with one shard),
//        word = p * shard_edges + edge_start(b) + (i - p cap(b)) width(b).
//    The termination count is not stored. A warp whose 32 rows write one
//    run of 32 width words (one bucket, one shard, width <= 32) stages
//    its rows in shared memory and stores the run with neighbouring lanes
//    on neighbouring words; any other warp stores each row where it goes.
//    Each block counts its rows that hold coupons per bucket and sums the
//    rows' leftover counts (c minus all it drew, which must be 0) in
//    shared memory, then adds them to the outputs with one atomic per
//    bucket and block.
//    Its dense-cell mode (cell_width = md + 1 > 0) is the Phase-1 sampler
//    of the three-phase engines: the same draws, but each slot writes its
//    row r's whole outcome block to cells[r * cell_width + k], k = 0 the
//    termination count, k = 1 + j the count on out-edge j, and zeros from
//    width(b) + 1 to md; padding slots write nothing. Rows are (home,
//    vertex) pairs there and every owner shard draws under its own round
//    key, so shard_keys, when given, holds the key words of each shard p
//    (the p of the slot arithmetic above) in place of (k0, k1).
//
// Bit-exactness with the plain torch version on the same card: the hash is
// native uint32 arithmetic; the float chain is built with --fmad=false and
// without fast math, so every operation rounds on its own as each torch
// operation does, in the same order, through the same libdevice functions
// (expf, log1pf, logf, sqrtf). Constants are the double literals of the
// reference rounded once to float.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBinvIters = 48;
constexpr unsigned kFull = 0xffffffffu;
// the fused entry: threads a block, most buckets, widest staged row
constexpr int kBucketThreads = 256;
constexpr int kMaxBuckets = 32;
constexpr int kStageWidth = 32;

#define F(x) static_cast<float>(x)

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float counter_u01(uint32_t rid, uint32_t t,
                                             uint32_t k0, uint32_t k1) {
  uint32_t h = fmix32((rid * 0x9E3779B1u) ^ k0);
  h = fmix32(h + ((t * 0x85EBCA77u) ^ k1));
  // 24 mantissa bits, offset half a ulp: strictly inside (0, 1)
  return (static_cast<float>(h >> 8) + 0.5f) * F(5.9604644775390625e-08);
}

__device__ float ndtri(float u) {
  u = fminf(fmaxf(u, F(1e-7)), F(1.0 - 1e-7));
  const bool tail = (u < F(0.02425)) || (u > F(1.0 - 0.02425));
  if (!tail) {
    const float q = u - 0.5f;
    const float r = q * q;
    float num = F(-3.969683028665376e+01) * r;
    num = (num + F(2.209460984245205e+02)) * r;
    num = (num + F(-2.759285104469687e+02)) * r;
    num = (num + F(1.383577518672690e+02)) * r;
    num = (num + F(-3.066479806614716e+01)) * r;
    num = num + F(2.506628277459239e+00);
    float den = F(-5.447609879822406e+01) * r;
    den = (den + F(1.615858368580409e+02)) * r;
    den = (den + F(-1.556989798598866e+02)) * r;
    den = (den + F(6.680131188771972e+01)) * r;
    den = (den + F(-1.328068155288572e+01)) * r;
    den = den + 1.0f;
    return q * num / den;
  }
  const float ul = fminf(u, 1.0f - u);
  const float ql = sqrtf(-2.0f * logf(ul));
  float num = F(-7.784894002430293e-03) * ql;
  num = (num + F(-3.223964580411365e-01)) * ql;
  num = (num + F(-2.400758277161838e+00)) * ql;
  num = (num + F(-2.549732539343734e+00)) * ql;
  num = (num + F(4.374664141464968e+00)) * ql;
  num = num + F(2.938163982698783e+00);
  float den = F(7.784695709041462e-03) * ql;
  den = (den + F(3.224671290700398e-01)) * ql;
  den = (den + F(2.445134137142996e+00)) * ql;
  den = (den + F(3.754408661907416e+00)) * ql;
  den = den + 1.0f;
  const float x = num / den;
  return u < 0.5f ? x : -x;
}

// X ~ Binomial(n, p) from the one uniform u; n >= 0.
__device__ int binomial_counter(int n, float p, float u) {
  const float n_f = static_cast<float>(n);
  const bool flip = p > 0.5f;
  const float pp = flip ? 1.0f - p : p;
  const float mean = n_f * pp;
  int x = 0;
  if (mean <= 10.0f) {
    const float q = pp / fmaxf(1.0f - pp, 0.5f);
    float pdf = expf(n_f * log1pf(-pp));
    float cdf = pdf;
    for (int k = 1; k <= kBinvIters && u > cdf; ++k) {
      x += 1;
      const float kf = static_cast<float>(k);
      pdf = pdf * ((n_f - kf + 1.0f) / kf) * q;
      cdf = cdf + pdf;
    }
  } else {
    const float sd = sqrtf(fmaxf(mean * (1.0f - pp), F(1e-12)));
    x = static_cast<int>(floorf(mean + sd * ndtri(u) + 0.5f));
  }
  x = min(max(x, 0), n);
  return flip ? n - x : x;
}

// Draws the row's termination (returned) and its chain over `width`
// slots, slot j's count into moves[j]; *left is the count no slot took.
__device__ __forceinline__ int sample_row(int c, int d, uint32_t id,
                                          uint32_t k0, uint32_t k1,
                                          float eps, int width,
                                          int32_t* moves, int* left) {
  const int term = d > 0 ? binomial_counter(c, eps, counter_u01(id, 0, k0, k1))
                         : c;
  int rem = c - term;
  for (int j = 0; j < width; ++j) {
    int t = 0;
    if (rem > 0 && j < d) {
      const float u = counter_u01(id, static_cast<uint32_t>(j + 1), k0, k1);
      const float p = 1.0f / static_cast<float>(d - j);
      t = min(binomial_counter(rem, p, u), rem);
      rem -= t;
    }
    moves[j] = t;
  }
  *left = rem;
  return term;
}

__global__ void multinomial_rows_kernel(const int32_t* __restrict__ counts,
                                        const int32_t* __restrict__ deg,
                                        const int32_t* __restrict__ rid,
                                        int rows, uint32_t k0, uint32_t k1,
                                        float eps, int width,
                                        int32_t* __restrict__ out) {
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < rows;
       r += gridDim.x * blockDim.x) {
    int32_t* row = out + static_cast<long long>(r) * (width + 1);
    int left = 0;
    row[0] = sample_row(counts[r], deg[r], static_cast<uint32_t>(rid[r]), k0,
                        k1, eps, width, row + 1, &left);
  }
}

// The fused entry's per-bucket table (see the header), passed by value and
// read in place from the kernel's parameter space (__grid_constant__).
// Slots are counted in int: perm has fewer than 2^31.
struct BucketTable {
  long long edge_start[kMaxBuckets];
  int row_start[kMaxBuckets];
  int cap[kMaxBuckets];
  int width[kMaxBuckets];
  int buckets;
  int shards;
  int slots;
  long long shard_edges;
};

__global__ void __launch_bounds__(kBucketThreads)
multinomial_buckets_kernel(const int32_t* __restrict__ perm,
                           const int32_t* __restrict__ counts,
                           const int32_t* __restrict__ deg,
                           const int32_t* __restrict__ rid, int n_rows,
                           uint32_t k0, uint32_t k1, float eps,
                           const __grid_constant__ BucketTable tbl,
                           const uint32_t* __restrict__ shard_keys,
                           int cell_width, int32_t* __restrict__ moves,
                           int32_t* __restrict__ cells,
                           int32_t* __restrict__ occupancy,
                           unsigned long long* __restrict__ residual) {
  __shared__ int occ[kMaxBuckets];
  __shared__ unsigned long long left_sum;
  // a staged row of width w takes w + 1 words when w is even, so that the
  // lanes' rows start in different banks
  __shared__ int32_t stage[kBucketThreads / 32][32 * (kStageWidth + 1)];
  if (threadIdx.x < kMaxBuckets) occ[threadIdx.x] = 0;
  if (threadIdx.x == 0) left_sum = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long slot =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool valid = slot < tbl.slots;
  const int s = static_cast<int>(valid ? slot : 0);
  int b = 0, w = 0, c = 0, d = 0, row = -1;
  uint32_t id = 0, kk0 = k0, kk1 = k1;
  long long word = 0;
  if (valid) {
    while (b + 1 < tbl.buckets && s >= tbl.row_start[b + 1]) ++b;
    w = tbl.width[b];
    int i = s - tbl.row_start[b];
    int p = 0;
    if (tbl.shards > 1) {
      p = i / tbl.cap[b];
      i -= p * tbl.cap[b];
    }
    word = p * tbl.shard_edges + tbl.edge_start[b] +
           static_cast<long long>(i) * w;
    if (shard_keys != nullptr) {
      kk0 = shard_keys[2 * p];
      kk1 = shard_keys[2 * p + 1];
    }
    const int r = perm[s];
    if (r >= 0) {
      row = min(r, n_rows - 1);
      c = counts[row];
      d = deg[row];
      id = static_cast<uint32_t>(rid[row]);
    }
  }
  // every lane of the warp reaches the shuffles: nothing above returns
  const long long word0 = __shfl_sync(kFull, word, 0);
  const int w0 = __shfl_sync(kFull, w, 0);
  const bool staged = __all_sync(
      kFull, cell_width == 0 && valid && w == w0 && w <= kStageWidth &&
                 word == word0 + static_cast<long long>(lane) * w);
  const int stride = w0 | 1;
  int32_t* warp_stage = stage[threadIdx.x >> 5];
  int left = 0;
  if (valid && cell_width > 0) {
    if (row >= 0) {
      int32_t* out = cells + static_cast<long long>(row) * cell_width;
      out[0] = sample_row(c, d, id, kk0, kk1, eps, w, out + 1, &left);
      for (int k = w + 1; k < cell_width; ++k) out[k] = 0;
    }
    if (c > 0) atomicAdd(occ + b, 1);
  } else if (valid) {
    sample_row(c, d, id, kk0, kk1, eps, w,
               staged ? warp_stage + lane * stride : moves + word, &left);
    if (c > 0) atomicAdd(occ + b, 1);
  }
  if (staged) {
    __syncwarp();
    // word e of the run is word j of row r; e < 32 * 32, so a 16-bit
    // reciprocal divides exactly
    const unsigned inv = (65535u + static_cast<unsigned>(w0)) /
                         static_cast<unsigned>(w0);
    for (int e = lane; e < 32 * w0; e += 32) {
      const int r = static_cast<int>((static_cast<unsigned>(e) * inv) >> 16);
      moves[word0 + e] = warp_stage[r * stride + e - r * w0];
    }
  }
  long long l = left;
  for (int o = 16; o > 0; o >>= 1) l += __shfl_down_sync(kFull, l, o);
  if (lane == 0 && l != 0)
    atomicAdd(&left_sum, static_cast<unsigned long long>(l));
  __syncthreads();
  if (threadIdx.x < tbl.buckets && occ[threadIdx.x] != 0)
    atomicAdd(occupancy + threadIdx.x, occ[threadIdx.x]);
  if (threadIdx.x == 0 && left_sum != 0) atomicAdd(residual, left_sum);
}

}  // namespace

extern "C" {

// Writes out[rows, width + 1]. Returns the launch's cudaError_t.
int multinomial_rows_launch(const int32_t* counts, const int32_t* deg,
                            const int32_t* rid, int rows, uint32_t k0,
                            uint32_t k1, float eps, int width, int32_t* out,
                            int sms, cudaStream_t stream) {
  if (rows == 0) return 0;
  int want = (rows + kThreads - 1) / kThreads;
  int blocks = want < 16 * sms ? want : 16 * sms;
  multinomial_rows_kernel<<<blocks, kThreads, 0, stream>>>(
      counts, deg, rid, rows, k0, k1, eps, width, out);
  return static_cast<int>(cudaGetLastError());
}

// One round of the degree-bucketed sampler: moves[shards * shard_edges]
// (written whole), occupancy[buckets] and *residual (both zero on entry)
// as the header says. Bucket b holds the slots [row_start[b],
// row_start[b] + shards * cap[b]) of perm[slots], slots < 2^31. With
// cell_width > 0 it writes cells[n_rows * cell_width] (the rows of the
// slots, zeroed on entry for rows no slot names) and not moves, with
// shard_keys[2 * shards] (or null) the key words of each shard. Returns a
// cudaError_t.
int multinomial_buckets_launch(const int32_t* perm, const int32_t* counts,
                               const int32_t* deg, const int32_t* rid,
                               int n_rows, uint32_t k0, uint32_t k1, float eps,
                               int buckets, const long long* row_start,
                               const long long* edge_start, const int* cap,
                               const int* width, int shards,
                               long long shard_edges, long long slots,
                               const uint32_t* shard_keys, int cell_width,
                               int32_t* moves, int32_t* cells,
                               int32_t* occupancy,
                               unsigned long long* residual,
                               cudaStream_t stream) {
  if (slots == 0) return 0;
  if (buckets < 1 || buckets > kMaxBuckets || shards < 1 ||
      slots >= (1LL << 31) || cell_width < 0)
    return cudaErrorInvalidValue;
  BucketTable tbl = {};
  for (int b = 0; b < buckets; ++b) {
    tbl.row_start[b] = static_cast<int>(row_start[b]);
    tbl.edge_start[b] = edge_start[b];
    tbl.cap[b] = cap[b];
    tbl.width[b] = width[b];
  }
  tbl.buckets = buckets;
  tbl.shards = shards;
  tbl.slots = static_cast<int>(slots);
  tbl.shard_edges = shard_edges;
  const long long blocks = (slots + kBucketThreads - 1) / kBucketThreads;
  multinomial_buckets_kernel<<<static_cast<unsigned>(blocks), kBucketThreads,
                               0, stream>>>(perm, counts, deg, rid, n_rows, k0,
                                            k1, eps, tbl, shard_keys,
                                            cell_width, moves, cells,
                                            occupancy, residual);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
