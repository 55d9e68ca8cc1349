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
//
// Design: one thread per row runs the whole chain in registers, so there
// is no shared state and rows finish independently. The chain stops as
// soon as the row's count is spent or its degree is reached, and the BINV
// walk stops at the first CDF value the uniform does not clear (the CDF
// never decreases, so no later step would count); the slots left are
// zeros. Both shortcuts return exactly what the full 48-step, full-width
// evaluation returns. Only the branch a draw uses is evaluated.
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

__global__ void multinomial_rows_kernel(const int32_t* __restrict__ counts,
                                        const int32_t* __restrict__ deg,
                                        const int32_t* __restrict__ rid,
                                        int rows, uint32_t k0, uint32_t k1,
                                        float eps, int width,
                                        int32_t* __restrict__ out) {
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < rows;
       r += gridDim.x * blockDim.x) {
    const int c = counts[r];
    const int d = deg[r];
    const uint32_t id = static_cast<uint32_t>(rid[r]);
    int32_t* row = out + static_cast<long long>(r) * (width + 1);
    const int term = d > 0 ? binomial_counter(c, eps, counter_u01(id, 0, k0, k1))
                           : c;
    row[0] = term;
    int rem = c - term;
    for (int j = 0; j < width; ++j) {
      int t = 0;
      if (rem > 0 && j < d) {
        const float u = counter_u01(id, static_cast<uint32_t>(j + 1), k0, k1);
        const float p = 1.0f / static_cast<float>(d - j);
        t = min(binomial_counter(rem, p, u), rem);
        rem -= t;
      }
      row[1 + j] = t;
    }
  }
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

}  // extern "C"
