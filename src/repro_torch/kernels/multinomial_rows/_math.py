"""Sampling math of the fused aggregate-multinomial kernel, in plain torch.

The CUDA kernel (`multinomial_rows.cu`) runs the same arithmetic per row in
registers; this module is its plain version. Every float32 operation here
is one torch operation rounded on its own, in the same order as the
kernel's (which is built without FMA contraction), so the two agree bit for
bit on the same device.

RNG contract — counter-based, per row:
  u(row, t) = u01(fmix32(fmix32((rid * C1) ^ k0) + ((t * C2) ^ k1)))
where `rid` is the caller-supplied globally-unique row id, `t` the draw
index within the row (0 = the eps-termination draw, j+1 = chain slot j),
and (k0, k1) the two uint32 words of a per-round PRNG key. Draws are pure
functions of (k0, k1, rid, t): rows sample independently in any order.

Binomial(n, p) from ONE uniform (hybrid, complement-flipped so pp <= 1/2):
  * n*pp <= 10 — BINV inverse-CDF walk (exact CDF inversion, truncated at
    `_BINV_ITERS`; the neglected tail mass is < 1e-15 at mean 10);
  * n*pp  > 10 — normal approximation with the Acklam inverse-normal.
The endpoints are EXACT in integer arithmetic: p == 0 returns 0 and
p == 1 returns n itself, which makes the conditional-binomial chain
conserve mass exactly at any count magnitude.

The uint32 hash runs in int64 masked to 32 bits (torch's uint32 lacks `+`
and `>>` on the CPU); products are split into 16-bit halves so that no
intermediate leaves int64's range.
"""
from __future__ import annotations

import torch

_BINV_ITERS = 48
_BINV_MEAN_MAX = 10.0
_M32 = 0xFFFFFFFF

_A = (-3.969683028665376e+01, 2.209460984245205e+02,
      -2.759285104469687e+02, 1.383577518672690e+02,
      -3.066479806614716e+01, 2.506628277459239e+00)
_B = (-5.447609879822406e+01, 1.615858368580409e+02,
      -1.556989798598866e+02, 6.680131188771972e+01,
      -1.328068155288572e+01)
_C = (-7.784894002430293e-03, -3.223964580411365e-01,
      -2.400758277161838e+00, -2.549732539343734e+00,
      4.374664141464968e+00, 2.938163982698783e+00)
_D = (7.784695709041462e-03, 3.224671290700398e-01,
      2.445134137142996e+00, 3.754408661907416e+00)
_PLOW = 0.02425


def _u32(x) -> torch.Tensor:
    """A uint32 value held in int64 (negative ints wrap as in uint32)."""
    return x.to(torch.int64).bitwise_and(_M32)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32), c a uint32 constant."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer: full-avalanche 32-bit hash."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def counter_u01(rid: torch.Tensor, t: int, k0: int, k1: int) -> torch.Tensor:
    """Uniform float32 in (0, 1), a pure function of (k0, k1, rid, t)."""
    h = _fmix32(_mul32(_u32(rid), 0x9E3779B1) ^ (k0 & _M32))
    h = _fmix32((h + ((int(t) * 0x85EBCA77 & _M32) ^ (k1 & _M32))) & _M32)
    # 24 mantissa bits, offset half a ulp: strictly inside (0, 1)
    return ((h >> 8).to(torch.float32) + 0.5) * 2.0 ** -24


def _horner(coefs, x: torch.Tensor) -> torch.Tensor:
    """((c0*x + c1)*x + ...) + c_last, one rounding per operation."""
    acc = coefs[0] * x
    for c in coefs[1:-1]:
        acc = (acc + c) * x
    return acc + coefs[-1]


def _ndtri(u: torch.Tensor) -> torch.Tensor:
    """Acklam's rational approximation to the inverse normal CDF."""
    u = torch.clamp(u, 1e-7, 1.0 - 1e-7)
    # central region
    q = u - 0.5
    r = q * q
    num = _horner(_A, r)
    den = _horner(_B + (1.0,), r)
    x_mid = q * num / den
    # lower tail (upper tail by symmetry)
    ul = torch.minimum(u, 1.0 - u)
    ql = torch.sqrt(-2.0 * torch.log(ul))
    x_tail = _horner(_C, ql) / _horner(_D + (1.0,), ql)
    x_tail = torch.where(u < 0.5, x_tail, -x_tail)
    tail = (u < _PLOW) | (u > 1.0 - _PLOW)
    return torch.where(tail, x_tail, x_mid)


def binomial_counter(n: torch.Tensor, p: torch.Tensor,
                     u: torch.Tensor) -> torch.Tensor:
    """X ~ Binomial(n, p) from one uniform. n int32 >= 0, p float32.

    Endpoint-exact (p==0 -> 0, p==1 -> n, in int arithmetic); hybrid
    BINV / normal elsewhere — see the module docstring.
    """
    n = n.to(torch.int32)
    n_f = n.to(torch.float32)
    p = torch.as_tensor(p, dtype=torch.float32, device=n.device)
    flip = p > 0.5
    pp = torch.where(flip, 1.0 - p, p)
    mean = n_f * pp
    small = mean <= _BINV_MEAN_MAX

    # --- BINV: count how many prefix-CDF values u clears ---
    q = pp / torch.clamp(1.0 - pp, min=0.5)       # pp <= 0.5 so 1-pp >= 0.5
    pdf = torch.exp(n_f * torch.log1p(-pp))
    cdf = pdf
    x_small = torch.zeros_like(n)
    for k in range(1, _BINV_ITERS + 1):
        # The CDF never decreases, so once u <= cdf no later step counts:
        # stopping when no row that uses BINV still clears it is exact.
        clears = u > cdf
        if not bool((clears & small).any()):
            break
        x_small = x_small + clears.to(torch.int32)
        # a device tensor, not a Python number: CUDA torch would turn
        # division by a host scalar into a multiply by its reciprocal
        kf = torch.tensor(float(k), dtype=torch.float32, device=n.device)
        pdf = pdf * ((n_f - kf + 1.0) / kf) * q
        cdf = cdf + pdf

    # --- normal approximation with continuity correction ---
    sd = torch.sqrt(torch.clamp(mean * (1.0 - pp), min=1e-12))
    x_norm = torch.floor(mean + sd * _ndtri(u) + 0.5).to(torch.int32)

    x = torch.where(small, x_small, x_norm)
    x = torch.minimum(torch.clamp(x, min=0), n)
    return torch.where(flip, n - x, x)


def sample_rows_math(counts: torch.Tensor, deg: torch.Tensor,
                     rid: torch.Tensor, k0: int, k1: int, *, eps: float,
                     width: int) -> torch.Tensor:
    """Fused termination + conditional-binomial chain for a block of rows.

    counts/deg/rid: [R] int32. Returns T [R, width+1] int32 where column 0
    is the termination count (a dangling row — deg == 0 — terminates
    whole) and column 1+j the count sent down out-edge slot j. Rows with
    deg <= width conserve mass exactly: T.sum(1) == counts.
    """
    counts = counts.to(torch.int32)
    deg = deg.to(torch.int32)
    u_t = counter_u01(rid, 0, k0, k1)
    term = torch.where(deg > 0, binomial_counter(counts, eps, u_t), counts)
    rem = counts - term
    cols = [term]
    for j in range(width):
        # Slots past a row's degree, and slots after its count ran out,
        # draw exactly 0 (p == 0 or n == 0 is endpoint-exact): once no row
        # has both, the rest of the chain is zeros.
        if not bool(((rem > 0) & (deg > j)).any()):
            cols.extend([torch.zeros_like(rem)] * (width - j))
            break
        u = counter_u01(rid, j + 1, k0, k1)
        slots = torch.clamp(deg - j, min=1).to(torch.float32)
        p = torch.where(deg > j, 1.0 / slots, 0.0)
        t = torch.minimum(binomial_counter(rem, p, u), rem)
        rem = rem - t
        cols.append(t)
    return torch.stack(cols, dim=1)


def key_words(key: torch.Tensor):
    """(k0, k1) uint32 words of a PRNG key, as Python ints."""
    k0, k1 = (int(w) & _M32 for w in key.to(torch.int64).reshape(-1)[:2])
    return k0, k1
