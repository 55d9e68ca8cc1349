"""PageRank estimation from visit counters + error metrics."""
from __future__ import annotations

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _f64(x) -> np.ndarray:
    return _np(x).astype(np.float64)


def pagerank_from_visits(zeta, n: int, walks_per_node: int,
                         eps: float) -> np.ndarray:
    """pi_tilde_v = zeta_v * eps / (n * K)   (Algorithm 1, step 12).

    Scales on the host in float64: the integer visit counters exceed
    float32's 2**24 integer-exact range once n * walks_per_node / eps gets
    large, so a float32 cast would corrupt zeta *before* the scale."""
    return _f64(zeta) * (eps / (float(n) * float(walks_per_node)))


def normalized(pi):
    return pi / pi.sum()


def l1_error(est, ref) -> float:
    return float(np.abs(_f64(est) - _f64(ref)).sum())


def linf_error(est, ref) -> float:
    return float(np.abs(_f64(est) - _f64(ref)).max())


def max_rel_error(est, ref) -> float:
    est = _f64(est)
    ref = _f64(ref)
    return float((np.abs(est - ref) / np.maximum(ref, 1e-30)).max())


def topk_overlap(est, ref, k: int = 10) -> float:
    """|top-k(est) ∩ top-k(ref)| / k — ranking quality (PageRank's use-case)."""
    a = set(np.argsort(-_np(est))[:k].tolist())
    b = set(np.argsort(-_np(ref))[:k].tolist())
    return len(a & b) / k
