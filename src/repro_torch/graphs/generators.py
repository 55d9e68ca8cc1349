"""Synthetic graph generators (host-side numpy; emit CSRGraph).

Families chosen to exercise the paper's claims: low-diameter expanders,
high-diameter rings/grids (where sub-diameter running time matters),
power-law webs (congestion stress), and directed graphs for Section 5.

Each generator draws from the same `np.random.default_rng` streams as the
JAX package's, so both build identical graphs from one seed. `device`
places the result (the card when None).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import CSRGraph, from_edges


def ring(n: int, *, device=None) -> CSRGraph:
    v = np.arange(n)
    return from_edges(v, (v + 1) % n, n, undirected=True, device=device)


def grid2d(rows: int, cols: int, *, device=None) -> CSRGraph:
    n = rows * cols
    idx = np.arange(n).reshape(rows, cols)
    src = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    dst = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    return from_edges(src, dst, n, undirected=True, device=device)


def erdos_renyi(n: int, avg_deg: float, seed: int = 0, *,
                device=None) -> CSRGraph:
    """G(n, p) with p = avg_deg/n, plus a ring to guarantee connectivity."""
    rng = np.random.default_rng(seed)
    p = min(1.0, avg_deg / max(n - 1, 1))
    m_target = int(p * n * (n - 1) / 2)
    src = rng.integers(0, n, size=2 * m_target + n)
    dst = rng.integers(0, n, size=2 * m_target + n)
    keep = src != dst
    src, dst = src[keep][:m_target], dst[keep][:m_target]
    ring_v = np.arange(n)
    src = np.concatenate([src, ring_v])
    dst = np.concatenate([dst, (ring_v + 1) % n])
    return from_edges(src, dst, n, undirected=True, device=device)


def _barabasi_albert_edges(n: int, m_attach: int, seed: int):
    rng = np.random.default_rng(seed)
    m_attach = max(int(m_attach), 1)
    m0 = max(m_attach, 2)
    src_l, dst_l = [], []
    # seed clique
    for i in range(m0):
        for j in range(i + 1, m0):
            src_l.append(i)
            dst_l.append(j)
    targets = list(range(m0)) * 2
    for v in range(m0, n):
        chosen = set()
        while len(chosen) < m_attach:
            chosen.add(int(targets[rng.integers(0, len(targets))]))
        for u in chosen:
            src_l.append(v)
            dst_l.append(u)
            targets.extend([v, u])
    return np.array(src_l), np.array(dst_l)


def barabasi_albert(n: int, m_attach: int = 3, seed: int = 0, *,
                    device=None) -> CSRGraph:
    """Preferential attachment (power-law degrees) — congestion stressor."""
    src, dst = _barabasi_albert_edges(n, m_attach, seed)
    return from_edges(src, dst, n, undirected=True, device=device)


def barabasi_albert_hub(n: int, m_attach: int = 3, seed: int = 0, *,
                        device=None) -> CSRGraph:
    """Preferential attachment plus a forced hub wired to every 4th vertex:
    max degree ~ n/4 while the median degree stays ~ m_attach. The
    max_deg >> typical_deg regime is what the degree-bucketed sampler
    exists for, so this is the stress fixture for its tests."""
    base = barabasi_albert(n, m_attach, seed, device="cpu")
    _, col, deg = base.numpy()
    src = np.repeat(np.arange(base.n), deg)
    dst = col
    hub = 0
    spokes = np.arange(0, n, 4)
    spokes = spokes[spokes != hub]
    src = np.concatenate([src, np.full(len(spokes), hub)])
    dst = np.concatenate([dst, spokes])
    return from_edges(src, dst, n, undirected=True, device=device)


def random_regular(n: int, d: int, seed: int = 0, *,
                   device=None) -> CSRGraph:
    """Union of d/2 random perfect matchings-ish permutations (expander whp)."""
    rng = np.random.default_rng(seed)
    src_l, dst_l = [], []
    for _ in range(max(d // 2, 1)):
        perm = rng.permutation(n)
        src_l.append(np.arange(n))
        dst_l.append(perm)
    src = np.concatenate(src_l)
    dst = np.concatenate(dst_l)
    keep = src != dst
    return from_edges(src[keep], dst[keep], n, undirected=True,
                      device=device)


def directed_web(n: int, avg_out_deg: float = 6.0, seed: int = 0, *,
                 alpha: float = 1.8, device=None) -> CSRGraph:
    """Directed web-like graph: power-law *in*-degree attractiveness, every
    vertex has out-degree >= 1 (no dangling). Exercises Section 5."""
    rng = np.random.default_rng(seed)
    # attractiveness ∝ (rank+1)^{-alpha}
    attract = (np.arange(n) + 1.0) ** (-alpha)
    attract /= attract.sum()
    out_deg = np.maximum(1, rng.poisson(avg_out_deg, size=n))
    src = np.repeat(np.arange(n), out_deg)
    dst = rng.choice(n, size=src.shape[0], p=attract)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    # guarantee out_deg >= 1 after self-loop removal
    missing = np.setdiff1d(np.arange(n), np.unique(src))
    if len(missing):
        src = np.concatenate([src, missing])
        dst = np.concatenate([dst, (missing + 1) % n])
    return from_edges(src, dst, n, undirected=False, device=device)


def doc_link_graph(n_docs: int, seed: int = 0, *, device=None) -> CSRGraph:
    """Synthetic document citation/hyperlink graph (directed, power-law
    authority)."""
    return directed_web(n_docs, avg_out_deg=8.0, seed=seed, alpha=1.5,
                        device=device)


GENERATORS = {
    "ring": ring,
    "grid2d": grid2d,
    "erdos_renyi": erdos_renyi,
    "barabasi_albert": barabasi_albert,
    "barabasi_albert_hub": barabasi_albert_hub,
    "random_regular": random_regular,
    "directed_web": directed_web,
}
