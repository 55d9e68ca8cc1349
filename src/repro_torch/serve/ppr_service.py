"""Personalized-PageRank query serving: continuous batching over walk slots.

A resident `BatchedPPREngine` holds Q query slots. Each user's source
distribution is admitted into a free slot as earlier queries' walks
terminate, every `step()` advances all queries in flight with one
superstep, and completed queries land in an LRU/TTL result cache with
hot-source refresh:

  * admission: pending queries fill free slots first come, first served;
    an optional `max_pending` bound rejects excess traffic (counted in
    `stats.rejected`, never dropped silently);
  * completion: a query is done when its live-walk count reaches 0; its
    estimator vector is read once and cached;
  * cache: keyed by the canonical (sources, weights) query; a hit is
    answered at once with the stored vector (bit-identical to the compute
    that produced it). Entries expire after `ttl` seconds; a hit on an
    entry older than `refresh_age` also enqueues one background recompute
    that overwrites the entry when it completes, so hot queries stay fresh
    without blocking;
  * elasticity: `resize(shards=...)` moves the resident engine onto a
    grown or shrunk stacked mesh on the same device mid-traffic, through
    `BatchedPPREngine.relayout_from`; the cache and the pending queue
    (host side) are untouched and no query is dropped.

Time is injected (`now=`), so tests control the clock; wall time is the
default. `stats.dropped_walks` mirrors the engine's buffer overflow and
`stats.admit_dropped` its admission overflow: both must stay 0 for an
exact serving run.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.collectives import StackedMesh
from repro_torch.core.graph import CSRGraph
from repro_torch.core.personalized import normalize_query
from repro_torch.core.personalized_batch import BatchedPPREngine


def query_cache_key(sources, weights, n: int) -> Tuple:
    """Canonical cache key for a (sources, weights) query."""
    sources, weights = normalize_query(sources, weights, n)
    return (tuple(int(s) for s in sources),
            tuple(float(w) for w in weights))


@dataclasses.dataclass
class PPRRequest:
    rid: int
    sources: tuple
    weights: tuple
    t_submit: float
    refresh: bool = False          # internal hot-source refresh recompute
    t_admit: Optional[float] = None
    t_done: Optional[float] = None
    slot: Optional[int] = None
    result: Optional[np.ndarray] = None
    cached: bool = False           # answered from cache at submit time
    rejected: bool = False         # bounced by the max_pending bound
    done: bool = False

    @property
    def latency(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.t_submit


@dataclasses.dataclass
class PPRServeStats:
    submitted: int = 0
    admitted: int = 0
    completed: int = 0             # computed completions (incl. refreshes)
    cache_hits: int = 0
    refreshes: int = 0             # hot-source recomputes enqueued
    rejected: int = 0
    supersteps: int = 0
    max_active_queries: int = 0    # peak concurrently-advancing queries
    dropped_walks: int = 0         # engine buffer overflow — must stay 0
    admit_dropped: int = 0         # engine admission overflow — must stay 0
    a2a_bytes: int = 0


class ResultCache:
    """LRU + TTL cache of PPR vectors.

    `get` returns (value, needs_refresh): `value` is None on a miss or an
    expired entry (expired entries are evicted — the caller recomputes);
    `needs_refresh` flags a HIT on an entry older than `refresh_age`
    (stale-but-servable: the caller should enqueue a background refresh).
    """

    def __init__(self, max_entries: int = 256, ttl: float = math.inf,
                 refresh_age: Optional[float] = None):
        if refresh_age is not None and refresh_age >= ttl:
            raise ValueError("refresh_age must be < ttl")
        self.max_entries = int(max_entries)
        self.ttl = float(ttl)
        self.refresh_age = refresh_age
        self._d: "OrderedDict[Tuple, Tuple[np.ndarray, float]]" = \
            OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._d)

    def get(self, key: Tuple, now: float):
        entry = self._d.get(key)
        if entry is None:
            self.misses += 1
            return None, False
        value, stored_at = entry
        age = now - stored_at
        if age >= self.ttl:
            del self._d[key]
            self.misses += 1
            return None, False
        self._d.move_to_end(key)
        self.hits += 1
        needs_refresh = (self.refresh_age is not None
                         and age >= self.refresh_age)
        return value, needs_refresh

    def put(self, key: Tuple, value: np.ndarray, now: float) -> None:
        self._d[key] = (value, now)
        self._d.move_to_end(key)
        while len(self._d) > self.max_entries:
            self._d.popitem(last=False)
            self.evictions += 1

    def stored_at(self, key: Tuple) -> Optional[float]:
        entry = self._d.get(key)
        return None if entry is None else entry[1]


class PPRService:
    """The serving loop over a resident `BatchedPPREngine` on `mesh` (one
    shard on `device`, the card when None, if no mesh is given)."""

    def __init__(self, graph: CSRGraph, eps: float, *, slots: int,
                 walks_per_query: int, mesh: Optional[StackedMesh] = None,
                 cap: Optional[int] = None, cache_entries: int = 256,
                 ttl: float = math.inf, refresh_age: Optional[float] = None,
                 max_pending: Optional[int] = None,
                 key: Optional[torch.Tensor] = None, device=None):
        self.graph = graph
        self.eps = float(eps)
        self.engine = BatchedPPREngine(
            graph, eps, num_slots=slots, walks_per_query=walks_per_query,
            mesh=mesh, cap=cap, device=device)
        self._master_key = key if key is not None else prng.PRNGKey(0)
        self.engine.reset(self._master_key)
        self.cache = ResultCache(cache_entries, ttl, refresh_age)
        self.pending: "deque[PPRRequest]" = deque()
        self.max_pending = max_pending
        self._slot_req: List[Optional[PPRRequest]] = [None] * slots
        self._refreshing: set = set()   # cache keys with an in-flight refresh
        self._next_rid = 0
        self.stats = PPRServeStats()

    # ------------------------------------------------------------- queries
    @property
    def busy(self) -> bool:
        return bool(self.pending) or any(
            r is not None for r in self._slot_req)

    def submit(self, sources, weights=None, *,
               now: Optional[float] = None) -> PPRRequest:
        """Submit one query. Answered immediately from the cache when
        possible (bit-identical stored vector), else queued for a slot."""
        now = time.monotonic() if now is None else now
        srcs, wts = normalize_query(sources, weights, self.graph.n)
        req = PPRRequest(rid=self._next_rid, sources=tuple(map(int, srcs)),
                         weights=tuple(map(float, wts)), t_submit=now)
        self._next_rid += 1
        self.stats.submitted += 1

        ckey = (req.sources, req.weights)
        value, needs_refresh = self.cache.get(ckey, now)
        if value is not None:
            req.result = value
            req.cached = True
            req.done = True
            req.t_done = now
            self.stats.cache_hits += 1
            if needs_refresh and ckey not in self._refreshing:
                self._enqueue_refresh(req, now)
            return req

        if (self.max_pending is not None
                and len(self.pending) >= self.max_pending):
            req.rejected = True
            req.done = True
            self.stats.rejected += 1
            return req
        self.pending.append(req)
        self._admit_pending(now)   # take a free slot immediately if any
        return req

    def _enqueue_refresh(self, hit: PPRRequest, now: float) -> None:
        refresh = PPRRequest(rid=self._next_rid, sources=hit.sources,
                             weights=hit.weights, t_submit=now,
                             refresh=True)
        self._next_rid += 1
        self._refreshing.add((hit.sources, hit.weights))
        self.pending.append(refresh)
        self.stats.refreshes += 1

    # -------------------------------------------------------------- elastic
    def resize(self, *, shards: Optional[int] = None,
               mesh: Optional[StackedMesh] = None) -> None:
        """Rebuild the resident engine on a resized mesh, mid-traffic.

        Pass exactly one of `shards` (a stacked mesh of that many shards on
        the engine's device) or an explicit `mesh`. The new engine adopts
        the old one's live walk buffers, visit shards and telemetry
        through `BatchedPPREngine.relayout_from`, so nothing is dropped:
        cached results (host side) stay served bit-identically, queries in
        flight keep their walks and visits and finish on the new mesh, and
        the pending queue admits as before."""
        if (shards is None) == (mesh is None):
            raise ValueError("pass exactly one of shards= or mesh=")
        old = self.engine
        if mesh is None:
            mesh = StackedMesh(int(shards), old.device)
        new = BatchedPPREngine(
            self.graph, self.eps, num_slots=old.Q,
            walks_per_query=old.walks_per_query, mesh=mesh)
        new.relayout_from(old)
        self.engine = new

    # ------------------------------------------------------------- stepping
    def _admit_pending(self, now: float) -> None:
        for slot in range(self.engine.Q):
            if not self.pending or self._slot_req[slot] is not None:
                continue
            req = self.pending.popleft()
            # per-request key: independent starts/steps per rid, while a
            # fixed master key keeps a whole trace reproducible
            self.engine.admit(slot, req.sources, req.weights,
                              key=prng.fold_in(self._master_key, req.rid))
            req.slot = slot
            req.t_admit = now
            self._slot_req[slot] = req
            self.stats.admitted += 1

    def step(self, now: Optional[float] = None) -> List[PPRRequest]:
        """Admit what fits, advance every in-flight query one superstep,
        and return the requests completed by it (refreshes included)."""
        wall_clock = now is None
        now = time.monotonic() if wall_clock else now
        self._admit_pending(now)
        n_active = sum(r is not None for r in self._slot_req)
        if n_active == 0:
            return []
        self.stats.max_active_queries = max(
            self.stats.max_active_queries, n_active)
        active = self.engine.superstep()
        self.stats.supersteps += 1
        self.stats.a2a_bytes = self.engine.a2a_bytes
        self.stats.dropped_walks = self.engine.dropped
        self.stats.admit_dropped = self.engine.admit_dropped

        done: List[PPRRequest] = []
        # completion is timed after the superstep's device work
        now = time.monotonic() if wall_clock else now
        for slot, req in enumerate(self._slot_req):
            if req is None or active[slot] != 0:
                continue
            req.result = self.engine.extract(slot)
            req.done = True
            req.t_done = now
            ckey = (req.sources, req.weights)
            self.cache.put(ckey, req.result, now)
            self._refreshing.discard(ckey)
            self._slot_req[slot] = None
            self.stats.completed += 1
            done.append(req)
        return done

    def drain(self, max_steps: int = 100_000,
              now: Optional[float] = None) -> List[PPRRequest]:
        """Step until every pending/in-flight query completes."""
        done: List[PPRRequest] = []
        steps = 0
        while self.busy and steps < max_steps:
            done.extend(self.step(now=now))
            steps += 1
        return done

    def reset_stats(self) -> None:
        """Zero the traffic counters (the engine keeps running), e.g. to
        leave a warm-up out of a measured window; the cache is kept."""
        self.stats = PPRServeStats()
