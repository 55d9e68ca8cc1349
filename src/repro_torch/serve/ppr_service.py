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
    grown or shrunk mesh mid-traffic, through the engine's `host_state`
    and `adopt`; the cache and the pending queue (host side) are
    untouched and no query is dropped.

Time is injected (`now=`), so tests control the clock; wall time is the
default. `stats.dropped_walks` mirrors the engine's buffer overflow and
`stats.admit_dropped` its admission overflow: both must stay 0 for an
exact serving run.

One shard per process (`ProcessGroupMesh`): every process runs the same
serving loop, SPMD, and makes every call in the same order. What decides the
slot map, the pending queue or a cache hit is the same on each: the
engine's live walks come out of a psum, the wall clock is rank 0's
`time.monotonic()`, broadcast once a reading (`now=None`), and every
process keeps the cache's keys and stored-at times. The vectors live on
rank 0 (the writer) only: on the other processes `req.result` is None,
for a computed query as for a cache hit, and the cache holds None in
their place. `resize(shards=k)` is entered by every process of the
world and moves the engine onto the group of the first k ranks, as the
JAX service takes the first k devices; the processes outside it stop
serving (`serving` is False: `submit`, `step`, `drain` and `busy`
raise there) until a later `resize` takes them back, when rank 0 hands
them its host state (pending queue, slot map, statistics, cache keys and
times, next request id, master key) and the engine's in one object
broadcast. Requests they held from before stay as they were.
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
from repro_torch.core.collectives import ProcessGroupMesh, StackedMesh
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
        _, value, needs_refresh = self.lookup(key, now)
        return value, needs_refresh

    def lookup(self, key: Tuple, now: float):
        """(hit, value, needs_refresh): as `get`, with the hit apart from
        the value, which may be a stored None (a process that keeps the
        keys and times but not the vectors)."""
        entry = self._d.get(key)
        if entry is None:
            self.misses += 1
            return False, None, False
        value, stored_at = entry
        age = now - stored_at
        if age >= self.ttl:
            del self._d[key]
            self.misses += 1
            return False, None, False
        self._d.move_to_end(key)
        self.hits += 1
        needs_refresh = (self.refresh_age is not None
                         and age >= self.refresh_age)
        return True, value, needs_refresh

    def put(self, key: Tuple, value: np.ndarray, now: float) -> None:
        self._d[key] = (value, now)
        self._d.move_to_end(key)
        while len(self._d) > self.max_entries:
            self._d.popitem(last=False)
            self.evictions += 1

    def stored_at(self, key: Tuple) -> Optional[float]:
        entry = self._d.get(key)
        return None if entry is None else entry[1]

    def times(self) -> list:
        """[(key, stored_at)] in LRU order, oldest first."""
        return [(k, t) for k, (_, t) in self._d.items()]

    def host_state(self) -> dict:
        """The keys, stored-at times and counters, without the vectors."""
        return dict(times=self.times(), hits=self.hits, misses=self.misses,
                    evictions=self.evictions)

    def adopt_keys(self, host: dict) -> None:
        """Take over another cache's `host_state`, holding None for each
        vector."""
        self._d = OrderedDict((k, (None, t)) for k, t in host["times"])
        self.hits, self.misses = host["hits"], host["misses"]
        self.evictions = host["evictions"]


class PPRService:
    """The serving loop over a resident `BatchedPPREngine` on `mesh` (one
    shard on `device`, the card when None, if no mesh is given): a
    `StackedMesh`, or a `ProcessGroupMesh` of the whole world, every
    process running the same serving loop."""

    # the host state a process taken back by `resize` receives
    HOST_FIELDS = ("pending", "_slot_req", "_refreshing", "_next_rid",
                   "stats")

    def __init__(self, graph: CSRGraph, eps: float, *, slots: int,
                 walks_per_query: int, mesh=None,
                 cap: Optional[int] = None, cache_entries: int = 256,
                 ttl: float = math.inf, refresh_age: Optional[float] = None,
                 max_pending: Optional[int] = None,
                 key: Optional[torch.Tensor] = None, device=None):
        self.graph = graph
        self.eps = float(eps)
        self.engine: Optional[BatchedPPREngine] = BatchedPPREngine(
            graph, eps, num_slots=slots, walks_per_query=walks_per_query,
            mesh=mesh, cap=cap, device=device)
        # one shard per process (a recording mesh's wrapped mesh included)
        self._ranks = isinstance(getattr(self.engine.mesh, "inner",
                                         self.engine.mesh), ProcessGroupMesh)
        self._device = self.engine.device
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
    def serving(self) -> bool:
        """Whether this process holds a shard of the engine (False on a
        process a `resize` left out of the group)."""
        return self.engine is not None

    def _engine(self) -> BatchedPPREngine:
        if self.engine is None:
            raise RuntimeError("this process is not serving: a resize left "
                               "it out of the engine's group")
        return self.engine

    def _clock(self, now: Optional[float]) -> float:
        """`now`, or the wall clock: rank 0's, the same on every process."""
        if now is not None:
            return now
        return self._engine().mesh.broadcast_object(time.monotonic())

    @property
    def busy(self) -> bool:
        self._engine()
        return bool(self.pending) or any(
            r is not None for r in self._slot_req)

    def submit(self, sources, weights=None, *,
               now: Optional[float] = None) -> PPRRequest:
        """Submit one query. Answered immediately from the cache when
        possible (bit-identical stored vector), else queued for a slot."""
        now = self._clock(now)
        srcs, wts = normalize_query(sources, weights, self.graph.n)
        req = PPRRequest(rid=self._next_rid, sources=tuple(map(int, srcs)),
                         weights=tuple(map(float, wts)), t_submit=now)
        self._next_rid += 1
        self.stats.submitted += 1

        ckey = (req.sources, req.weights)
        hit, value, needs_refresh = self.cache.lookup(ckey, now)
        if hit:
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
    def resize(self, *, shards: Optional[int] = None, mesh=None,
               leave: bool = False) -> None:
        """Rebuild the resident engine on a resized mesh, mid-traffic.

        Pass exactly one of `shards` (a stacked mesh of that many shards on
        the engine's device; over a process group, the group of the first
        `shards` ranks of the world) or an explicit `mesh`. The new engine
        adopts the old one's live walk buffers, visit shards and telemetry
        (`BatchedPPREngine.host_state` and `adopt`), so nothing is dropped:
        cached results (host side) stay served bit-identically, queries in
        flight keep their walks and visits and finish on the new mesh, and
        the pending queue admits as before.

        Over a process group every process of the world calls it: the old
        group's processes all take part in reading the old state, and
        `dist.new_group` is collective. With an explicit `mesh` (a
        `ProcessGroupMesh` of the first k ranks, on its processes) the
        processes outside it pass `leave=True`."""
        if self._ranks:
            return self._resize_ranks(shards, mesh, leave)
        if (shards is None) == (mesh is None) or leave:
            raise ValueError("pass exactly one of shards= or mesh=")
        old = self.engine
        if mesh is None:
            mesh = StackedMesh(int(shards), old.device)
        new = BatchedPPREngine(
            self.graph, self.eps, num_slots=old.Q,
            walks_per_query=old.walks_per_query, mesh=mesh)
        new.relayout_from(old)
        self.engine = new

    def _resize_ranks(self, shards, mesh, leave) -> None:
        import torch.distributed as dist
        if [shards is not None, mesh is not None, leave].count(True) != 1:
            raise ValueError("pass exactly one of shards=, mesh= or "
                             "leave=True")
        world = dist.get_world_size()
        if shards is not None:
            if not 1 <= int(shards) <= world:
                raise ValueError(f"shards={shards} outside the world of "
                                 f"{world} processes")
            group = dist.new_group(list(range(int(shards))))
            if dist.get_rank() < int(shards):
                mesh = ProcessGroupMesh(group=group, device=self._device)
        elif mesh is not None:
            ranks = (list(range(world)) if mesh.group is None
                     else dist.get_process_group_ranks(mesh.group))
            if ranks != list(range(mesh.shards)):
                raise ValueError(f"a resized service's group must hold the "
                                 f"first {mesh.shards} ranks of the world, "
                                 f"not {ranks}")
        old = self.engine
        host = old.host_state() if old is not None else None
        self.engine = None
        if mesh is None:
            return
        if old is None or mesh.shards > old.shards:
            # processes taken back: rank 0's host state, engine's included
            mine = None
            if mesh.writer:
                mine = {name: getattr(self, name)
                        for name in self.HOST_FIELDS}
                # (the key's words as numpy: torch pickles no uint32)
                mine.update(cache=self.cache.host_state(), engine=host,
                            master_key=self._master_key.numpy().copy())
            got = mesh.broadcast_object(mine)
            if old is None:
                for name in self.HOST_FIELDS:
                    setattr(self, name, got[name])
                self._master_key = torch.from_numpy(got["master_key"])
                self.cache.adopt_keys(got["cache"])
                host = got["engine"]
        new = BatchedPPREngine(
            self.graph, self.eps, num_slots=len(self._slot_req),
            walks_per_query=host["walks_per_query"], mesh=mesh)
        new.adopt(host)
        self.engine = new

    # ------------------------------------------------------------- stepping
    def _admit_pending(self, now: float) -> None:
        engine = self._engine()
        for slot in range(engine.Q):
            if not self.pending or self._slot_req[slot] is not None:
                continue
            req = self.pending.popleft()
            # per-request key: independent starts/steps per rid, while a
            # fixed master key keeps a whole trace reproducible
            engine.admit(slot, req.sources, req.weights,
                         key=prng.fold_in(self._master_key, req.rid))
            req.slot = slot
            req.t_admit = now
            self._slot_req[slot] = req
            self.stats.admitted += 1

    def step(self, now: Optional[float] = None) -> List[PPRRequest]:
        """Admit what fits, advance every in-flight query one superstep,
        and return the requests completed by it (refreshes included)."""
        engine = self._engine()
        wall_clock = now is None
        now = self._clock(now)
        self._admit_pending(now)
        n_active = sum(r is not None for r in self._slot_req)
        if n_active == 0:
            return []
        self.stats.max_active_queries = max(
            self.stats.max_active_queries, n_active)
        active = engine.superstep()
        self.stats.supersteps += 1
        self.stats.a2a_bytes = engine.a2a_bytes
        self.stats.dropped_walks = engine.dropped
        self.stats.admit_dropped = engine.admit_dropped

        done: List[PPRRequest] = []
        # completion is timed after the superstep's device work
        now = self._clock(None) if wall_clock else now
        for slot, req in enumerate(self._slot_req):
            if req is None or active[slot] != 0:
                continue
            vec = engine.extract(slot)       # every process gathers it
            req.result = vec if engine.mesh.writer else None
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
