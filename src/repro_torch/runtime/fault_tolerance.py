"""Fault tolerance: checkpoint/restart, failure injection, heartbeats.

The supervisor wraps a step-function-driven engine (a sharded PageRank
superstep loop) with:

  * periodic checkpoints;
  * simulated failures: a `FailureSchedule` raises `SimulatedFailure` at
    chosen rounds, standing in for a lost host;
  * restart from the latest checkpoint. Engine state includes the PRNG
    keys, so recovery replays the identical trajectory: the recovered run
    is bit-exact with an uninterrupted one;
  * a heartbeat: rounds slower than `straggler_factor` x the running
    median are flagged.

Multi-stage engines compose per-phase step functions with `StageSchedule`
into one step function over a stage-tagged `StagedState`, whose snapshot
carries the stage tag, the stage's device buffers and the host telemetry.

Elastic resume: a `StagedState` may declare, per stage, a
`checkpoint.LayoutSpec` schema for each buffer and the shard count it was
built for. `Supervisor.run(resume=True)` compares the manifest's shard
count with the live one and, when they differ, re-lays the snapshot out
(`checkpoint.relayout_staged_flat`) before restoring it, then snapshots
the new layout at once.
"""
from __future__ import annotations

import dataclasses
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.checkpoint import (Checkpointer, pack_json,
                                    relayout_staged_flat, unpack_json)
from repro_torch.checkpoint.checkpointer import to_numpy


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureSchedule:
    """Fail at the start of each listed round (once each)."""

    fail_at_rounds: List[int]
    _fired: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, round_idx: int):
        if round_idx in self.fail_at_rounds and round_idx not in self._fired:
            self._fired.add(round_idx)
            raise SimulatedFailure(f"injected failure at round {round_idx}")


@dataclasses.dataclass
class Heartbeat:
    straggler_factor: float = 3.0
    times: List[float] = dataclasses.field(default_factory=list)
    stragglers: List[int] = dataclasses.field(default_factory=list)

    def record(self, round_idx: int, dt: float):
        self.times.append(dt)
        if len(self.times) >= 5:
            med = float(np.median(self.times))
            if dt > self.straggler_factor * med:
                self.stragglers.append(round_idx)


@dataclasses.dataclass
class Stage:
    """One named phase of a multi-stage engine.

    `step(state) -> (state, stage_done)` runs one superstep of the phase;
    `on_done(state) -> state` builds the next phase's buffers once it is
    done.
    """

    name: str
    step: Callable[[Any], Tuple[Any, bool]]
    on_done: Optional[Callable[[Any], Any]] = None


@dataclasses.dataclass
class StagedState:
    """State threaded through a `StageSchedule`: the running stage's tag,
    its buffers (name -> tensor), and JSON-able host accumulators.

    `layouts` maps stage name -> {buffer name -> `LayoutSpec`} and `shards`
    is the shard count the state was built for; together they let a
    snapshot resume at another shard count."""

    stage: str
    arrays: Dict[str, Any]
    host: Dict[str, Any]
    layouts: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=dict)
    shards: Optional[int] = None


class StageSchedule:
    """Per-phase step functions composed into ONE step function over a
    `StagedState`. The composed step reports done only when the last stage
    completes, so the supervisor's round index spans all phases."""

    def __init__(self, stages: List[Stage]):
        if not stages:
            raise ValueError("empty stage schedule")
        names = [s.name for s in stages]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stage names: {names}")
        self.stages = stages
        self._index = {s.name: i for i, s in enumerate(stages)}

    @property
    def first_stage(self) -> str:
        return self.stages[0].name

    def step(self, state: StagedState) -> Tuple[StagedState, bool]:
        i = self._index[state.stage]
        stage = self.stages[i]
        specs = state.layouts.get(state.stage)
        if specs is not None and set(specs) != set(state.arrays):
            missing = set(state.arrays) - set(specs)
            extra = set(specs) - set(state.arrays)
            raise ValueError(
                f"stage '{state.stage}' layout schema out of sync with its "
                f"buffers: uncovered buffers {sorted(missing)}, dangling "
                f"specs {sorted(extra)}")
        state, stage_done = stage.step(state)
        if not stage_done:
            return state, False
        if stage.on_done is not None:
            state = stage.on_done(state)
        if i + 1 == len(self.stages):
            return state, True
        state.stage = self.stages[i + 1].name
        return state, False


def staged_to_host(state: StagedState, mesh=None) -> dict:
    """Checkpoint payload of a `StagedState`: its buffers as host arrays,
    the stage tag and host accumulators as JSON leaves. With `mesh`, every
    buffer the stage's schema does not declare replicated is gathered
    over it into the stacked [P, ...] layout (a collective: every process
    calls it)."""
    specs = state.layouts.get(state.stage, {})

    def host(name, v):
        if mesh is not None and specs[name].kind != "replicated":
            return mesh.host_rows(v)
        return to_numpy(v)

    return dict(arrays={k: host(k, v) for k, v in state.arrays.items()},
                stage=pack_json(state.stage), host=pack_json(state.host))


def staged_from_host(flat: Dict[str, np.ndarray],
                     put: Callable[[str, np.ndarray], Any],
                     like: Optional[StagedState] = None) -> StagedState:
    """Rebuild a `StagedState` from a restored flat snapshot;
    `put(name, host_array)` places each buffer. `like` lends the layout
    schema and the live shard count."""
    arrays = {k.split("/", 1)[1]: put(k.split("/", 1)[1], v)
              for k, v in flat.items() if k.startswith("arrays/")}
    return StagedState(stage=unpack_json(flat["stage"]), arrays=arrays,
                       host=unpack_json(flat["host"]),
                       layouts=like.layouts if like is not None else {},
                       shards=like.shards if like is not None else None)


@dataclasses.dataclass
class SupervisorResult:
    state: Any
    rounds: int
    restarts: int
    checkpoints_written: int
    stragglers: List[int]


class Supervisor:
    """Generic checkpoint-restart loop.

    step_fn(state) -> (state, done: bool)
    to_host(state) -> dict              (for checkpointing)
    from_host(dict) -> state            (for recovery)
    meta_fn() -> dict                   (manifest metadata on every save; a
                                         "shards" entry enables elastic
                                         mismatch detection on resume)
    relayout(flat, old_shards) -> flat  (re-layout a snapshot written at
                                         `old_shards` onto the live mesh)
    """

    def __init__(self, step_fn: Callable, to_host: Callable,
                 from_host: Callable, checkpointer: Checkpointer, *,
                 checkpoint_every: int = 10, max_restarts: int = 16,
                 async_checkpoints: bool = False,
                 failure_schedule: Optional[FailureSchedule] = None,
                 meta_fn: Optional[Callable[[], dict]] = None,
                 relayout: Optional[Callable[[dict, int], dict]] = None):
        self.step_fn = step_fn
        self.to_host = to_host
        self.from_host = from_host
        self.ckpt = checkpointer
        self.checkpoint_every = checkpoint_every
        self.max_restarts = max_restarts
        self.async_checkpoints = async_checkpoints
        self.failures = failure_schedule
        self.meta_fn = meta_fn
        self.relayout = relayout
        self.heartbeat = Heartbeat()

    def _meta(self) -> dict:
        return self.meta_fn() if self.meta_fn is not None else {}

    def _save(self, round_idx: int, state: Any, blocking: bool = True):
        self.ckpt.save(round_idx, self.to_host(state), metadata=self._meta(),
                       blocking=blocking)

    def run(self, state: Any, *, max_rounds: int = 100_000,
            resume: bool = False) -> SupervisorResult:
        restarts = 0
        ckpts = 0
        round_idx = 0
        if resume:
            # an empty directory is an error, not a silent fresh run
            if self.ckpt.latest_step() is None:
                raise FileNotFoundError(
                    f"resume requested but no snapshots under "
                    f"{self.ckpt.base_dir}")
            flat, manifest = self.ckpt.restore()
            round_idx = int(manifest["step"])
            old_shards = (manifest.get("metadata") or {}).get("shards")
            live_shards = self._meta().get("shards")
            if (old_shards is not None and live_shards is not None
                    and int(old_shards) != int(live_shards)):
                if self.relayout is None:
                    raise ValueError(
                        f"snapshot under {self.ckpt.base_dir} was written "
                        f"at {old_shards} shards but the live mesh has "
                        f"{live_shards} and no relayout hook is configured")
                state = self.from_host(self.relayout(flat, int(old_shards)))
                # re-anchor at once: a later crash must restore the new
                # layout, not the old one
                self._save(round_idx, state)
                ckpts += 1
            else:
                state = self.from_host(flat)
        else:
            # a fresh run refuses a directory that holds snapshots: it must
            # never restore another run's state, nor destroy it
            if self.ckpt.latest_step() is not None:
                raise FileExistsError(
                    f"{self.ckpt.base_dir} already holds snapshots; pass "
                    f"resume=True to continue that run, or clear the "
                    f"directory (Checkpointer.clear()) to start fresh")
            self._save(0, state)     # recovery is always possible
            ckpts += 1
        while round_idx < max_rounds:
            t0 = time.perf_counter()
            try:
                if self.failures is not None:
                    self.failures.maybe_fail(round_idx)
                state, done = self.step_fn(state)
                round_idx += 1
            except SimulatedFailure:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                flat, manifest = self.ckpt.restore()
                state = self.from_host(flat)
                round_idx = int(manifest["step"])
                continue
            self.heartbeat.record(round_idx, time.perf_counter() - t0)
            # a finished run always leaves its final state on disk, and
            # writes it blocking: nothing overlaps a finished run
            if done or round_idx % self.checkpoint_every == 0:
                self._save(round_idx, state,
                           blocking=done or not self.async_checkpoints)
                ckpts += 1
            if done:
                break
        self.ckpt.wait()
        return SupervisorResult(state=state, rounds=round_idx,
                                restarts=restarts, checkpoints_written=ckpts,
                                stragglers=self.heartbeat.stragglers)


def run_staged(schedule: StageSchedule, state: StagedState,
               put: Callable[[str, np.ndarray], Any], *,
               checkpoint_dir: Optional[str] = None,
               fail_at: Optional[Sequence[int]] = None,
               checkpoint_every: int = 10, max_restarts: int = 16,
               resume: bool = False, max_rounds: int = 100_000,
               tmp_prefix: str = "staged_ckpt_",
               mesh=None) -> Tuple[StagedState, int, int]:
    """Drive a `StageSchedule` to completion: a plain loop when no fault
    tolerance is asked for, else under the `Supervisor` with stage-tagged
    snapshots. `put(name, host_array)` places each buffer on restore,
    from the stacked [P, ...] host layout. With `mesh`, snapshots hold
    every shard's rows gathered over it and are written once, by its
    writer. Returns (final state, restarts, checkpoints_written)."""
    if resume and checkpoint_dir is None:
        raise ValueError("resume=True needs checkpoint_dir (there is no "
                         "snapshot to cold-start from)")
    if checkpoint_dir is None and not fail_at:
        rounds, done = 0, False
        while not done and rounds < max_rounds:
            state, done = schedule.step(state)
            rounds += 1
        return state, 0, 0
    # fail_at without a directory: snapshots go to a private temporary
    # directory, made by the writer and removed by it once the run is over
    writer = mesh is None or mesh.writer
    tmp_dir = None
    if checkpoint_dir is None:
        tmp_dir = tempfile.mkdtemp(prefix=tmp_prefix) if writer else None
        if mesh is not None:
            tmp_dir = mesh.gather_objects(tmp_dir)[0]
    meta_fn = ((lambda: dict(shards=int(state.shards)))
               if state.shards is not None else None)
    relayout = None
    if state.shards is not None and state.layouts:
        live_shards, layouts = int(state.shards), state.layouts
        relayout = (lambda flat, old_shards: relayout_staged_flat(
            flat, live_shards, layouts))
    try:
        sup = Supervisor(
            schedule.step, lambda s: staged_to_host(s, mesh),
            lambda flat: staged_from_host(flat, put, like=state),
            Checkpointer(checkpoint_dir or tmp_dir, mesh=mesh),
            checkpoint_every=checkpoint_every, max_restarts=max_restarts,
            failure_schedule=FailureSchedule(list(fail_at)) if fail_at
            else None, meta_fn=meta_fn, relayout=relayout)
        res = sup.run(state, max_rounds=max_rounds, resume=resume)
    finally:
        if tmp_dir is not None and writer:
            shutil.rmtree(tmp_dir, ignore_errors=True)
    return res.state, res.restarts, res.checkpoints_written
