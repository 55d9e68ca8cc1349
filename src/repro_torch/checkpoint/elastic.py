"""Elastic re-layout: resume a sharded engine's snapshot at another shard
count.

Engine state is mesh-shaped, so changing the shard count P repartitions
it. Every buffer is one of a few layout kinds, declared per stage by the
engine as a `LayoutSpec` schema; `relayout_arrays` is the schema-driven
repartitioner that the supervisor routes a resumed snapshot through when
the manifest's shard count differs from the live mesh's:

  ``walk``            [P, cap] lanes of global vertex ids (-1 = empty).
                      Live walks are re-bucketed by their new owner and
                      packed in sorted order, so the layout is canonical
                      (P -> P' -> P is bit-exact). The per-shard cap grows
                      past the declared target when one shard needs it.
  ``walk_aux``        a companion lane of a ``walk`` buffer (the query-id
                      lane of the batched PPR engine), declared by the
                      primary's ``aux=(name, ...)``. It follows the
                      primary's placement slot for slot; the canonical
                      order sorts by vertex, then by the aux lanes.
  ``vertex``          [P, n_loc, *rest] vertex-sharded values: flatten,
                      cut the old padding at n, re-pad, re-split.
  ``key``             [P, 2] per-shard PRNG keys, re-derived by
                      `derive_shard_keys`: the resumed trajectory is fresh
                      (statistically the same), not a replay.
  ``replicated_key``  [P, 2] with the same key in every row (the count
                      engine's layout-free RNG): row 0 is tiled to P', so
                      its per-vertex counter draws continue bit-exactly.
  ``replicated``      replicated scalars and arrays: unchanged.

  ``slot``            [P, S_loc_pad, *rest] coupon-slot buffers of the
                      three-phase engines (pos, alive, traj, used, dest,
                      cterm). Vertex v's coupons sit in contiguous slots
                      at pstart[owner(v), v_loc] under every shard count,
                      a pure function of the pool sizes (``pool``) and P,
                      so the re-layout is a bit-exact bijection.

Snapshots are host numpy dicts (as `Checkpointer.restore` gives them), so
this module is numpy throughout; only the key derivation uses the port's
threefry.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch import prng
from repro_torch.checkpoint.checkpointer import unpack_json


@dataclasses.dataclass(frozen=True)
class LayoutSpec:
    """How one engine buffer is laid out across the mesh.

    kind  walk | walk_aux | vertex | slot | key | replicated_key |
          replicated (see the module docstring).
    n     number of real vertices (walk, vertex and slot kinds).
    pool  per-vertex coupon pool sizes, length n (slot kind).
    cap   target per-shard lane capacity (walk kind); relayout grows past
          it only when one shard's walks do not fit.
    fill  empty-slot filler (walk, walk_aux and slot kinds).
    aux   names of the walk_aux buffers that follow this walk buffer's
          placement (walk kind).
    """

    kind: str
    n: Optional[int] = None
    pool: Optional[np.ndarray] = None
    cap: Optional[int] = None
    fill: int = 0
    aux: Tuple[str, ...] = ()


def derive_shard_keys(old_keys: np.ndarray, new_shards: int) -> np.ndarray:
    """Fresh per-shard keys from an old per-shard key array: the whole old
    [P, 2] uint32 array is hashed (blake2b over its bytes and length), the
    63-bit digest seeds a base `PRNGKey`, and shard p's key is
    `fold_in(base, p)`. The same as the JAX package derives them."""
    data = np.ascontiguousarray(np.asarray(old_keys, dtype=np.uint32))
    h = hashlib.blake2b(data.tobytes() + np.int64(data.size).tobytes(),
                        digest_size=8).digest()
    seed = int.from_bytes(h, "little") & (2 ** 63 - 1)
    base = prng.PRNGKey(seed)
    return np.stack([prng.fold_in(base, p).numpy()
                     for p in range(int(new_shards))])


def _relayout_vertex(arr: np.ndarray, n: int, new_shards: int) -> np.ndarray:
    """Re-split a [P, n_loc, *rest] vertex-sharded buffer (bit-exact)."""
    old_shards, n_loc_old = arr.shape[:2]
    rest = arr.shape[2:]
    flat = arr.reshape((old_shards * n_loc_old,) + rest)[:n]
    n_loc = math.ceil(n / new_shards)
    out = np.zeros((n_loc * new_shards,) + rest, dtype=arr.dtype)
    out[:n] = flat
    return out.reshape((new_shards, n_loc) + rest)


def _slot_index(pool: np.ndarray, n: int, shards: int):
    """Flat slot index of every real coupon under a P-shard pool layout:
    (flat_idx [S_total], S_loc_pad). Coupon (v, j), the j-th coupon of
    vertex v, lives at owner(v) * S_loc_pad + pstart[owner(v), v_loc] + j,
    the placement the three-phase engines build."""
    n_loc = math.ceil(n / shards)
    n_pad = n_loc * shards
    pool_pad = np.zeros(n_pad, dtype=np.int64)
    pool_pad[:n] = np.asarray(pool, dtype=np.int64)[:n]
    psize = pool_pad.reshape(shards, n_loc)
    pstart = np.zeros_like(psize)
    pstart[:, 1:] = np.cumsum(psize, axis=1)[:, :-1]
    S_loc_pad = max(int(psize.sum(axis=1).max()), 1)
    v = np.repeat(np.arange(n_pad), pool_pad)
    starts = np.concatenate([[0], np.cumsum(pool_pad)[:-1]])
    within = np.arange(len(v), dtype=np.int64) - np.repeat(starts, pool_pad)
    flat = (v // n_loc) * S_loc_pad + pstart.reshape(-1)[v] + within
    return flat, S_loc_pad


def _relayout_slot(arr: np.ndarray, spec: LayoutSpec,
                   new_shards: int) -> np.ndarray:
    """Re-home a coupon-slot buffer (bit-exact bijection)."""
    old_shards = arr.shape[0]
    old_idx, S_old = _slot_index(spec.pool, spec.n, old_shards)
    new_idx, S_new = _slot_index(spec.pool, spec.n, new_shards)
    if arr.shape[:2] != (old_shards, S_old):
        raise ValueError(
            f"slot buffer shape {arr.shape[:2]} does not match the "
            f"{old_shards}-shard pool layout {(old_shards, S_old)}")
    rest = arr.shape[2:]
    flat = arr.reshape((old_shards * S_old,) + rest)
    out = np.full((new_shards * S_new,) + rest, spec.fill, dtype=arr.dtype)
    out[new_idx] = flat[old_idx]
    return out.reshape((new_shards, S_new) + rest)


def _relayout_walk(primary: np.ndarray, auxes: Dict[str, np.ndarray],
                   aux_fills: Dict[str, int], spec: LayoutSpec,
                   new_shards: int) -> Dict[str, np.ndarray]:
    """Re-bucket walk lanes by new owner in canonical order (by vertex,
    then by the aux lanes, then stable; with no aux lane that is sorted
    order); the aux lanes follow the primary slot for slot. The per-shard
    cap grows to the most loaded shard when it must. Returns the primary
    under the key "__primary__" and each aux lane under its name."""
    old_shards, old_cap = primary.shape
    n_loc = math.ceil(spec.n / new_shards)
    flat = primary.reshape(-1)
    live = flat >= 0
    vals = flat[live]
    aux_vals = {k: a.reshape(-1)[live] for k, a in auxes.items()}
    keys = tuple(aux_vals[k] for k in reversed(sorted(aux_vals))) + (vals,)
    order = np.lexsort(keys)
    vals = vals[order]
    aux_vals = {k: a[order] for k, a in aux_vals.items()}
    owner = np.minimum(vals // n_loc, new_shards - 1).astype(np.int64)
    counts = np.bincount(owner, minlength=new_shards)
    cap = spec.cap if spec.cap is not None else max(
        old_cap * old_shards // new_shards + new_shards * 64, 256)
    cap = max(int(cap), int(counts.max(initial=0)), 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(vals), dtype=np.int64) - starts[owner]
    out = {}
    new_p = np.full((new_shards, cap), spec.fill, dtype=primary.dtype)
    new_p[owner, slot] = vals
    out["__primary__"] = new_p
    for k, a in aux_vals.items():
        buf = np.full((new_shards, cap), aux_fills[k], dtype=auxes[k].dtype)
        buf[owner, slot] = a
        out[k] = buf
    return out


def relayout_arrays(arrays: Dict[str, np.ndarray],
                    specs: Dict[str, LayoutSpec],
                    new_shards: int) -> Dict[str, np.ndarray]:
    """Schema-driven re-layout of one stage's host buffers onto
    `new_shards`. Every buffer needs a `LayoutSpec` in `specs`; a walk_aux
    buffer is re-laid out with its primary."""
    missing = [k for k in arrays if k not in specs]
    if missing:
        raise ValueError(f"no layout schema for buffer(s) {missing}; "
                         f"schema covers {sorted(specs)}")
    out: Dict[str, np.ndarray] = {}
    for name, arr in arrays.items():
        spec = specs[name]
        arr = np.asarray(arr)
        if spec.kind == "walk":
            auxes = {a: np.asarray(arrays[a]) for a in spec.aux}
            fills = {a: specs[a].fill for a in spec.aux}
            got = _relayout_walk(arr, auxes, fills, spec, new_shards)
            out[name] = got.pop("__primary__")
            out.update(got)
        elif spec.kind == "walk_aux":
            continue                      # re-laid out with its primary
        elif spec.kind == "vertex":
            out[name] = _relayout_vertex(arr, spec.n, new_shards)
        elif spec.kind == "slot":
            out[name] = _relayout_slot(arr, spec, new_shards)
        elif spec.kind == "key":
            out[name] = derive_shard_keys(arr, new_shards)
        elif spec.kind == "replicated_key":
            out[name] = np.tile(arr[:1], (new_shards, 1))
        elif spec.kind == "replicated":
            out[name] = arr
        else:
            raise ValueError(f"unknown layout kind {spec.kind!r} "
                             f"for buffer {name!r}")
    return out


def relayout_staged_flat(flat: Dict[str, np.ndarray], new_shards: int,
                         layouts: Dict[str, Dict[str, LayoutSpec]]
                         ) -> Dict[str, np.ndarray]:
    """Re-layout a flat staged snapshot (`runtime.staged_to_host` through
    the `Checkpointer`) onto a new shard count, by the schema of the stage
    it is tagged with."""
    stage = unpack_json(flat["stage"])
    specs = layouts.get(stage)
    if specs is None:
        raise ValueError(f"no layout schema declared for stage {stage!r}; "
                         f"schemas cover stages {sorted(layouts)}")
    arrays = {k.split("/", 1)[1]: v for k, v in flat.items()
              if k.startswith("arrays/")}
    relaid = relayout_arrays(arrays, specs, new_shards)
    out = {f"arrays/{k}": v for k, v in relaid.items()}
    out.update({k: v for k, v in flat.items() if not k.startswith("arrays/")})
    return out


def pagerank_state_specs(n: int, cap: int | None = None) -> Dict:
    """The walk engine's `DistState` schema: [P, cap] walk lanes, a
    [P, n_loc] visit shard, per-shard keys and replicated scalars."""
    return dict(
        pos=LayoutSpec(kind="walk", n=n, cap=cap, fill=-1),
        zeta=LayoutSpec(kind="vertex", n=n),
        key=LayoutSpec(kind="key"),
        round=LayoutSpec(kind="replicated"),
        dropped=LayoutSpec(kind="replicated"),
        waited=LayoutSpec(kind="replicated"),
    )


def relayout_pagerank_state(host_state: Dict, n: int, new_shards: int,
                            cap: int | None = None) -> Dict:
    """Re-layout the walk engine's host state dict onto `new_shards`: the
    multiset of live walks and the per-vertex zeta are kept bit for bit,
    the keys are re-derived."""
    arrays = {k: np.asarray(v) for k, v in host_state.items()}
    return relayout_arrays(arrays, pagerank_state_specs(n, cap=cap),
                           new_shards)
