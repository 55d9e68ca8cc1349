"""Routing machinery shared by the sharded engines.

Every sharded engine moves data between vertex shards with the same
static-shape discipline:

  * per (src_shard, dst_shard) routing lanes of fixed capacity — one
    all_to_all per exchange; slots that did not fill carry a sentinel;
  * a stable rank within each target gives every outgoing item a distinct
    lane slot; items beyond the lane capacity wait for the next round;
  * walk buffers of fixed capacity `cap`, compacted after each merge, with
    overflow counted in `dropped` (0 under `cap >= 2*W/P + P*route_cap`).

Every helper takes per-shard tensors with a leading dimension of the
shards held locally ([S, ...], see `core/collectives.py`) and `shard_id`
as the [S] global shard ids of those rows. The helpers that exchange
take the mesh; the others are plain tensor code.

`advance_owned` launches the `walk_step` kernel (its keyed entry point, in
place, which draws the walk's uniforms itself) and `count_owned_arrivals` /
`vertex_histogram` the `histogram` kernel on the card; `_seg_reduce` runs
through `segment_spmv`. On the CPU each takes the kernel's plain version.

Wire accounting: `entry_nbytes` derives bytes per lane entry from the
dtypes of the exchanged tensors, and the routing helpers return
`sent_bytes` computed with it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels.histogram import histogram
from repro_torch.kernels.segment_spmv import segment_spmv
from repro_torch.kernels.walk_step import walk_step_keyed_

_I32 = torch.int32


def _rows(x: torch.Tensor) -> torch.Tensor:
    """[S, 1] view of the per-shard ids, to broadcast against [S, N]."""
    return x.reshape(-1, 1)


def row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running sum along dim 1 of x [S, N], int32.

    One scan over the flattened buffer, then each row's total of the rows
    before it taken off: torch scans a 1-D tensor with a device-wide scan,
    but the rows of a [S, N] tensor one block per row, which leaves the card
    idle when S is the shard count and N the walk buffer."""
    S, N = x.shape
    if N == 0:
        return torch.zeros((S, 0), dtype=_I32, device=x.device)
    wide = torch.int64 if x.numel() >= 2 ** 31 else _I32
    flat = torch.cumsum(x.reshape(-1), 0, dtype=wide).reshape(S, N)
    before = torch.zeros((S, 1), dtype=wide, device=x.device)
    before[1:, 0] = flat[:-1, -1]
    return (flat - before).to(_I32)


def rank_within(sort_key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each element of each shard's row, its rank within its equal-key
    group, in buffer order.

    Returns (rank [S, N] int32, order [S, N] int64): `order` is the stable
    argsort. Stability carries meaning: equal keys keep buffer order, which
    the lanes' zero-drop property relies on.
    """
    S, N = sort_key.shape
    order = torch.sort(sort_key, dim=-1, stable=True).indices
    sorted_k = torch.gather(sort_key, 1, order)
    idx = torch.arange(N, device=sort_key.device).expand(S, N)
    is_start = torch.ones_like(sorted_k, dtype=torch.bool)
    is_start[:, 1:] = sorted_k[:, 1:] != sorted_k[:, :-1]
    run_start = torch.cummax(torch.where(is_start, idx, 0), dim=-1).values
    rank = torch.empty((S, N), dtype=_I32, device=sort_key.device)
    rank.scatter_(1, order, (idx - run_start).to(_I32))
    return rank, order


def rank_small(key: torch.Tensor, num_keys: int) -> torch.Tensor:
    """`rank_within(key)[0]` for keys in [0, num_keys), by one running
    count per key value instead of a sort: the rank of an element is the
    number of earlier elements with its key. Exact, and a few passes over
    the buffer where a sort would take many."""
    rank = torch.zeros(key.shape, dtype=_I32, device=key.device)
    for k in range(num_keys):
        hit = key == k
        rank = torch.where(hit, row_cumsum(hit) - 1, rank)
    return rank


def lane_slots(target: torch.Tensor, valid: torch.Tensor, num_targets: int,
               lane_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assign each valid item a distinct (target, rank) lane slot.

    Returns (sendable, flat_idx): `sendable` marks items that fit their
    target's lane this round; `flat_idx` indexes a [num_targets * lane_cap]
    lane array, with non-sendable items at the sentinel one past the end.
    """
    rank = rank_small(torch.where(valid, target, num_targets), num_targets)
    sendable = valid & (rank < lane_cap)
    flat_idx = torch.where(sendable, target * lane_cap + rank,
                           num_targets * lane_cap)
    return sendable, flat_idx


def pack_lanes(flat_idx: torch.Tensor, values: torch.Tensor,
               sendable: torch.Tensor, num_targets: int, lane_cap: int,
               fill: int = -1) -> torch.Tensor:
    """Scatter `values[sendable]` into [S, num_targets * lane_cap] int32
    lanes; every other slot holds `fill`."""
    S = flat_idx.shape[0]
    width = num_targets * lane_cap
    lanes = torch.full((S, width + 1), fill, dtype=_I32,
                       device=flat_idx.device)
    lanes.scatter_(1, flat_idx.long(),
                   torch.where(sendable, values, fill).to(_I32))
    return lanes[:, :width].contiguous()


def exchange(lanes: torch.Tensor, mesh) -> torch.Tensor:
    """all_to_all of [S, num_targets * lane_cap] lanes."""
    return mesh.all_to_all(lanes)


def exchange_stacked(lanes: list, mesh) -> list:
    """all_to_all several same-shape lane arrays as ONE collective: each
    slot carries its F payload columns together. Values equal F separate
    `exchange` calls."""
    recv = mesh.all_to_all(torch.stack(lanes, dim=-1))
    return list(recv.unbind(-1))


def entry_nbytes(*columns) -> int:
    """Bytes per lane entry: the sum of the dtype sizes of the exchanged
    columns (a dict of columns counts every value)."""
    total = 0
    for col in columns:
        for c in (col.values() if isinstance(col, dict) else (col,)):
            total += (c.element_size() if isinstance(c, torch.Tensor)
                      else np.asarray(c).dtype.itemsize)
    return int(total)


def _offset_ids(ids: torch.Tensor, valid: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-shard segment ids [S, N] rebased into one [S * num_segments]
    int32 range; invalid or out-of-range ids become -1 (dropped)."""
    S = ids.shape[0]
    if S * num_segments >= 2 ** 31:
        raise ValueError(f"{S} shards x {num_segments} segments exceed the "
                         f"int32 segment ids of one device")
    ok = valid & (ids >= 0) & (ids < num_segments)
    base = torch.arange(S, dtype=_I32, device=ids.device).reshape(S, 1)
    return torch.where(ok, base * num_segments + ids, -1).to(_I32)


def _seg_reduce(values: torch.Tensor, seg: torch.Tensor, num_segments: int,
                count_bound=None) -> torch.Tensor:
    """[S, num_segments] sums of each shard's `values` by `seg`; ids out of
    range drop. Runs through `segment_spmv`, which keeps integer sums exact
    past 2**24 when `count_bound` says they may get there."""
    S = values.shape[0]
    gid = _offset_ids(seg, torch.ones_like(seg, dtype=torch.bool),
                      num_segments)
    out = segment_spmv(values.reshape(-1), gid.reshape(-1), S * num_segments,
                       count_bound=count_bound)
    return out.to(values.dtype).reshape(S, num_segments)


def _hist_rows(ids: torch.Tensor, mask: torch.Tensor,
               num_segments: int) -> torch.Tensor:
    S = ids.shape[0]
    gid = _offset_ids(ids, mask, num_segments)
    return histogram(gid.reshape(-1), S * num_segments).reshape(
        S, num_segments)


def vertex_histogram(v: torch.Tensor, mask: torch.Tensor,
                     num_vertices: int) -> torch.Tensor:
    """[S, num_vertices] histogram of each shard's `v[mask]` (trailing dims
    flattened)."""
    S = v.shape[0]
    return _hist_rows(v.reshape(S, -1), mask.reshape(S, -1), num_vertices)


def count_owned_arrivals(mask: torch.Tensor, v_global: torch.Tensor,
                         shard_id: torch.Tensor, n_loc: int) -> torch.Tensor:
    """[S, n_loc] histogram of `v_global[mask]` rebased to each shard's own
    vertex range; ids outside it are ignored."""
    local = v_global - _rows(shard_id) * n_loc
    return _hist_rows(local, mask, n_loc)


def route_counts(per_vertex: torch.Tensor, *, mesh, n_loc: int,
                 by_source: bool = False, count_bound=None):
    """One Lemma-1 aggregated exchange: per-destination-vertex counts
    travel as (vertex, count) pairs, so the payload is bounded by the
    number of distinct destination vertices, not by how many walks move.

    `per_vertex` is [S, P * n_loc] int32, indexed by global padded vertex
    id. Counts for a shard's own vertices stay local. A lane of n_loc slots
    holds every vertex an owner has, so nothing waits or drops.

    Returns (arrivals, sent_entries [S], sent_bytes [S]): `arrivals` is
    [S, n_loc], or [S, P, n_loc] by source shard when `by_source` (the own
    shard's counts in row `shard_id`).
    """
    shards = mesh.shards
    n_pad = shards * n_loc
    sid = mesh.shard_ids()
    S = per_vertex.shape[0]
    rows = torch.arange(S, device=per_vertex.device)
    vid = torch.arange(n_pad, dtype=_I32,
                       device=per_vertex.device).expand(S, n_pad)
    owner = vid // n_loc
    own = per_vertex.reshape(S, shards, n_loc)[rows, sid.long()]
    remote = (owner != _rows(sid)) & (per_vertex > 0)
    sendable, flat_idx = lane_slots(owner, remote, shards, n_loc)
    lanes_v = pack_lanes(flat_idx, vid, sendable, shards, n_loc, fill=-1)
    lanes_c = pack_lanes(flat_idx, per_vertex, sendable, shards, n_loc,
                         fill=0)
    recv_v, recv_c = exchange_stacked([lanes_v, lanes_c], mesh)
    got = recv_v >= 0
    sent_entries = (lanes_v >= 0).sum(dim=1)
    sent_bytes = sent_entries * entry_nbytes(lanes_v, lanes_c)
    local_v = recv_v - _rows(sid) * n_loc
    cnt = torch.where(got, recv_c, 0)
    if by_source:
        # received slot i came from shard i // n_loc (lanes hold n_loc each)
        seg = torch.where(got, owner * n_loc + local_v, n_pad)
        arrivals = _seg_reduce(cnt, seg, n_pad,
                               count_bound).reshape(S, shards, n_loc)
        arrivals[rows, sid.long()] += own
    else:
        seg = torch.where(got, local_v, n_loc)
        arrivals = _seg_reduce(cnt, seg, n_loc, count_bound) + own
    return arrivals, sent_entries, sent_bytes


def route_walks(pos: torch.Tensor, fields: Dict[str, torch.Tensor], *,
                mesh, n_loc: int, route_cap: int):
    """One routing exchange: send walks whose current vertex another shard
    owns, up to `route_cap` per target; the rest wait.

    `fields` are extra int32 payload columns riding along with `pos`.
    Returns (kept_pos, kept_fields, recv_pos, recv_fields, waited [S],
    sent_entries [S], sent_bytes [S]); `recv_*` are [S, P * route_cap]
    with -1 in empty `recv_pos` slots.
    """
    shards = mesh.shards
    sid = _rows(mesh.shard_ids())
    valid = pos >= 0
    owner = torch.where(valid, torch.div(pos, n_loc, rounding_mode="floor"),
                        shards)
    needs = valid & (owner != sid)
    sendable, flat_idx = lane_slots(owner, needs, shards, route_cap)
    send_pos = pack_lanes(flat_idx, pos, sendable, shards, route_cap)
    if fields:
        send_f = [pack_lanes(flat_idx, vals, sendable, shards, route_cap,
                             fill=0) for vals in fields.values()]
        recvs = exchange_stacked([send_pos] + send_f, mesh)
        recv_pos = recvs[0]
        recv_fields = dict(zip(fields.keys(), recvs[1:]))
    else:
        recv_pos = exchange(send_pos, mesh)
        recv_fields = {}
    kept_pos = torch.where(sendable, -1, pos)
    kept_fields = {name: torch.where(sendable, 0, vals)
                   for name, vals in fields.items()}
    waited = (needs & ~sendable).sum(dim=1)
    sent_entries = (send_pos >= 0).sum(dim=1)
    sent_bytes = sent_entries * entry_nbytes(pos, fields)
    return (kept_pos, kept_fields, recv_pos, recv_fields, waited,
            sent_entries, sent_bytes)


def merge_walks(kept_pos: torch.Tensor, kept_fields: Dict[str, torch.Tensor],
                recv_pos: torch.Tensor, recv_fields: Dict[str, torch.Tensor],
                cap: int):
    """Compact kept walks + arrivals into the fixed-capacity buffer.

    Valid walks come first in buffer order, then the empty slots in buffer
    order: the order a stable sort of the 0/1 empty flag gives, built here
    from two running counts instead of a sort. Arrivals beyond `cap` are
    the ones dropped. Returns (pos [S, cap], fields, dropped [S])."""
    merged_pos = torch.cat([kept_pos, torch.where(recv_pos >= 0, recv_pos,
                                                  -1)], dim=1)
    valid = merged_pos >= 0
    n_valid = valid.sum(dim=1, dtype=_I32, keepdim=True)
    dest = torch.where(valid, row_cumsum(valid) - 1,
                       n_valid + row_cumsum(~valid) - 1).long()

    def compact(merged):
        return torch.empty_like(merged).scatter_(1, dest, merged)[:, :cap]

    dropped = torch.clamp(n_valid.squeeze(1) - cap, min=0)
    fields = {name: compact(torch.cat([kept_fields[name], recv_fields[name]],
                                      dim=1))
              for name in kept_fields}
    return compact(merged_pos), fields, dropped


def advance_owned(rp: torch.Tensor, ci: torch.Tensor, dg: torch.Tensor,
                  pos: torch.Tensor, eligible: torch.Tensor,
                  k_term: torch.Tensor, k_edge: torch.Tensor, eps: float,
                  shard_id: torch.Tensor, n_loc: int):
    """One PageRank step for the `eligible` walks of each shard: terminate
    w.p. eps (or on a dangling vertex), else move along a uniform out-edge.

    rp/ci/dg are each shard's CSR ([S, n_loc+1], [S, m_loc_pad],
    [S, n_loc]); k_term/k_edge are the shards' [S, 2] PRNG keys of the
    round, whose `uniform(key, (cap,))` draws decide the step. Returns
    (survive, dst), bool and int32 [S, cap]: `dst` is the new global
    vertex where `survive`. One in-place `walk_step_` launch per shard on
    a bool copy of `eligible` and the local positions, each drawing its
    own uniforms; `pos` and `eligible` are left as they were."""
    dst = torch.where(eligible, pos - _rows(shard_id) * n_loc, 0).to(_I32)
    survive = eligible.to(torch.bool, copy=True,
                          memory_format=torch.contiguous_format)
    for s in range(pos.shape[0]):
        walk_step_keyed_(dst[s], survive[s], k_term[s], k_edge[s], rp[s],
                         ci[s], dg[s], eps=eps)
    return survive, dst
