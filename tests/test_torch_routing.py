"""The port's routing machinery (`repro_torch.core.routing`) against the
JAX package's `repro.core.routing`.

Parity levels:
  * the collective-free helpers (rank_within, lane_slots, pack_lanes,
    merge_walks, count_owned_arrivals, vertex_histogram, _seg_reduce,
    advance_owned, entry_nbytes) — bit-exact against JAX on the same numpy
    inputs, shard by shard; `advance_owned`'s `dst` only where `survive`
    against the jnp path (its two JAX paths differ elsewhere) and
    everywhere against the kernel path;
  * the routing invariants of tests/test_property.py, ported (hypothesis);
  * exchange, exchange_stacked, route_walks and route_counts on a stacked
    mesh of 8 shards — bit-exact against `shard_map` over 8 forced host
    devices, run once in one subprocess.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import routing as jr

from conftest import run_forced_devices
from repro_torch import convert
from repro_torch.core import routing as tr
from repro_torch.core.collectives import StackedMesh
from repro_torch.core.distributed import shard_graph

settings.register_profile("ci", deadline=None, max_examples=25)
settings.load_profile("ci")

CPU = StackedMesh(8, "cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rows_of(fn, *arrays):
    """Stack a JAX helper's per-shard outputs (one call per row)."""
    outs = [fn(p, *[jnp.asarray(a[p]) for a in arrays])
            for p in range(arrays[0].shape[0])]
    if isinstance(outs[0], tuple):
        return [np.stack([np.asarray(o[i]) for o in outs])
                for i in range(len(outs[0]))]
    return np.stack([np.asarray(o) for o in outs])


# ------------------------------------------------- collective-free helpers

@pytest.mark.parametrize("S,N,hi", [(1, 1, 3), (3, 500, 4), (2, 1000, 40),
                                    (4, 64, 1)])
def test_rank_within_matches_jax(S, N, hi):
    keys = np.random.default_rng(N).integers(0, hi, (S, N)).astype(np.int32)
    rank, order = tr.rank_within(_t(keys))
    j_rank, j_order = _rows_of(lambda p, k: jr.rank_within(k), keys)
    np.testing.assert_array_equal(rank.numpy(), j_rank)
    np.testing.assert_array_equal(order.numpy(), j_order)
    np.testing.assert_array_equal(tr.rank_small(_t(keys), hi).numpy(),
                                  j_rank)


@pytest.mark.parametrize("S,N", [(1, 7), (3, 1000), (5, 1), (2, 0)])
def test_row_cumsum_is_a_running_sum_per_row(S, N):
    x = np.random.default_rng(S + N).random((S, N)) < 0.5
    got = tr.row_cumsum(_t(x))
    assert got.dtype == torch.int32 and got.shape == (S, N)
    np.testing.assert_array_equal(got.numpy(), np.cumsum(x, axis=1))


@pytest.mark.parametrize("shards,lane_cap", [(1, 4), (3, 2), (8, 5)])
def test_lane_slots_and_pack_lanes_match_jax(shards, lane_cap):
    rng = np.random.default_rng(shards)
    S, N = 3, 200
    target = rng.integers(0, shards, (S, N)).astype(np.int32)
    valid = rng.random((S, N)) < 0.7
    values = rng.integers(0, 10 ** 6, (S, N)).astype(np.int32)
    sendable, flat = tr.lane_slots(_t(target), _t(valid), shards, lane_cap)
    j_send, j_flat = _rows_of(
        lambda p, t, v: jr.lane_slots(t, v, shards, lane_cap), target, valid)
    np.testing.assert_array_equal(sendable.numpy(), j_send)
    np.testing.assert_array_equal(flat.numpy(), j_flat)
    for fill in (-1, 0):
        lanes = tr.pack_lanes(flat, _t(values), sendable, shards, lane_cap,
                              fill=fill)
        j_lanes = _rows_of(lambda p, f, v, s: jr.pack_lanes(
            f, v, s, shards, lane_cap, fill=fill), j_flat, values, j_send)
        np.testing.assert_array_equal(lanes.numpy(), j_lanes)


@pytest.mark.parametrize("cap", [10, 40, 80])
def test_merge_walks_matches_jax(cap):
    rng = np.random.default_rng(cap)
    S = 3
    kept = np.where(rng.random((S, 40)) < 0.5,
                    rng.integers(0, 99, (S, 40)), -1).astype(np.int32)
    recv = np.where(rng.random((S, 24)) < 0.4,
                    rng.integers(0, 99, (S, 24)), -1).astype(np.int32)
    kx = rng.integers(1, 50, (S, 40)).astype(np.int32)
    rx = rng.integers(1, 50, (S, 24)).astype(np.int32)
    pos, fields, dropped = tr.merge_walks(_t(kept), {"x": _t(kx)}, _t(recv),
                                          {"x": _t(rx)}, cap)
    j = _rows_of(lambda p, k, r, a, b: (lambda o: (o[0], o[1]["x"], o[2]))(
        jr.merge_walks(k, {"x": a}, r, {"x": b}, cap)), kept, recv, kx, rx)
    for got, want in zip((pos, fields["x"], dropped), j):
        np.testing.assert_array_equal(got.numpy(), want)


def test_histograms_and_seg_reduce_match_jax():
    rng = np.random.default_rng(3)
    S, N, n_loc = 4, 700, 50
    v = rng.integers(-3, S * n_loc + 3, (S, N)).astype(np.int32)
    mask = rng.random((S, N)) < 0.6
    sid = np.arange(S, dtype=np.int32)
    got = tr.count_owned_arrivals(_t(mask), _t(v), _t(sid), n_loc)
    want = _rows_of(lambda p, m, x: jr.count_owned_arrivals(
        m, x, jnp.int32(p), n_loc), mask, v)
    want_k = _rows_of(lambda p, m, x: jr.count_owned_arrivals(
        m, x, jnp.int32(p), n_loc, use_pallas=True), mask, v)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), want_k)
    for use_pallas in (False, True):
        hist = _rows_of(lambda p, x, m: jr.vertex_histogram(
            x, m, 120, use_pallas=use_pallas), v, mask)
        np.testing.assert_array_equal(
            tr.vertex_histogram(_t(v), _t(mask), 120).numpy(), hist)
    vals = rng.integers(0, 1000, (S, N)).astype(np.int32)
    for bound in (None, 2 ** 30):
        red = tr._seg_reduce(_t(vals), _t(v), 120, count_bound=bound)
        assert red.dtype == torch.int32
        for use_pallas in (False, True):
            np.testing.assert_array_equal(red.numpy(), _rows_of(
                lambda p, x, s: jr._seg_reduce(x, s, 120, use_pallas,
                                               count_bound=bound), vals, v))


def test_entry_nbytes_matches_jax():
    cols = (np.zeros(3, np.int32), {"a": np.zeros(2, np.int32),
                                    "b": np.zeros(2, np.int16)})
    want = jr.entry_nbytes(jnp.asarray(cols[0]),
                           {k: jnp.asarray(v) for k, v in cols[1].items()})
    got = tr.entry_nbytes(_t(cols[0]),
                          {k: _t(v) for k, v in cols[1].items()})
    assert got == want == 4 + 4 + 2
    assert tr.entry_nbytes(_t(cols[0]), _t(cols[0])) == 8


@pytest.mark.parametrize("name,shards", [("er", 3), ("dweb", 2),
                                         ("ba_hub", 1)])
def test_advance_owned_matches_jax(small_graphs, name, shards):
    g = small_graphs[name]
    tg = convert.graph_from_numpy(np.asarray(g.row_ptr),
                                  np.asarray(g.col_idx),
                                  np.asarray(g.out_deg), g.n, g.m,
                                  g.undirected, device="cpu")
    sg = shard_graph(tg, shards)
    n_loc, cap = sg.n_loc, 300
    rng = np.random.default_rng(shards)
    pos = rng.integers(-1, sg.n_pad, (shards, cap)).astype(np.int32)
    sid = np.arange(shards, dtype=np.int32)
    eligible = (pos >= 0) & (pos // n_loc == sid[:, None])
    j_keys = jax.random.split(jax.random.PRNGKey(shards), 2 * shards)
    t_keys = convert.key_from_numpy
    kt = torch.stack([t_keys(np.asarray(k)) for k in j_keys[:shards]])
    ke = torch.stack([t_keys(np.asarray(k)) for k in j_keys[shards:]])
    survive, dst = tr.advance_owned(sg.row_ptr, sg.col_idx, sg.out_deg,
                                    _t(pos), _t(eligible), kt, ke, 0.2,
                                    _t(sid), n_loc)
    tabs = [x.numpy() for x in (sg.row_ptr, sg.col_idx, sg.out_deg)]
    for use_pallas in (False, True):
        j_surv, j_dst = _rows_of(
            lambda p, rp, ci, dg, x, e: jr.advance_owned(
                rp, ci, dg, x, e, j_keys[p], j_keys[shards + p], 0.2,
                jnp.int32(p), n_loc, use_pallas=use_pallas),
            *tabs, pos, eligible)
        np.testing.assert_array_equal(survive.numpy(), j_surv)
        s = survive.numpy()
        if use_pallas:
            np.testing.assert_array_equal(dst.numpy(), j_dst)
        else:
            np.testing.assert_array_equal(dst.numpy()[s], j_dst[s])
    assert s.any() and not s[~eligible].any()


# ------------------------------------------ routing invariants (hypothesis)

def _check_rank_within(keys):
    rank, _ = tr.rank_within(torch.tensor([keys], dtype=torch.int32))
    rank, keys = rank.numpy()[0], np.asarray(keys)
    for v in set(keys.tolist()):
        ranks_v = rank[keys == v]
        # a permutation of 0..k-1 per equal-key group, assigned stably
        assert sorted(ranks_v.tolist()) == list(range(len(ranks_v)))
        assert (np.diff(ranks_v) > 0).all() if len(ranks_v) > 1 else True
    np.testing.assert_array_equal(
        tr.rank_small(torch.tensor([keys.tolist()], dtype=torch.int32),
                      12).numpy()[0], rank)


@given(st.lists(st.integers(min_value=0, max_value=11), min_size=1,
                max_size=300))
def test_rank_within_stable_ranking(keys):
    _check_rank_within(keys)


@given(st.integers(min_value=1, max_value=6).flatmap(lambda s: st.tuples(
           st.just(s),
           st.lists(st.tuples(st.integers(0, s - 1), st.booleans()),
                    min_size=1, max_size=120),
           st.integers(min_value=1, max_value=8))))
def test_lane_slots_no_silent_drops(case):
    shards, items, lane_cap = case
    t = np.array([[x for x, _ in items]], np.int32)
    v = np.array([[y for _, y in items]], bool)
    sendable, flat = tr.lane_slots(_t(t), _t(v), shards, lane_cap)
    sendable, flat, t, v = sendable.numpy()[0], flat.numpy()[0], t[0], v[0]
    assert not (sendable & ~v).any()
    for q in range(shards):
        grp = v & (t == q)
        sent = sendable & grp
        # exactly min(|group|, cap) go this round, the rest wait
        assert sent.sum() == min(grp.sum(), lane_cap), q
        slots = flat[sent]
        assert ((slots >= q * lane_cap) & (slots < (q + 1) * lane_cap)).all()
    assert len(set(flat[sendable].tolist())) == int(sendable.sum())
    assert (flat[~sendable] == shards * lane_cap).all()


@given(st.integers(min_value=1, max_value=5).flatmap(lambda s: st.tuples(
           st.lists(st.lists(st.integers(0, s - 1), min_size=8, max_size=8),
                    min_size=s, max_size=s),
           st.integers(min_value=1, max_value=6))))
def test_pack_exchange_roundtrip_conserves(case):
    """Every shard packs its outbox and the stacked mesh exchanges it:
    delivered + waiting equals what was sent, each item lands at its
    target, and each (src, dst) lane keeps source order."""
    per_shard_targets, lane_cap = case
    shards = len(per_shard_targets)
    t = np.array(per_shard_targets, np.int32)
    values = (np.arange(shards)[:, None] * 1000
              + np.arange(t.shape[1])).astype(np.int32)
    sendable, flat = tr.lane_slots(_t(t), torch.ones(t.shape, dtype=bool),
                                   shards, lane_cap)
    lanes = tr.pack_lanes(flat, _t(values), sendable, shards, lane_cap)
    recv = tr.exchange(lanes, StackedMesh(shards, "cpu")).numpy()
    sendable = sendable.numpy()
    delivered = []
    for p in range(shards):
        blocks = recv[p].reshape(shards, lane_cap)     # [src, cap]
        for q in range(shards):
            lane = blocks[q][blocks[q] >= 0]
            assert (blocks[q][:len(lane)] >= 0).all()
            assert (np.diff(lane) > 0).all() if len(lane) > 1 else True
            np.testing.assert_array_equal(
                lane, values[q][sendable[q] & (t[q] == p)])
        delivered.extend(blocks[blocks >= 0].tolist())
    waiting = values[~sendable].tolist()
    assert sorted(delivered + waiting) == sorted(values.reshape(-1).tolist())


@given(st.lists(st.integers(min_value=-1, max_value=99), min_size=1,
                max_size=60),
       st.lists(st.integers(min_value=-1, max_value=99), min_size=1,
                max_size=60))
def test_merge_walks_conserves_and_drops_exactly(kept, recv):
    cap = len(kept)
    k = torch.tensor([kept], dtype=torch.int32)
    r = torch.tensor([recv], dtype=torch.int32)

    def tag(p):
        return torch.where(p >= 0, p * 7 + 1, 0)

    pos, fields, dropped = tr.merge_walks(k, {"x": tag(k)}, r, {"x": tag(r)},
                                          cap)
    pos, x, dropped = pos.numpy()[0], fields["x"].numpy()[0], int(dropped[0])
    n_kept = sum(p >= 0 for p in kept)
    n_recv = sum(p >= 0 for p in recv)
    assert pos.shape == (cap,)
    assert int((pos >= 0).sum()) == min(n_kept + n_recv, cap)
    assert dropped == max(0, n_kept + n_recv - cap)
    assert (x[pos >= 0] == pos[pos >= 0] * 7 + 1).all()
    kept_valid = [p for p in kept if p >= 0]
    surviving = pos[pos >= 0].tolist()
    # resident walks come first and are never the ones dropped
    assert surviving[:n_kept] == kept_valid
    assert surviving[n_kept:] == [p for p in recv if p >= 0][
        : len(surviving) - n_kept]


# ------------------------------- the exchanges against shard_map (8 devices)

JAX_EXCHANGES = """
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.core import routing as jr
from repro.core.routing import shard_map
S = 8
mesh = Mesh(np.array(jax.devices()[:S]), ("s",))
spec = P("s")
rng = np.random.default_rng(0)
out = {}
L, n_loc, route_cap = 5, 6, 3
lanes = rng.integers(-1, 100, (S, S * L)).astype(np.int32)
cols = [rng.integers(-1, 100, (S, S * L)).astype(np.int32) for _ in range(3)]
pos = np.where(rng.random((S, 40)) < 0.8,
               rng.integers(0, S * n_loc, (S, 40)), -1).astype(np.int32)
fa = rng.integers(0, 9, (S, 40)).astype(np.int32)
fb = rng.integers(0, 9, (S, 40)).astype(np.int32)
pv = np.where(rng.random((S, S * n_loc)) < 0.5,
              rng.integers(0, 50, (S, S * n_loc)), 0).astype(np.int32)

def ex(x):
    return jr.exchange(x[0], "s", S, L)[None]

def ex3(a, b, c):
    return tuple(r[None] for r in jr.exchange_stacked(
        [a[0], b[0], c[0]], "s", S, L))

def rw(pos, a, b):
    sid = jax.lax.axis_index("s")
    r1 = jr.route_walks(pos[0], {"a": a[0], "b": b[0]}, axis="s",
                        shard_id=sid, n_loc=n_loc, shards=S,
                        route_cap=route_cap)
    r0 = jr.route_walks(pos[0], {}, axis="s", shard_id=sid, n_loc=n_loc,
                        shards=S, route_cap=route_cap)
    kept, kf, recv, rf, waited, se, sb = r1
    return (kept[None], kf["a"][None], kf["b"][None], recv[None],
            rf["a"][None], rf["b"][None], waited[None], se[None], sb[None],
            r0[0][None], r0[2][None], r0[4][None], r0[5][None], r0[6][None])

def rc(pv):
    sid = jax.lax.axis_index("s")
    a, se, sb = jr.route_counts(pv[0], axis="s", shard_id=sid, n_loc=n_loc,
                                shards=S)
    b, _, _ = jr.route_counts(pv[0], axis="s", shard_id=sid, n_loc=n_loc,
                              shards=S, by_source=True)
    return a[None], se[None], sb[None], b[None]

run = lambda f, n_in, n_out, *args: shard_map(
    f, mesh, in_specs=(spec,) * n_in, out_specs=(spec,) * n_out
    if n_out > 1 else spec)(*args)
out["exchange"] = np.asarray(run(ex, 1, 1, lanes)).tolist()
out["exchange_stacked"] = [np.asarray(x).tolist()
                           for x in run(ex3, 3, 3, *cols)]
out["route_walks"] = [np.asarray(x).tolist()
                      for x in run(rw, 3, 14, pos, fa, fb)]
out["route_counts"] = [np.asarray(x).tolist() for x in run(rc, 1, 4, pv)]
out["inputs"] = dict(lanes=lanes.tolist(), cols=[c.tolist() for c in cols],
                     pos=pos.tolist(), fa=fa.tolist(), fb=fb.tolist(),
                     pv=pv.tolist())
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_exchanges():
    return run_forced_devices(JAX_EXCHANGES, devices=8, timeout=600)


def _np(x):
    return np.asarray(x, np.int32)


def test_exchange_matches_shard_map(jax_exchanges):
    inp = jax_exchanges["inputs"]
    got = tr.exchange(_t(_np(inp["lanes"])), CPU)
    np.testing.assert_array_equal(got.numpy(), jax_exchanges["exchange"])
    got3 = tr.exchange_stacked([_t(_np(c)) for c in inp["cols"]], CPU)
    for a, b in zip(got3, jax_exchanges["exchange_stacked"]):
        np.testing.assert_array_equal(a.numpy(), b)


def test_route_walks_matches_shard_map(jax_exchanges):
    inp = jax_exchanges["inputs"]
    pos, fa, fb = (_t(_np(inp[k])) for k in ("pos", "fa", "fb"))
    kept, kf, recv, rf, waited, se, sb = tr.route_walks(
        pos, {"a": fa, "b": fb}, mesh=CPU, n_loc=6, route_cap=3)
    k0, _, r0, _, w0, se0, sb0 = tr.route_walks(pos, {}, mesh=CPU, n_loc=6,
                                                route_cap=3)
    got = (kept, kf["a"], kf["b"], recv, rf["a"], rf["b"], waited, se, sb,
           k0, r0, w0, se0, sb0)
    assert int(waited.sum()) > 0     # some lanes were full
    for a, b in zip(got, jax_exchanges["route_walks"]):
        np.testing.assert_array_equal(a.numpy(), b)


def test_route_counts_matches_shard_map(jax_exchanges):
    pv = _t(_np(jax_exchanges["inputs"]["pv"]))
    a, se, sb = tr.route_counts(pv, mesh=CPU, n_loc=6)
    b, _, _ = tr.route_counts(pv, mesh=CPU, n_loc=6, by_source=True)
    for got, want in zip((a, se, sb, b), jax_exchanges["route_counts"]):
        np.testing.assert_array_equal(got.numpy(), want)
    # nothing is lost: every count arrives at its owner
    np.testing.assert_array_equal(a.numpy().reshape(-1),
                                  pv.numpy().sum(axis=0))
