"""The port's optimizer, gradient compression and checkpoint keys against
the JAX package's, on the CPU.

Ports of tests/test_train.py (AdamW on a quadratic, int8 tracking fp32,
the quantization bound, grad clipping, compression error feedback), then
the port against the JAX package on the same numbers, drawn with numpy
from a seed and rounded to bf16:

- `quantize_blockwise` and `_quant` round trips: bit-exact (level 1).
- `apply_updates`, fp32 and int8 moments, five steps on a tree with a
  stacked leaf [3, 5, 7] (35 entries a layer: the layers share int8
  blocks, as in JAX's flat state): bit-exact (level 1) in the masters,
  moments and bf16 weights while the clip does not engage (the clip
  scale is then exactly 1). With the clip engaged the level drops to 2:
  the global norm sums in another order than XLA's (ulps), the scale
  with it; measured at most 1.2e-7 in the masters, bound `TOL_CLIPPED`;
  with int8 moments an ulp can round a moment's code the other way (one
  step, measured 8.9e-5 in a master at lr 1e-2), bound
  `TOL_CLIPPED_INT8`. The optimizer's float32 sqrt is correctly rounded
  on the CPU too (see `optimizer._sqrt_`): without it level 1 fails.
  `grad_norm` itself: relative `TOL_NORM` (level 2).
- `compressed_psum` on a `StackedMesh`: each row's quantization bit-exact,
  the sum to float32 rounding (level 2, `TOL_NORM`).
- A port `AdamState` saved by the port's `Checkpointer` has the JAX
  package's keys, shapes and dtypes (level 1).
- The port's own exchange between weight blocks and ZeRO ranges (no JAX
  counterpart: GSPMD reshards there): its algebra against the widened
  flat vector (level 1), and one fake rank of reduced DBRX at (data 4,
  model 4) held to its peak and all_to_all bytes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import _flatten as jax_flatten
from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro_torch.checkpoint import Checkpointer, restore_into
from repro_torch.core.collectives import StackedMesh
from repro_torch.train import (AdamWConfig, apply_updates, compressed_psum,
                               compression_error, init_state)
from repro_torch.train import compression as tcomp
from repro_torch.train import optimizer as topt

TOL_CLIPPED = 1e-6
TOL_CLIPPED_INT8 = 2e-4
TOL_NORM = 1e-6
SHAPES = dict(w=(32, 16), b=(16,), stack=(3, 5, 7))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def bf16(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def jax_tree(arrs):
    return {k: jnp.asarray(v, jnp.bfloat16) for k, v in arrs.items()}


def port_tree(arrs):
    """bf16 tensors; the stacked leaf as a list of its layers."""
    out = {k: torch.tensor(v).to(torch.bfloat16) for k, v in arrs.items()}
    out["stack"] = list(out["stack"].unbind(0))
    return out


def draw(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: bf16(rng.standard_normal(s) * scale) for k, s in SHAPES.items()}


def flat_port(leaf) -> np.ndarray:
    parts = leaf if isinstance(leaf, list) else [leaf]
    return torch.cat([t.float().reshape(-1) for t in parts]).numpy()


def toy_params(seed=0):
    rng = np.random.default_rng(seed)
    return dict(w=torch.tensor(rng.standard_normal((32, 16))).bfloat16(),
                b=torch.tensor(rng.standard_normal(16)).bfloat16())


def quad_loss_grads(params, target=1.0):
    """sum (p - target)^2 over the leaves and its gradients (bf16, as
    JAX's for bf16 leaves)."""
    loss = sum(float(((p.float() - target) ** 2).sum())
               for p in params.values())
    grads = {k: (2 * (p.float() - target)).to(p.dtype)
             for k, p in params.items()}
    return loss, grads


# ------------------------------------------------- ports of test_train.py

def test_adamw_reduces_quadratic():
    params = toy_params()
    cfg = AdamWConfig(lr=5e-2, weight_decay=0.0)
    state = init_state(params, cfg)
    l0, _ = quad_loss_grads(params)
    for _ in range(60):
        _, grads = quad_loss_grads(params)
        params, state, _ = apply_updates(params, grads, state, cfg)
    assert quad_loss_grads(params)[0] < 0.05 * l0


def test_int8_adam_tracks_fp32():
    """int8 moments converge to the same optimum; iterate noise bounded."""
    cfg32 = AdamWConfig(lr=2e-2, weight_decay=0.0)
    cfg8 = AdamWConfig(lr=2e-2, weight_decay=0.0, int8_moments=True)
    p32, p8 = toy_params(), toy_params()
    s32, s8 = init_state(p32, cfg32), init_state(p8, cfg8)
    l0 = quad_loss_grads(p32)[0]
    for _ in range(80):
        p32, s32, _ = apply_updates(p32, quad_loss_grads(p32)[1], s32, cfg32)
        p8, s8, _ = apply_updates(p8, quad_loss_grads(p8)[1], s8, cfg8)
    assert quad_loss_grads(p32)[0] < 0.15 * l0
    assert quad_loss_grads(p8)[0] < 1.1 * quad_loss_grads(p32)[0]
    a = torch.cat([p.float().reshape(-1) for p in p32.values()])
    b = torch.cat([p.float().reshape(-1) for p in p8.values()])
    cos = float(a @ b / (a.norm() * b.norm()))
    assert cos > 0.98, cos


def test_quantize_roundtrip_error_bound():
    x = torch.tensor(np.random.default_rng(0).standard_normal(1024) * 3.0,
                     dtype=torch.float32)
    q, s = topt.quantize_blockwise(x)
    back = topt.dequantize_blockwise(q, s)
    # absmax int8: error <= scale/2 per element
    bound = x.reshape(-1, 128).abs().amax(dim=1) / 127.0 / 2.0
    err = (x - back).reshape(-1, 128).abs().amax(dim=1)
    assert bool((err <= bound + 1e-6).all())


def test_grad_clip():
    params = dict(w=torch.zeros(4, dtype=torch.bfloat16))
    cfg = AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0)
    state = init_state(params, cfg)
    huge = dict(w=torch.full((4,), 1e6))
    _, _, m = apply_updates(params, huge, state, cfg)
    assert float(m["grad_norm"]) > 1e5  # reported unclipped


def test_compression_error_feedback_converges():
    """With error feedback the time-average of the compressed sums is
    unbiased: the residual stays bounded while the signal accumulates."""
    x = torch.tensor(np.random.default_rng(0).standard_normal((1, 512)),
                     dtype=torch.float32)
    mesh = StackedMesh(1, "cpu")
    residual = torch.zeros_like(x)
    total = torch.zeros(512)
    for _ in range(50):
        y, residual = compressed_psum(x, mesh, residual)
        total = total + y
    rel = float((total / 50 - x[0]).norm() / x[0].norm())
    assert rel < 0.01, rel
    assert compression_error(x[0]) < 0.05


# ------------------------------------------------ against the JAX package

def test_quantize_blockwise_matches_jax():
    x = np.random.default_rng(1).standard_normal(128 * 9).astype(np.float32)
    x[:128] = 0.0                       # an all-zero block: scale 0
    jq, js = jopt.quantize_blockwise(jnp.asarray(x))
    tq, ts = topt.quantize_blockwise(torch.tensor(x))
    assert np.array_equal(np.asarray(jq), tq.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())
    assert np.array_equal(np.asarray(jopt.dequantize_blockwise(jq, js)),
                          topt.dequantize_blockwise(tq, ts).numpy())
    assert np.array_equal(np.asarray(jopt.dequantize_floor(jq, js)),
                          topt.dequantize_floor(tq, ts).numpy())


def test_compression_quant_matches_jax():
    x = np.random.default_rng(2).standard_normal(1000).astype(np.float32)
    jq, js = jcomp._quant(jnp.asarray(x))
    tq, ts = tcomp._quant(torch.tensor(x))
    assert np.array_equal(np.asarray(jq), tq.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())
    assert np.array_equal(np.asarray(jcomp._dequant(jq, js, 1000)),
                          tcomp._dequant(tq, ts, 1000).numpy())
    assert jcomp.compression_error(jnp.asarray(x)) == pytest.approx(
        compression_error(torch.tensor(x)), rel=TOL_NORM)


def test_compressed_psum_matches_jax_per_shard():
    """Three stacked shards, each with its own residual, two calls: each
    row as JAX's single-shard feedback, the sum of the rows."""
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((2, 3, 700)).astype(np.float32)
    mesh = StackedMesh(3, "cpu")
    t_res = torch.zeros(3, 700)
    j_res = [jnp.zeros(700) for _ in range(3)]
    for x in xs:
        y, t_res = compressed_psum(torch.tensor(x), mesh, t_res)
        locals_ = []
        for s in range(3):
            corrected = jnp.asarray(x[s]) + j_res[s]
            q, sc = jcomp._quant(corrected)
            local = jcomp._dequant(q, sc, 700)
            j_res[s] = corrected - local
            locals_.append(np.asarray(local))
        for s in range(3):
            assert np.array_equal(np.asarray(j_res[s]), t_res[s].numpy())
        ref = np.sum(locals_, axis=0)
        assert np.allclose(y.numpy(), ref, rtol=TOL_NORM, atol=TOL_NORM)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("clipped", [False, True],
                         ids=["unclipped", "clipped"])
def test_apply_updates_matches_jax(int8, clipped):
    """Five steps of both packages' `apply_updates` (JAX eager) from the
    same bf16 weights, on the same bf16 gradients."""
    kw = dict(lr=1e-2, int8_moments=int8)
    jcfg, tcfg = jopt.AdamWConfig(**kw), AdamWConfig(**kw)
    init = draw(0)
    jp, tp = jax_tree(init), port_tree(init)
    js, ts = jopt.init_state(jp, jcfg), init_state(tp, tcfg)
    # gradients of norm ~1.2: the clip (1.0) engages; / 10 it does not
    scale = 0.05 if clipped else 0.005
    for step in range(5):
        g = draw(100 + step, scale)
        jp, js, jm = jopt.apply_updates(jp, jax_tree(g), js, jcfg)
        tp, ts, tm = apply_updates(tp, port_tree(g), ts, tcfg)
        assert (float(jm["grad_norm"]) > 1.0) == clipped
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=TOL_NORM)
    assert int(ts.step) == int(js.step) == 5 and ts.step.dtype == torch.int32
    for k in SHAPES:
        master = np.asarray(js.master[k])
        assert ts.master[k].shape == master.shape == (
            -(-int(np.prod(SHAPES[k])) // 128) * 128,)
        weights = np.asarray(jp[k].astype(jnp.float32)).reshape(-1)
        if not clipped:
            assert np.array_equal(master, ts.master[k].numpy()), k
            assert np.array_equal(weights, flat_port(tp[k])), k
            for j_mom, t_mom in ((js.m[k], ts.m[k]), (js.v[k], ts.v[k])):
                j_leaves = j_mom if int8 else (j_mom,)
                t_leaves = t_mom if int8 else (t_mom,)
                for a, b in zip(j_leaves, t_leaves):
                    assert np.array_equal(np.asarray(a), b.numpy()), k
        else:
            tol = TOL_CLIPPED_INT8 if int8 else TOL_CLIPPED
            assert np.abs(master - ts.master[k].numpy()).max() <= tol, k
            if int8:   # a code may round the other way, by one step
                for j_mom, t_mom in ((js.m[k], ts.m[k]), (js.v[k], ts.v[k])):
                    assert np.abs(np.asarray(j_mom[0]).astype(int)
                                  - t_mom[0].numpy().astype(int)).max() <= 1


def test_adam_state_checkpoint_has_jax_keys(tmp_path):
    """The port's `AdamState` (int8 moments: (codes, scales) pairs) saved
    beside the weights has the keys, shapes and dtypes JAX's Checkpointer
    gives its own, and restores into the port's tree unchanged."""
    init = draw(0)
    for int8 in (False, True):
        jst = jopt.init_state(jax_tree(init), jopt.AdamWConfig(
            int8_moments=int8))
        tst = init_state(port_tree(init), AdamWConfig(int8_moments=int8))
        want = jax_flatten(dict(opt=jst))
        ck = Checkpointer(str(tmp_path / f"int8_{int8}"))
        ck.save(1, dict(opt=tst))
        flat, manifest = ck.restore()
        assert sorted(flat) == sorted(want)
        for k, v in want.items():
            assert flat[k].shape == v.shape and flat[k].dtype == v.dtype, k
        assert "opt/step" in flat and "opt/master/stack" in flat
        assert ("opt/m/w/1" in flat) == int8
        back = restore_into(dict(opt=tst), flat)["opt"]
        assert type(back) is type(tst)
        assert back.m["w"][0].dtype == (torch.int8 if int8
                                        else torch.float32)


# leaves on a (data 2, model 3) mesh: (the parts' shapes, their logical
# axes, None for whole untagged parts)
EXCHANGE_MESH = {"data": 2, "model": 3}
EXCHANGE_LEAVES = {
    "1d": ([(1536,)], ("embed",)),                    # replicated on model
    "2d": ([(24, 36)], ("embed", "ffn")),
    "3d": ([(6, 8, 27)], ("experts", "embed", "ffn")),  # ffn stays whole
    "layers": ([(4, 6, 18)] * 3, ("embed", "q_heads", "head_dim")),
    "whole": ([(5, 7), (300,), (6, 40), (20, 40)], None),
}


def widened_offsets(shape, index, at):
    """The leaf offsets of a block's elements, in the block's order, read
    off the widened flat vector."""
    return at + np.arange(int(np.prod(shape))).reshape(shape)[index].ravel()


def box_offsets(bx):
    """The flat offsets of each box (j, shape, offset, strides), row-major
    over its shape, concatenated."""
    out = []
    for _, shape, off, strides in bx:
        pos = np.full(shape, off, dtype=np.int64)
        for d, (n, st) in enumerate(zip(shape, strides)):
            pos += (np.arange(n) * st).reshape(
                (1,) * d + (n,) + (1,) * (len(shape) - d - 1))
        out += list(pos.ravel())
    return np.asarray(out, dtype=np.int64)


@pytest.mark.parametrize("bucket", [768, 1 << 25], ids=["buckets", "one"])
@pytest.mark.parametrize("leaf", list(EXCHANGE_LEAVES))
def test_block_runs_land_where_the_widened_leaf_has_them(leaf, bucket,
                                                         monkeypatch):
    """The algebra of the exchange between blocks and ZeRO ranges
    (`sharding.layout.below` and `boxes`, `optimizer._Plan`), level 1:
    for each ZeRO rank's block of each part and each rank's bucket of
    the ranges, the run the plan sends is the one whose offsets in the
    widened flat vector lie in that bucket, and its boxes land on those
    offsets; a leaf of whole parts' bucket rows (`_row_boxes`) meet the
    parts where the flat vector has them. ZeRO rank s is (data s // 3,
    model s % 3), as the ZeRO group numbers its ranks."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding.layout import Placement, boxes, mesh_rules
    monkeypatch.setattr(topt, "BUCKET", bucket)
    shapes, axes = EXCHANGE_LEAVES[leaf]
    Z = 6
    coords = [dict(data=s // 3, model=s % 3) for s in range(Z)]
    mesh = Mesh(dict(EXCHANGE_MESH), None, coords=coords[0])
    rules = mesh_rules(mesh)
    at = np.cumsum([0] + [int(np.prod(sh)) for sh in shapes])
    n = int(at[-1])
    per = topt.zero_share(topt._pad_len(n), Z)
    chunks = topt._chunks(per, Z)
    assert len(chunks) == (1 if bucket > 1 << 20 else per // 128) and \
        per == 256
    if axes is None:
        parts = [torch.zeros(sh) for sh in shapes]
        for lo, m in chunks:
            got = np.full(Z * m, -1, dtype=np.int64)
            for i, j, shape, off, strides in topt._row_boxes(parts, per, Z,
                                                             lo, m):
                k = int(np.prod(shape))
                assert (got[j:j + k] == -1).all()
                got[j:j + k] = at[i] + box_offsets(
                    [(j, shape, off, strides)])
            q = np.arange(Z * m)
            flat = (q // m) * per + lo + q % m
            assert np.array_equal(got, np.where(flat < n, flat, -1))
        return
    parts = []
    for sh in shapes:
        spec = rules.spec(axes, sh)
        index = rules.block(sh, spec, coords[0])
        t = torch.zeros(tuple(sl.stop - sl.start for sl in index))
        t.placement = Placement(mesh, spec, sh, index)
        parts.append(t)
    plan = topt._Plan(parts, Z)
    assert plan.coords == [dict(c) for c in coords]
    for s in range(Z):
        offs = [widened_offsets(sh, rules.block(sh, p.placement.spec,
                                                coords[s]), at[i])
                for i, (sh, p) in enumerate(zip(shapes, parts))]
        for lo, m in chunks:
            for r in range(Z):
                a, b = r * per + lo, r * per + lo + m
                want = []
                for i, o in enumerate(offs):
                    j = np.nonzero((o >= a) & (o < b))[0]
                    if j.size:
                        assert np.array_equal(j, np.arange(j[0], j[-1] + 1))
                        want.append((i, int(j[0]), int(j[-1]) + 1))
                runs = plan.runs(s, a, b)
                assert runs == want, (s, r, lo)
                for i, j0, j1 in runs:
                    bx = boxes(plan.grids[i][s], j0, j1)
                    assert [x[0] for x in bx] == sorted(x[0] for x in bx)
                    assert bx[0][0] == j0
                    assert np.array_equal(at[i] + box_offsets(bx),
                                          offs[i][j0:j1])


FAKE_MESH = {"data": 4, "model": 4}
FAKE_BUCKET = 4096           # floats: a bucket of 256 a rank at Z = 16


@pytest.mark.parametrize("rank", [0, 6])
def test_apply_updates_on_a_fake_rank_moves_blocks_not_leaves(rank,
                                                              monkeypatch):
    """One rank of reduced DBRX on blocks at (data 4, model 4), without
    processes (`make_rank_mesh`: `FakeGroup`s, fake tensors): its
    `apply_updates` (gradients of its blocks' shapes, None where the model
    ranks hold a block alike and it is off model rank 0, as
    `train_step.rank_grads` gives them) under `LiveBytes` and
    `CollectiveLog`. Its peak over its arguments stays below the largest
    leaf's whole float32 bytes and within the bound of its ranges and a
    bucket: the gradient ranges it holds until the update (4 B an
    element of its ZeRO ranges), one leaf's update temporaries (m / bc1,
    v / bc2 and the CPU's float64 sqrt of it: 24 B an element of the
    largest range) and one bucket's send and receive buffers (4 B each a
    float of `BUCKET`). It sends by all_to_all, and by nothing else, each
    element of the blocks it hands on once in float32, and to each rank
    the elements of its ZeRO ranges that lie in that rank's blocks in
    the weights' dtype, as the placements give them: every ZeRO rank's
    block (ZeRO rank s is (data s // 4, model s % 4)) read off the
    widened flat vector. Rank 0 hands on every leaf; rank 6 (data 1,
    model 2) none that the model ranks hold alike. An exchange that
    widens each block to its whole tensor fails both checks."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import reduced_config
    from repro_torch.convert import lm_param_tree
    from repro_torch.launch.dryrun import LiveBytes
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.models import get_model
    from repro_torch.sharding.collectives import CollectiveLog
    from repro_torch.sharding.layout import mesh_rules, placement
    from repro_torch.train.train_step import _varying_leaves
    monkeypatch.setattr(topt, "BUCKET", FAKE_BUCKET)
    cfg = reduced_config("dbrx-132b")
    mesh = make_rank_mesh(FAKE_MESH, rank, "cpu")
    Z = FAKE_MESH["data"] * FAKE_MESH["model"]
    adam = AdamWConfig()
    with FakeTensorMode():
        model = get_model(cfg)(cfg, device="cpu", seed=None, mesh=mesh)
        params = lm_param_tree(model)
        state = init_state(params, adam, mesh=mesh)
        leaves = list(topt.tree_leaves(params))
        hands_on = [v or mesh.coords["model"] == 0
                    for v in _varying_leaves(model, params)]
        it = iter(hands_on)

        def grad(leaf):
            if not next(it):
                return None
            gs = [torch.zeros(t.shape, dtype=t.dtype)
                  for t in topt._parts(leaf)]
            return gs if isinstance(leaf, list) else gs[0]
        grads = topt.tree_map(grad, params)
        tensors = list(model.parameters()) + [
            t for f in (state.master, state.m, state.v)
            for leaf in topt.tree_leaves(f) for t in topt._parts(leaf)] + [
            t for leaf in topt.tree_leaves(grads) if leaf is not None
            for t in topt._parts(leaf)]
        args = sum(t.numel() * t.element_size() for t in tensors)
        live = LiveBytes(baseline=args)
        with live, CollectiveLog() as log:
            apply_updates(params, grads, state, adam, mesh=mesh)
    temp = live.peak - args
    pers = [topt.zero_share(topt._pad_len(topt.leaf_size(p)), Z)
            for p in leaves]
    largest = 4 * max(topt.leaf_size(p) for p in leaves)
    bound = 4 * sum(pers) + 24 * max(pers) + 8 * FAKE_BUCKET
    assert 0 < temp < largest and temp <= bound, (temp, largest, bound)

    rules = mesh_rules(mesh)
    coords = [dict(data=s // 4, model=s % 4) for s in range(Z)]
    want = 0
    for p, per, gives in zip(leaves, pers, hands_on):
        parts = topt._parts(p)
        if gives:
            want += 4 * sum(t.numel() for t in parts)
        lo, hi, at = rank * per, (rank + 1) * per, 0
        for t in parts:
            pl = placement(t)
            for c in coords:
                offs = widened_offsets(pl.shape, rules.block(
                    pl.shape, pl.spec, c), at)
                want += t.element_size() * int(((offs >= lo)
                                                 & (offs < hi)).sum())
            at += int(np.prod(pl.shape))
    assert log.bytes == {"all_to_all": want, "all_reduce": 4}, \
        (log.bytes, want)
