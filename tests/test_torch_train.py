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


@pytest.mark.parametrize("rows,per,bucket", [(4, 384, 128), (3, 640, 256),
                                             (8, 136, 128)])
def test_whole_rows_of_blocks_equal_the_flat_leaf(rows, per, bucket):
    """The ZeRO exchange's reader and writer of a leaf whose parts are
    blocks (`sharding.layout`), a whole tensor, or non-contiguous values:
    every bucket's rows read as the leaf's flat vector of whole tensors
    (zeros outside this rank's blocks, and past the end) reads them, and
    writing the flat vector back by rows leaves each part its own block
    of it (level 1). Rows lying whole inside a part take the strided
    path, the others the per-row one."""
    from repro_torch.sharding.layout import Placement
    from repro_torch.sharding.rules import PartitionSpec
    gen = torch.Generator().manual_seed(rows)
    shapes = [(6, 40), (6, 40), (5, 7), (300,), (6, 40)]
    parts, wholes = [], []
    for k, shape in enumerate(shapes):
        full = torch.randn(shape, generator=gen)
        if k == 2:                       # whole, read through a transpose
            t = full.t().contiguous().t()
            wholes.append(full)
        else:
            index = ((slice(2, 4), slice(8, 16)) if len(shape) == 2
                     else (slice(100, 200),))
            t = full[index].clone()
            t.placement = Placement(None, PartitionSpec(), shape, index)
            w = torch.zeros(shape)
            w[index] = t
            wholes.append(w)
        parts.append(t)
    flat = torch.cat([w.reshape(-1) for w in wholes])
    assert rows * per >= flat.numel()
    ref = torch.zeros(rows * per)
    ref[:flat.numel()] = flat
    whole = topt._Whole(parts)
    for lo in range(0, per, bucket):
        m = min(bucket, per - lo)
        out = torch.empty(rows, m)
        whole.read_rows(lo, per, out)
        want = ref.view(rows, per)[:, lo:lo + m]
        assert torch.equal(out, want)
    assert not whole.open
    targets = [torch.zeros_like(t) if k != 2 else torch.zeros(shapes[2])
               for k, t in enumerate(parts)]
    for t, p in zip(targets, parts):
        if hasattr(p, "placement"):
            t.placement = p.placement
    new = torch.randn(rows * per, generator=gen)
    writer = topt._Whole(targets)
    for lo in range(0, per, bucket):
        m = min(bucket, per - lo)
        writer.write_rows(lo, per, new.view(rows, per)[:, lo:lo + m]
                          .contiguous())
    assert not writer.open
    at = 0
    for k, (t, shape) in enumerate(zip(targets, shapes)):
        n = int(np.prod(shape))
        piece = new[at:at + n].reshape(shape)
        want = piece if k == 2 else piece[t.placement.index]
        assert torch.equal(t, want), k
        at += n
