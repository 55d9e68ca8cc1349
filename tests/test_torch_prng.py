"""The port's threefry PRNG against `jax.random` (parity level: bit-exact).

`prng.uniform` on the CPU runs the `uniform` kernel's plain version,
`kernels/uniform/ref.py::uniform_ref`; both are held against
`jax.random.uniform` (the kernel itself is held against `uniform_ref` on
the card, in tests/test_torch_cuda.py)."""
import jax
import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.kernels.uniform.ref import uniform_ref

SEEDS = [0, 1, 7, 42, 12345, 2 ** 31 - 1, 2 ** 32 - 1, 2 ** 33 + 9, -1, -7]
SHAPES = [(0,), (1,), (7,), (128,), (1001,), (3, 5), (4, 0), (2, 3, 4)]


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_and_key_data(seed):
    jk = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed)
    assert tk.dtype == torch.uint32
    _same_bits(jk, tk.numpy())
    _same_bits(jax.random.key_data(jk), prng.key_data(tk).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [1, 2, 3, 8])
def test_split(seed, num):
    _same_bits(jax.random.split(jax.random.PRNGKey(seed), num),
               prng.split(prng.PRNGKey(seed), num).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for data in (0, 1, 99, 0x50525354, 2 ** 32 - 1):
        _same_bits(jax.random.fold_in(jk, data), prng.fold_in(tk, data).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    _same_bits(jax.random.uniform(jk, shape), prng.uniform(tk, shape).numpy())


@pytest.mark.parametrize("seed", [0, 3, 2 ** 32 - 1, -7])
@pytest.mark.parametrize("shape", [(0,), (5,), (1000,), (2, 3, 4)])
def test_uniform_ref(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    want = jax.random.uniform(jk, shape)
    _same_bits(want, uniform_ref(tk, shape).numpy())
    _same_bits(want, uniform_ref(tk, shape, device="cpu").numpy())


def test_chained_keys_stay_identical():
    """The engines' key threading: split -> split(3) -> uniform, repeated."""
    jk, tk = jax.random.PRNGKey(3), prng.PRNGKey(3)
    for _ in range(20):
        jk, jt, je = jax.random.split(jk, 3)
        tk, tt, te = prng.split(tk, 3)
        _same_bits(jax.random.uniform(jt, (33,)), prng.uniform(tt, 33).numpy())
        _same_bits(jax.random.uniform(je, (33,)), prng.uniform(te, 33).numpy())
        jk, _ = jax.random.split(jk)
        tk, _ = prng.split(tk)
    _same_bits(jk, tk.numpy())


def test_bad_key_shape_raises():
    with pytest.raises(ValueError):
        prng.split(torch.zeros(3, dtype=torch.uint32))
