"""The port's CUDA kernels against their plain torch versions, on the card.

Each test needs a CUDA device and skips without one (the kernels have no
CPU mode). Every test carries the `cuda` marker. This file imports no JAX, so the
card's machine runs it as is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Parity levels: histogram and integer segment_spmv bit-exact;
multinomial_rows bit-exact against its plain version on the same card (no
FMA contraction on either side); float segment_spmv within 1e-5 relative
of a float64 sum (atomic order).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import common
from repro_torch.kernels.histogram import histogram
from repro_torch.kernels.histogram.ref import histogram_ref
from repro_torch.kernels.multinomial_rows import multinomial_rows
from repro_torch.kernels.multinomial_rows.ref import multinomial_rows_ref
from repro_torch.kernels.segment_spmv import segment_spmv
from repro_torch.kernels.segment_spmv.ref import segment_spmv_ref

KEY_WORDS = (0xDEADBEEF, 0x12345678)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The card; decided here, not at import, so every worker collects the
    same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _skewed_ids(rng, W, n, hub_share):
    """Ids in [-1, n] with `hub_share` of them on vertex 0 (a web hub)."""
    ids = rng.integers(-1, n + 1, W)
    ids[rng.random(W) < hub_share] = 0
    return torch.from_numpy(ids.astype(np.int32))


def test_cuda_histogram_matches_plain(cuda):
    rng = np.random.default_rng(1)
    # shared-memory counters (n small) and global atomics (n large), with
    # and without a hub
    for W, n, hub in ((1 << 20, 4096, 0.0), (1 << 20, 4096, 0.2),
                      (1 << 20, 1 << 16, 0.2), (1000, 1, 0.0), (0, 5, 0.0)):
        ids = _skewed_ids(rng, W, n, hub)
        before = common.launches["histogram"]
        got = histogram(ids.to(cuda), n)
        assert common.launches["histogram"] == before + 1
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      histogram_ref(ids, n).numpy())


def test_cuda_segment_spmv_matches_plain(cuda):
    rng = np.random.default_rng(2)
    for hub in (0.0, 0.2):
        dst = _skewed_ids(rng, 1 << 20, 5000, hub)
        val = torch.from_numpy(rng.random(1 << 20).astype(np.float32))
        got = segment_spmv(val.to(cuda), dst.to(cuda), 5000).cpu()
        want = segment_spmv_ref(val.double(), dst, 5000)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)
        # bound None: float path, exact while every sum stays below 2**24
        for bound, hi in ((None, 2 ** 6), (2 ** 31 - 1, 2 ** 10)):
            ival = torch.from_numpy(
                rng.integers(0, hi, 1 << 20).astype(np.int32))
            got = segment_spmv(ival.to(cuda), dst.to(cuda), 5000,
                               count_bound=bound).cpu()
            np.testing.assert_array_equal(
                got.numpy(), segment_spmv(ival, dst, 5000,
                                          count_bound=bound).numpy())


def test_cuda_multinomial_matches_plain(cuda):
    rng = np.random.default_rng(3)
    for hi, width in ((21, 8), (2 ** 20, 8), (2 ** 28, 17)):
        counts = rng.integers(0, hi, 50000).astype(np.int32)
        deg = rng.integers(0, width + 1, 50000).astype(np.int32)
        rid = np.arange(50000, dtype=np.int32)
        args = [torch.from_numpy(a).to(cuda) for a in (counts, deg, rid)]
        got = multinomial_rows(*args, KEY_WORDS, eps=0.2,
                               width=width).cpu().numpy()
        want = multinomial_rows_ref(*args, KEY_WORDS, eps=0.2,
                                    width=width).cpu().numpy()
        np.testing.assert_array_equal(got.sum(axis=1), counts)
        np.testing.assert_array_equal(got, want)


def test_cuda_wrappers_refuse_bad_inputs(cuda):
    with pytest.raises(ValueError):
        histogram(torch.zeros(4, dtype=torch.int64, device=cuda), 3)
    with pytest.raises(ValueError):
        segment_spmv(torch.zeros(4, device=cuda),
                     torch.zeros(3, dtype=torch.int32, device=cuda), 3)
