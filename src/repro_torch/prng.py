"""Threefry-2x32 PRNG keys, bit-identical to `jax.random` in partitionable
mode (the default of jax 0.9).

A key is a uint32 tensor of shape [2] that lives on the host and is passed
explicitly, as JAX passes its keys. `uniform` draws on any device: on a
CUDA device through the `uniform` kernel, elsewhere through its plain
version. The plain uint32 arithmetic runs in int64 masked with 0xFFFFFFFF,
because torch's uint32 tensors support neither `+` nor `>>` on the CPU.

Counter layout (partitionable mode): element i of a draw of shape S uses
the 64-bit counter i (row-major flat index), split into the words
(i >> 32, i & 0xFFFFFFFF); `split(key, num)` returns the two output words
of counters 0..num-1 as the new keys; `uniform` takes the xor of the two
words as its 32 random bits.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# The CONGEST auditor's RNG recorder (`analysis.congest.RecordingMesh`
# installs it inside each program call): called as RNG_RECORDER((k0, k1),
# what) for every consumption of a key, a split or a draw, here and in the
# kernels that draw from key words. None outside an audit. `fold_in`
# derives a key without consuming one, as in JAX.
RNG_RECORDER = None


def record_use(key, what: str) -> None:
    """Report the consumption of `key` (a [2] key, a [S, 2] tensor of
    per-shard keys, or a (k0, k1) pair) to the recorder, if one is
    installed."""
    if RNG_RECORDER is None:
        return
    if isinstance(key, torch.Tensor):
        rows = key.to(torch.int64).reshape(-1, 2).tolist()
    else:
        rows = [key]
    for k0, k1 in rows:
        RNG_RECORDER((int(k0) & _M32, int(k1) & _M32), what)


def _words(key: torch.Tensor) -> Tuple[int, int]:
    if tuple(key.shape) != (2,):
        raise ValueError(f"a PRNG key has shape (2,), got {tuple(key.shape)}")
    k0, k1 = (int(w) for w in key.to(torch.int64).tolist())
    return k0 & _M32, k1 & _M32


def _key(w0, w1) -> torch.Tensor:
    return torch.tensor([int(w0) & _M32, int(w1) & _M32],
                        dtype=torch.int64).to(torch.uint32)


def threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of the counter words x0, x1 (int64 tensors
    holding uint32 values) under the key words (k0, k1)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]).bitwise_and_(_M32)
    x1 = (x1 + ks[1]).bitwise_and_(_M32)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_M32)
            low = x1 >> (32 - r)
            x1.bitwise_left_shift_(r).bitwise_and_(_M32).bitwise_or_(low)
            x1.bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(_M32)
    return x0, x1


def _counter_words(size: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    idx = torch.arange(size, dtype=torch.int64, device=device)
    return idx >> 32, idx.bitwise_and_(_M32)


def PRNGKey(seed: int) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` with x64 off: [0, seed mod 2**32]."""
    return _key(0, int(seed))


def key_data(key: torch.Tensor) -> torch.Tensor:
    """The raw uint32 words of a key (a key already is its data)."""
    _words(key)
    return key


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split`: uint32 [num, 2] new keys."""
    k0, k1 = _words(key)
    record_use((k0, k1), "split")
    hi, lo = _counter_words(int(num), "cpu")
    b0, b1 = threefry2x32(k0, k1, hi, lo)
    return torch.stack([b0, b1], dim=1).to(torch.uint32)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """`jax.random.fold_in`: a new key from a key and a 32-bit integer."""
    k0, k1 = _words(key)
    b0, b1 = threefry2x32(k0, k1, torch.zeros(1, dtype=torch.int64),
                          torch.tensor([int(data) & _M32], dtype=torch.int64))
    return _key(b0.item(), b1.item())


def uniform(key: torch.Tensor, shape: Sequence[int] | int = (), *,
            device=None) -> torch.Tensor:
    """`jax.random.uniform(key, shape)`: float32 in [0, 1) on `device`
    (the host when None). A CUDA device draws with the `uniform` kernel,
    the CPU with its plain version (`kernels/uniform/ref.py`)."""
    # imported here: the kernel's modules import this one
    from repro_torch.kernels.uniform import uniform as draw
    record_use(key, "uniform")
    return draw(key, shape, device=device)
