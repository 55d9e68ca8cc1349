"""Walk-step wrappers: the CUDA kernel for CUDA tensors, the plain version
for CPU tensors."""
from __future__ import annotations

import ctypes

import torch

from repro_torch import prng
from repro_torch.kernels import common
from repro_torch.kernels.multinomial_rows._math import key_words
from repro_torch.kernels.walk_step.ref import (walk_step_keyed_ref,
                                               walk_step_ref)

_ptr, _i64, _int = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _check(pos, alive, row_ptr, col_idx, out_deg, floats=(),
           alive_dtype=torch.int32):
    common.require(pos.device.type == "cuda",
                   f"walk_step: unsupported device {pos.device}")
    W = pos.numel()
    for name, t, dtype in (("pos", pos, torch.int32),
                           ("alive", alive, alive_dtype),
                           *[(f"u{i}", u, torch.float32)
                             for i, u in enumerate(floats)]):
        common.require(t.device == pos.device and t.dtype == dtype
                       and t.shape == (W,) and t.is_contiguous(),
                       f"walk_step: {name} must be a contiguous 1-D {dtype} "
                       f"tensor of {W} slots on {pos.device}")
    for name, t in (("row_ptr", row_ptr), ("col_idx", col_idx),
                    ("out_deg", out_deg)):
        common.require(t.device == pos.device and t.dtype == torch.int32
                       and t.dim() == 1 and t.is_contiguous(),
                       f"walk_step: {name} must be a contiguous 1-D int32 "
                       f"tensor on {pos.device}")
    n = out_deg.numel()
    common.require(0 < n < 2 ** 31 and row_ptr.numel() >= n
                   and col_idx.numel() > 0,
                   "walk_step: empty or oversized graph tables")
    return W, n


def _launch(entry: str, args, argtypes, pos, outs):
    """Launch `entry` on `args` and the output tensors `outs` (None passes
    a null pointer); returns the outputs that are not None."""
    fn = getattr(common.library("walk_step"), entry)
    fn.argtypes = [*argtypes, *[_ptr] * len(outs), _int, _ptr]
    fn.restype = ctypes.c_int
    stream, sms = common.launch_args(pos)
    with torch.cuda.device(pos.device):
        err = fn(*args, *[None if t is None else t.data_ptr() for t in outs],
                 sms, stream)
    common.check_launch("walk_step", err)
    common.launches["walk_step"] += 1
    return tuple(t for t in outs if t is not None)


def walk_step(pos, alive, u_term, u_edge, row_ptr, col_idx, out_deg, *,
              eps: float):
    """(new_pos, new_alive) int32 [W] from given uniforms (entry (a))."""
    if pos.device.type == "cpu":
        return walk_step_ref(pos, alive, u_term, u_edge, row_ptr, col_idx,
                             out_deg, eps=eps)
    W, n = _check(pos, alive, row_ptr, col_idx, out_deg, (u_term, u_edge))
    return _launch(
        "walk_step_launch",
        (pos.data_ptr(), alive.data_ptr(), u_term.data_ptr(),
         u_edge.data_ptr(), row_ptr.data_ptr(), col_idx.data_ptr(),
         out_deg.data_ptr(), W, n, col_idx.numel(), float(eps)),
        [_ptr] * 7 + [_i64, _int, _i64, ctypes.c_float], pos,
        [torch.empty_like(pos), torch.empty_like(pos)])


def walk_step_keyed(pos, alive, key_term, key_edge, row_ptr, col_idx,
                    out_deg, *, eps: float, edges: bool = False):
    """(new_pos, new_alive) [W], drawing u_term and u_edge as
    `prng.uniform(key, (W,))` of the two PRNG keys (entry (b)). `alive`
    and `new_alive` are int32 (the sharded engines) or bool (the
    single-device engines). With `edges`, also the int32 [W] edge id
    row_ptr[pos] + j of each slot that moved, -1 where it did not (the
    same launch)."""
    prng.record_use(key_term, "walk_step")
    prng.record_use(key_edge, "walk_step")
    if pos.device.type == "cpu":
        return walk_step_keyed_ref(pos, alive, key_term, key_edge, row_ptr,
                                   col_idx, out_deg, eps=eps, edges=edges)
    alive_dtype = torch.bool if alive.dtype == torch.bool else torch.int32
    W, n = _check(pos, alive, row_ptr, col_idx, out_deg,
                  alive_dtype=alive_dtype)
    kt, ke = key_words(key_term), key_words(key_edge)
    u32 = ctypes.c_uint32
    return _launch(
        "walk_step_keyed_launch",
        (pos.data_ptr(), alive.data_ptr(), *kt, *ke, row_ptr.data_ptr(),
         col_idx.data_ptr(), out_deg.data_ptr(), W, n, col_idx.numel(),
         float(eps), alive.element_size()),
        [_ptr, _ptr, u32, u32, u32, u32, _ptr, _ptr, _ptr, _i64, _int, _i64,
         ctypes.c_float, _int], pos,
        [torch.empty_like(pos), torch.empty_like(alive),
         torch.empty_like(pos) if edges else None])
