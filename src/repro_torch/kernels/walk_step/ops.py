"""Walk-step wrappers: the CUDA kernel for CUDA tensors, the plain version
for CPU tensors."""
from __future__ import annotations

import ctypes

import torch

from repro_torch import prng
from repro_torch.kernels import common
from repro_torch.kernels.multinomial_rows._math import key_words
from repro_torch.kernels.walk_step.ref import (walk_step_keyed_ref_,
                                               walk_step_ref)

_ptr, _i64, _int = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

# slots a block of the in-place kernel steps (walk_step.cu: kTile)
TILE = 4096


def _check(pos, alive, row_ptr, col_idx, out_deg, floats=(),
           alive_dtype=torch.int32, outs=()):
    common.require(pos.device.type == "cuda",
                   f"walk_step: unsupported device {pos.device}")
    W = pos.numel()
    for name, t, dtype in (("pos", pos, torch.int32),
                           ("alive", alive, alive_dtype),
                           *[(f"u{i}", u, torch.float32)
                             for i, u in enumerate(floats)],
                           *[(name, t, torch.int32) for name, t in outs
                             if t is not None]):
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


def _launch(entry: str, args, argtypes, pos):
    """Launch `entry` on `args` (None passes a null pointer), the SM count
    and the stream; count the launch."""
    fn = getattr(common.library("walk_step"), entry)
    fn.argtypes = [*argtypes, _int, _ptr]
    fn.restype = ctypes.c_int
    stream, sms = common.launch_args(pos)
    with torch.cuda.device(pos.device):
        err = fn(*args, sms, stream)
    common.check_launch("walk_step", err)
    common.launches["walk_step"] += 1


def _data(t):
    return None if t is None else t.data_ptr()


def walk_step(pos, alive, u_term, u_edge, row_ptr, col_idx, out_deg, *,
              eps: float):
    """(new_pos, new_alive) int32 [W] from given uniforms (entry (a))."""
    if pos.device.type == "cpu":
        return walk_step_ref(pos, alive, u_term, u_edge, row_ptr, col_idx,
                             out_deg, eps=eps)
    W, n = _check(pos, alive, row_ptr, col_idx, out_deg, (u_term, u_edge))
    new_pos, new_alive = torch.empty_like(pos), torch.empty_like(pos)
    _launch("walk_step_launch",
            (pos.data_ptr(), alive.data_ptr(), u_term.data_ptr(),
             u_edge.data_ptr(), row_ptr.data_ptr(), col_idx.data_ptr(),
             out_deg.data_ptr(), W, n, col_idx.numel(), float(eps),
             new_pos.data_ptr(), new_alive.data_ptr()),
            [_ptr] * 7 + [_i64, _int, _i64, ctypes.c_float, _ptr, _ptr],
            pos)
    return new_pos, new_alive


def walk_step_keyed_(pos, alive, key_term, key_edge, row_ptr, col_idx,
                     out_deg, *, eps: float, edge=None, arrivals=None):
    """One step of every live walk, in place, drawing u_term and u_edge as
    `prng.uniform(key, (W,))` of the two PRNG keys (entry (b)).

    `pos` is int32 [W]; `alive` is bool (the engines) or int32 [W]. A
    survivor's `pos` gets its new vertex and a slot that ends gets
    `alive` = 0; a dead slot is read for its `alive` flag only and never
    written. `edge`, an int32 [W] output, gets the edge id
    row_ptr[pos] + j of each slot that moved and -1 elsewhere. `arrivals`,
    an int32 [W] buffer, gets each survivor's new vertex appended, in NO
    FIXED ORDER on the card (slot order on the CPU): only a consumer
    indifferent to order, such as a histogram, may read it. With
    `arrivals`, returns the int64 [1] count of the entries appended, on
    the device and without a host sync; else None."""
    prng.record_use(key_term, "walk_step")
    prng.record_use(key_edge, "walk_step")
    if pos.device.type == "cpu":
        return walk_step_keyed_ref_(pos, alive, key_term, key_edge, row_ptr,
                                    col_idx, out_deg, eps=eps, edge=edge,
                                    arrivals=arrivals)
    alive_dtype = torch.bool if alive.dtype == torch.bool else torch.int32
    W, n = _check(pos, alive, row_ptr, col_idx, out_deg,
                  alive_dtype=alive_dtype,
                  outs=(("edge", edge), ("arrivals", arrivals)))
    count = None if arrivals is None else torch.zeros(
        1, dtype=torch.int64, device=pos.device)
    kt, ke = key_words(key_term), key_words(key_edge)
    u32 = ctypes.c_uint32
    _launch("walk_step_keyed_launch",
            (pos.data_ptr(), alive.data_ptr(), *kt, *ke, row_ptr.data_ptr(),
             col_idx.data_ptr(), out_deg.data_ptr(), W, n, col_idx.numel(),
             float(eps), alive.element_size(), _data(edge), _data(arrivals),
             _data(count)),
            [_ptr, _ptr, u32, u32, u32, u32, _ptr, _ptr, _ptr, _i64, _int,
             _i64, ctypes.c_float, _int, _ptr, _ptr, _ptr], pos)
    return count


def walk_step_keyed(pos, alive, key_term, key_edge, row_ptr, col_idx,
                    out_deg, *, eps: float, edges: bool = False):
    """`walk_step_keyed_` on copies of `pos` and `alive`: (new_pos,
    new_alive) [W], `new_alive` of the dtype of `alive`, and with `edges`
    also the int32 [W] edge ids (the same launch)."""
    new_pos, new_alive = pos.clone(), alive.clone()
    edge = torch.empty_like(pos) if edges else None
    walk_step_keyed_(new_pos, new_alive, key_term, key_edge, row_ptr,
                     col_idx, out_deg, eps=eps, edge=edge)
    return (new_pos, new_alive, edge) if edges else (new_pos, new_alive)
