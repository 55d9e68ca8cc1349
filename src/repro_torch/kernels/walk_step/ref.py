"""Plain PyTorch versions of the fused walk step."""
from __future__ import annotations

import torch

from repro_torch.kernels.uniform.ref import uniform_ref


def _step(pos, alive, u_term, u_edge, row_ptr, col_idx, out_deg, eps):
    """(new_pos, survive, eid): eid = row_ptr[pos] + j, not clipped."""
    alive = alive.to(torch.bool)
    safe_pos = torch.clamp(pos, 0, out_deg.shape[0] - 1).long()
    deg = out_deg[safe_pos]
    survive = alive & (u_term >= eps) & (deg > 0)
    j = torch.minimum((u_edge * torch.clamp(deg, min=1).to(u_edge.dtype))
                      .to(torch.int32), torch.clamp(deg - 1, min=0))
    eid = row_ptr[safe_pos] + j
    dst = col_idx[torch.clamp(eid, 0, col_idx.shape[0] - 1).long()]
    new_pos = torch.where(survive, dst, pos)
    return new_pos.to(torch.int32), survive, eid


def walk_step_ref(pos, alive, u_term, u_edge, row_ptr, col_idx, out_deg, *,
                  eps: float):
    """(new_pos, new_alive) int32 [W]: one PageRank step per walk slot.

    A slot survives when it is alive, draws u_term >= eps and sits on a
    vertex with out-edges; it then moves along edge
    min(trunc(u_edge * deg), deg - 1). Other slots keep their position."""
    new_pos, survive, _ = _step(pos, alive, u_term, u_edge, row_ptr,
                                col_idx, out_deg, eps)
    return new_pos, survive.to(torch.int32)


def walk_step_keyed_ref(pos, alive, key_term, key_edge, row_ptr, col_idx,
                        out_deg, *, eps: float, edges: bool = False):
    """`walk_step_ref` on the uniforms `prng.uniform(key, (W,))` of the two
    keys: what the keyed kernel draws for itself. The draws take the plain
    version too, so no kernel is held against another. `new_alive` has
    the dtype of `alive` (int32 or bool). With `edges`, also the int32 [W]
    edge id row_ptr[pos] + j of each slot that moved, -1 where it did
    not."""
    W = pos.shape[0]
    u_term = uniform_ref(key_term, (W,), device=pos.device)
    u_edge = uniform_ref(key_edge, (W,), device=pos.device)
    new_pos, survive, eid = _step(pos, alive, u_term, u_edge, row_ptr,
                                  col_idx, out_deg, eps)
    new_alive = survive.to(alive.dtype)
    if not edges:
        return new_pos, new_alive
    return new_pos, new_alive, torch.where(survive, eid, -1).to(torch.int32)
