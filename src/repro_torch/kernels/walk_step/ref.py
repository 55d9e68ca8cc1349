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


def walk_step_keyed_ref_(pos, alive, key_term, key_edge, row_ptr, col_idx,
                         out_deg, *, eps: float, edge=None, arrivals=None):
    """In place: `walk_step_ref` on the uniforms `prng.uniform(key, (W,))`
    of the two keys, what the keyed kernel draws for itself (the draws take
    the plain version too, so no kernel is held against another). A
    survivor's `pos` gets its new vertex and a slot that ends gets
    `alive` = 0; nothing else of them changes. `edge` (int32 [W]) gets
    row_ptr[pos] + j where the slot moved, -1 elsewhere; `arrivals`
    (int32 [W]) gets the survivors' new vertices in its first entries, here
    in slot order. Returns the int64 [1] count of them with `arrivals`,
    else None."""
    W = pos.shape[0]
    u_term = uniform_ref(key_term, (W,), device=pos.device)
    u_edge = uniform_ref(key_edge, (W,), device=pos.device)
    new_pos, survive, eid = _step(pos, alive, u_term, u_edge, row_ptr,
                                  col_idx, out_deg, eps)
    del u_term, u_edge
    alive.masked_fill_(~survive, 0)
    pos.copy_(new_pos)
    if edge is not None:
        edge.copy_(torch.where(survive, eid, -1))
    if arrivals is None:
        return None
    moved = new_pos[survive]
    arrivals[:moved.shape[0]] = moved
    return torch.tensor([moved.shape[0]], dtype=torch.int64,
                        device=pos.device)


def walk_step_keyed_ref(pos, alive, key_term, key_edge, row_ptr, col_idx,
                        out_deg, *, eps: float, edges: bool = False):
    """`walk_step_keyed_ref_` on copies of `pos` and `alive`: (new_pos,
    new_alive), `new_alive` of the dtype of `alive`, and with `edges` the
    int32 [W] edge ids."""
    new_pos, new_alive = pos.clone(), alive.clone()
    edge = torch.empty_like(pos) if edges else None
    walk_step_keyed_ref_(new_pos, new_alive, key_term, key_edge, row_ptr,
                         col_idx, out_deg, eps=eps, edge=edge)
    return (new_pos, new_alive, edge) if edges else (new_pos, new_alive)
