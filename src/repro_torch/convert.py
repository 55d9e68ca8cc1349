"""Carrying state across from the JAX package, as numpy arrays.

The graph is this system's "weights": with the same CSR arrays and the same
PRNG key, the port computes what the JAX package computes. The sharded
engines' states carry over too, so a run started by one package can be
continued by the other. The LMs' parameter trees carry over as well
(`lm_params_from_numpy`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.collectives import StackedMesh
from repro_torch.core.distributed import state_from_host
from repro_torch.core.graph import CSRGraph
from repro_torch.device import resolve_device
from repro_torch.runtime import staged_from_host


def graph_from_numpy(row_ptr, col_idx, out_deg, n: int, m: int,
                     undirected: bool, device=None) -> CSRGraph:
    """A CSRGraph on `device` (the card when None) from the int32 CSR
    arrays of a JAX `CSRGraph`."""
    device = resolve_device(device)
    row_ptr, col_idx, out_deg = (np.array(a, dtype=np.int32)
                                 for a in (row_ptr, col_idx, out_deg))
    if row_ptr.shape != (n + 1,) or col_idx.shape != (m,) \
            or out_deg.shape != (n,):
        raise ValueError("CSR arrays do not match n and m")
    return CSRGraph(row_ptr=torch.from_numpy(row_ptr).to(device),
                    col_idx=torch.from_numpy(col_idx).to(device),
                    out_deg=torch.from_numpy(out_deg).to(device),
                    n=int(n), m=int(m), undirected=bool(undirected))


def key_from_numpy(key_u32x2) -> torch.Tensor:
    """A port PRNG key from the two uint32 words of a JAX PRNG key."""
    words = np.asarray(key_u32x2, dtype=np.uint32).reshape(-1)
    if words.shape != (2,):
        raise ValueError(f"a PRNG key has 2 words, got {words.shape}")
    return torch.from_numpy(words.copy())


def dist_state_from_numpy(d: dict, device=None):
    """The walk engine's `DistState` on a stacked mesh on `device` (the
    card when None) from the dict the JAX package's
    `distributed.state_to_host` gives (or its snapshot restores): both
    packages then continue the same trajectory."""
    return state_from_host(d, StackedMesh(np.asarray(d["pos"]).shape[0],
                                          device))


def count_state_from_numpy(flat: dict, device=None):
    """The count engine's `StagedState` on `device` (the card when None)
    from a flat snapshot of the JAX package's count engine, as its
    `Checkpointer.restore` gives it. The layout schema and shard count
    stay unset: the engine supplies them when it resumes."""
    device = resolve_device(device)

    def put(name, arr):
        t = torch.from_numpy(np.array(arr))
        return t if name in ("key", "round") else t.to(device)

    return staged_from_host(flat, put)


# The JAX package's layer stacks (leading dim = layer), by top-level name,
# and the stacks nested in one of their entries: RG-LRU's `groups.rec` is
# [G, n_rec, ...], a stack within each group.
_LM_STACKS = {"dense_layers": (), "moe_layers": (), "layers": (),
              "groups": ("rec",), "trailing": (), "enc_layers": (),
              "dec_layers": ()}


def _flatten_lm_tree(tree, prefix="", stacks=_LM_STACKS):
    """{'a': {'b': x}} -> {'a.b': x}; the leaves of a layer stack (leading
    dim L) split into one entry a layer, `layers.{i}.…`, as the port's
    modules name them; a stack nested in a layer (`groups.{g}.rec`)
    splits again."""
    flat = {}
    for name, sub in tree.items():
        path = f"{prefix}{name}"
        if not isinstance(sub, dict):
            flat[path] = np.asarray(sub)
        elif name in stacks:
            inner = dict.fromkeys(stacks[name], ())
            for i in range(_stack_len(sub)):
                flat.update(_flatten_lm_tree(_index_tree(sub, i),
                                             f"{path}.{i}.", inner))
        else:
            flat.update(_flatten_lm_tree(sub, path + ".", {}))
    return flat


def _stack_len(tree) -> int:
    """The leading dim of a stack's leaves (its first leaf's)."""
    sub = next(iter(tree.values()))
    return _stack_len(sub) if isinstance(sub, dict) else len(sub)


def _index_tree(tree, i):
    """Entry i of every leaf's leading dim."""
    return {name: _index_tree(sub, i) if isinstance(sub, dict)
            else np.asarray(sub)[i] for name, sub in tree.items()}


def lm_params_from_numpy(cfg, tree: dict, device=None):
    """The port's model of `cfg` on `device` (the card when None) with the
    weights of a JAX model's parameter tree (`init_params(cfg, key)[0]`),
    given as nested dicts of float32 numpy arrays.

    bf16 leaves are widened to float32 by the caller (exact); each is cast
    to its parameter's dtype here (exact for values that came from bf16).
    Raises on a leaf that is missing, extra, misshapen or not float32."""
    from repro_torch.models import get_model

    model = get_model(cfg)(cfg, device=device, seed=None)
    params = dict(model.named_parameters())
    flat = _flatten_lm_tree(tree)
    missing = sorted(set(params) - set(flat))
    extra = sorted(set(flat) - set(params))
    if missing or extra:
        raise ValueError(f"{cfg.name}: parameter tree does not match the "
                         f"model: missing {missing}, extra {extra}")
    for name, arr in flat.items():
        p = params[name]
        if arr.dtype != np.float32:
            raise TypeError(f"{name}: dtype {arr.dtype}, expected float32 "
                            "(widen bf16 leaves first)")
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)}, the model "
                             f"has {tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.array(arr)))
    return model
