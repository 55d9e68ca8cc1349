"""Carrying state across from the JAX package, as numpy arrays.

The graph is this system's "weights": with the same CSR arrays and the same
PRNG key, the port computes what the JAX package computes. The sharded
engines' states carry over too, so a run started by one package can be
continued by the other. The LMs' parameter trees carry over as well, both
ways (`lm_params_from_numpy`, `lm_params_to_numpy`), and so does the
AdamW state of a training run (`adam_state_from_numpy`).
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
    load_lm_params(model, tree)
    return model


def load_lm_params(model, tree: dict) -> None:
    """Copy a JAX parameter tree (nested dicts of float32 numpy arrays)
    into `model`'s parameters; raises as `lm_params_from_numpy`."""
    params = dict(model.named_parameters())
    flat = _flatten_lm_tree(tree)
    missing = sorted(set(params) - set(flat))
    extra = sorted(set(flat) - set(params))
    if missing or extra:
        raise ValueError(f"{model.cfg.name}: parameter tree does not match "
                         f"the model: missing {missing}, extra {extra}")
    for name, arr in flat.items():
        p = params[name]
        if arr.dtype != np.float32:
            raise TypeError(f"{name}: dtype {arr.dtype}, expected float32 "
                            "(widen bf16 leaves first)")
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)}, the model "
                             f"has {tuple(p.shape)}")
    with torch.no_grad():
        for name, arr in flat.items():
            params[name].copy_(torch.from_numpy(np.array(arr)))


class Stack(list):
    """The per-layer tensors of one stacked JAX leaf, in JAX's order
    (row-major over `lead`, the leaf's leading layer dims)."""

    def __init__(self, tensors, lead):
        super().__init__(tensors)
        self.lead = tuple(lead)


def lm_param_tree(model) -> dict:
    """`model`'s parameters in the JAX package's tree: nested dicts of
    JAX's names, whose leaves are the parameters, or a `Stack` of them
    where JAX stacks layers into one leaf ([L, ...], RG-LRU's
    `groups.rec` [G, n_rec, ...]). The tree the optimizer keeps its
    state by."""
    grouped = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        path, index = [parts[0]], ()
        rest = parts[1:]
        if parts[0] in _LM_STACKS:
            index, rest = (int(rest[0]),), rest[1:]
            if rest[0] in _LM_STACKS[parts[0]]:
                path.append(rest[0])
                index, rest = index + (int(rest[1]),), rest[2:]
        grouped.setdefault(tuple(path + rest), []).append((index, p))
    tree = {}
    for path, entries in grouped.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        if entries[0][0]:
            entries.sort(key=lambda e: e[0])
            lead = tuple(max(e[0][k] for e in entries) + 1
                         for k in range(len(entries[0][0])))
            node[path[-1]] = Stack([p for _, p in entries], lead)
        else:
            node[path[-1]] = entries[0][1]
    return tree


def _leaf_to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, Stack):
        arr = np.stack([_leaf_to_numpy(t) for t in leaf])
        return arr.reshape(leaf.lead + arr.shape[1:])
    return leaf.detach().float().cpu().numpy()


def lm_tree_to_numpy(tree) -> dict:
    """A tree of `lm_param_tree`'s layout (the parameters, or tensors of
    their shapes such as gradients) as float32 numpy arrays, each `Stack`
    stacked into JAX's leaf."""
    from repro_torch.train.optimizer import tree_map
    return tree_map(_leaf_to_numpy, tree)


def lm_params_to_numpy(model) -> dict:
    """The inverse of `lm_params_from_numpy`: `model`'s weights as the JAX
    package's parameter tree, nested dicts of float32 numpy arrays (bf16
    widened exactly), layer stacks re-stacked."""
    return lm_tree_to_numpy(lm_param_tree(model))


def adam_state_from_numpy(model, state_tree):
    """The port's `AdamState` for `model`'s parameters (`lm_param_tree`)
    from a JAX `AdamState` given as numpy: an object with fields, or a
    dict, of `step`, `master`, `m`, `v` (int8 moments as (codes, scales)
    pairs). Raises where a leaf is missing or its length is not the
    padded length of its parameter leaf."""
    from repro_torch.train.optimizer import (AdamState, _pad_len,
                                             leaf_size)

    def field(name):
        return (state_tree[name] if isinstance(state_tree, dict)
                else getattr(state_tree, name))

    params = lm_param_tree(model)
    device = next(model.parameters()).device

    def put(arr, dtype):
        return torch.from_numpy(np.array(arr)).to(device=device,
                                                  dtype=dtype)

    def carry(params, tree, where):
        if sorted(params) != sorted(tree):
            raise ValueError(f"{where}: keys {sorted(tree)}, the model "
                             f"has {sorted(params)}")
        out = {}
        for k, p in params.items():
            if isinstance(p, dict):
                out[k] = carry(p, tree[k], f"{where}/{k}")
                continue
            n = _pad_len(leaf_size(p))
            leaf = tree[k]
            if isinstance(leaf, (tuple, list)):
                q, scale = leaf
                if np.shape(q) != (n,):
                    raise ValueError(f"{where}/{k}: {np.shape(q)} codes, "
                                     f"expected ({n},)")
                out[k] = (put(q, torch.int8), put(scale, torch.float32))
            else:
                if np.shape(leaf) != (n,):
                    raise ValueError(f"{where}/{k}: shape {np.shape(leaf)},"
                                     f" expected ({n},)")
                out[k] = put(leaf, torch.float32)
        return out

    return AdamState(step=put(field("step"), torch.int32),
                     master=carry(params, field("master"), "master"),
                     m=carry(params, field("m"), "m"),
                     v=carry(params, field("v"), "v"))
