"""Checkpointing with a manifest and an async writer.

Layout of a checkpoint directory, the same as the JAX package writes, so a
snapshot written by either package resumes in the other:

    <dir>/step_000042/
        manifest.json     — step, user metadata, flat keys, shapes/dtypes
        arrays.npz        — one entry per leaf ('/'-joined path keys)

A tree is nested dicts, lists, tuples and NamedTuples whose leaves are
tensors, numpy arrays or Python scalars; dict keys flatten in sorted
order, a NamedTuple's children under their field names (as JAX keys
them: `opt/step`, `opt/master/...`), a list's or tuple's under their
index. Writes go to a
temporary directory renamed into place, so a failure mid-write never
corrupts the latest snapshot. The async writer overlaps serialisation with
compute; the caller's tensors are copied to the host before it starts.

Over a mesh of several processes (`core.collectives.ProcessGroupMesh`)
every process calls `save` with the same tree, gathered over the mesh;
only the mesh's writer (rank 0) writes it, and every process then waits
at a barrier, so a snapshot is on disk for all of them once `save`
returns. Such saves are blocking.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


def pack_json(obj: Any) -> np.ndarray:
    """Encode a JSON-able host object (stage tags, telemetry accumulators)
    as a uint8 leaf, so a staged snapshot stays a tree of arrays."""
    return np.frombuffer(json.dumps(obj).encode("utf-8"),
                         dtype=np.uint8).copy()


def unpack_json(arr: Any) -> Any:
    return json.loads(np.asarray(arr, dtype=np.uint8)
                      .tobytes().decode("utf-8"))


def to_numpy(leaf: Any) -> np.ndarray:
    """A host numpy copy of a leaf (bfloat16 widens to float32, which numpy
    can store). The copy owns its memory: a CPU tensor is cloned, since
    `.cpu()` and `.numpy()` would share its storage and the async writer
    would save whatever the caller writes into it later; a card tensor's
    `.cpu()` is already a copy."""
    if isinstance(leaf, torch.Tensor):
        src = leaf.detach()
        host = src.cpu()
        if host.dtype == torch.bfloat16:
            host = host.float()
        elif (host.untyped_storage().data_ptr()
              == src.untyped_storage().data_ptr()):
            host = host.clone()
        return host.numpy()
    return np.asarray(leaf)


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _items(tree: Any, prefix: str = ""):
    """(path, leaf) pairs of a tree, in the order JAX flattens it."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}{k}/")
    elif _is_namedtuple(tree):
        for k, v in zip(tree._fields, tree):
            yield from _items(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, f"{prefix}{i}/")
    elif tree is not None:
        yield (prefix[:-1] or "leaf"), tree


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {k: to_numpy(v) for k, v in _items(tree)}


class Checkpointer:
    def __init__(self, base_dir: str, *, keep_last: int = 3, mesh=None):
        self.base_dir = base_dir
        self.keep_last = keep_last
        self.mesh = mesh
        os.makedirs(base_dir, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -------------------------------------------------- save
    def save(self, step: int, tree: Any, *, metadata: Optional[dict] = None,
             blocking: bool = True) -> str:
        flat = _flatten(tree)
        meta = dict(step=int(step), time=time.time(),
                    metadata=metadata or {},
                    keys={k: [list(v.shape), str(v.dtype)]
                          for k, v in flat.items()})
        final = os.path.join(self.base_dir, f"step_{step:09d}")

        def _write():
            tmp = final + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        self.wait()
        if self.mesh is not None:
            if not blocking:
                raise ValueError("a snapshot over a mesh is written "
                                 "blocking")
            if self.mesh.writer:
                _write()
            self.mesh.barrier()
        elif blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        return final

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def clear(self):
        """Remove every snapshot: a run that starts from round 0 must never
        recover from a stale snapshot left in a reused directory."""
        self.wait()
        for name in os.listdir(self.base_dir):
            if name.startswith("step_"):
                shutil.rmtree(os.path.join(self.base_dir, name),
                              ignore_errors=True)

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep_last] if self.keep_last else []:
            shutil.rmtree(os.path.join(self.base_dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # -------------------------------------------------- restore
    def all_steps(self):
        return sorted(int(name[5:]) for name in os.listdir(self.base_dir)
                      if name.startswith("step_")
                      and not name.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> tuple[dict, dict]:
        """Returns (flat {path: np.ndarray}, manifest)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.base_dir}")
        d = os.path.join(self.base_dir, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        return flat, manifest


def restore_into(tree: Any, flat: Dict[str, np.ndarray]) -> Any:
    """Rebuild `tree`'s structure from a flat snapshot: a tensor leaf comes
    back as a tensor of its dtype and device, any other leaf as a numpy
    array."""
    def rebuild(node, prefix):
        if isinstance(node, dict):
            return {k: rebuild(node[k], f"{prefix}{k}/") for k in node}
        if _is_namedtuple(node):
            return type(node)(*(rebuild(v, f"{prefix}{k}/")
                                for k, v in zip(node._fields, node)))
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v, f"{prefix}{i}/")
                              for i, v in enumerate(node))
        if node is None:
            return None
        arr = flat[prefix[:-1] or "leaf"]
        if isinstance(node, torch.Tensor):
            return torch.from_numpy(np.array(arr)).to(device=node.device,
                                                      dtype=node.dtype)
        return arr

    return rebuild(tree, "")
