"""Continuous batching for LM serving.

A fixed number of decode slots; requests (prompt + max_new_tokens) are
admitted as slots free up, prefilled one at a time into their slot's
cache region, and all slots advance together through `decode_step`. The
JAX package's `repro.serve.batching`, on a model of `repro_torch.models`.

The cache is the model's cache with the slots as its batch dim (dim 1 of
a stacked [L, B, ...] leaf, dim 2 of RG-LRU's [G, n_rec, B, ...]
recurrent leaves); admission writes a batch-1 prefill cache into its
slot along each leaf's batch axis, and decode updates the cache in
place, all under `torch.inference_mode()`. Every slot decodes, a freed one included (its
stale token takes MoE capacity as it does in JAX).

Accounting is EXACT: the completion check runs after every token append,
the prefill-argmax token at admission included, so a request emits
precisely max_new_tokens tokens (a max_new_tokens=1 request completes at
admission and never holds a decode slot), `stats.tokens_out` counts every
emitted token, and `stats.steps`/`stats.max_active` reflect only decode
batches that actually ran.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [T] int32
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class ServeStats:
    steps: int = 0
    prefills: int = 0
    tokens_out: int = 0
    completed: int = 0
    max_active: int = 0


class ContinuousBatcher:
    """Serves `model` (a `repro_torch.models` model, on its device) with
    `slots` decode slots of `max_seq` positions each."""

    def __init__(self, model, *, slots: int, max_seq: int,
                 eos_id: Optional[int] = None):
        self.model = model
        self.slots = slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.active: List[Optional[Request]] = [None] * slots
        self.cache = model.init_cache(slots, max_seq)
        with torch.inference_mode():
            self.last_token = torch.zeros((slots, 1), dtype=torch.int64,
                                          device=model.device)
        self.stats = ServeStats()

    # ------------------------------------------------------------- admission
    def _write_slot(self, slot: int, pre_cache, tok: int) -> None:
        """Copy a batch-1 prefill cache into slot `slot` of the live cache,
        leaf by leaf along its batch axis: the first axis where the
        prefill leaf has 1 and the live leaf has `slots` (JAX's rule). A
        leaf of the live leaf's shape is taken whole."""
        def write(live, new):
            if isinstance(live, dict):
                for name in live:
                    write(live[name], new[name])
            elif new.shape == live.shape:
                live.copy_(new)
            else:
                for ax in range(live.ndim):
                    if new.shape[ax] == 1 and live.shape[ax] == self.slots:
                        live.narrow(ax, slot, 1).copy_(new)
                        break

        write(self.cache, pre_cache)
        self.last_token[slot, 0] = tok

    def _finished(self, req: Request, tok: int) -> bool:
        """Token-budget / EOS completion check — applied after EVERY
        append (admission included), so a request emits exactly
        max_new_tokens tokens and never holds a slot past its budget."""
        return (len(req.generated) >= req.max_new_tokens or
                (self.eos_id is not None and tok == self.eos_id))

    @torch.inference_mode()
    def submit(self, req: Request) -> bool:
        for s in range(self.slots):
            if self.active[s] is None:
                prompt = torch.as_tensor(np.asarray(req.prompt)[None, :],
                                         dtype=torch.int64,
                                         device=self.model.device)
                logits, pre_cache = self.model.prefill(
                    prompt, q_chunk=64, pad_cache_to=self.max_seq)
                tok = int(torch.argmax(logits[0, -1]))
                req.generated.append(tok)
                self.stats.prefills += 1
                self.stats.tokens_out += 1
                if self._finished(req, tok):
                    # satisfied by the prefill token alone: completed at
                    # admission, never occupies a decode slot
                    req.done = True
                    self.stats.completed += 1
                    return True
                self._write_slot(s, pre_cache, tok)
                self.active[s] = req
                return True
        return False

    # ------------------------------------------------------------- stepping
    @torch.inference_mode()
    def step(self) -> bool:
        """One decode step over every slot. Returns False (and records
        nothing) when no slot is active — an empty batch does no work and
        must not count as a step."""
        n_active = sum(r is not None for r in self.active)
        if n_active == 0:
            return False
        self.stats.max_active = max(self.stats.max_active, n_active)
        logits, self.cache = self.model.decode_step(self.cache,
                                                    self.last_token)
        next_tok = torch.argmax(logits[:, -1], dim=-1)
        self.last_token = next_tok[:, None]
        self.stats.steps += 1
        toks = next_tok.tolist()
        for s, req in enumerate(self.active):
            if req is None:
                continue
            req.generated.append(toks[s])
            self.stats.tokens_out += 1
            if self._finished(req, toks[s]):
                req.done = True
                self.active[s] = None
                self.stats.completed += 1
        return True

    # ------------------------------------------------------------- run loop
    def run(self, requests: List[Request], max_steps: int = 10_000
            ) -> ServeStats:
        pending = list(requests)
        steps = 0
        while pending or any(r is not None for r in self.active):
            progress = False
            while pending and self.submit(pending[0]):
                pending.pop(0)
                progress = True
            if self.step():
                # only decodes that ran count against the step budget
                steps += 1
                progress = True
                if steps >= max_steps:
                    break
            if not progress:
                break
        return self.stats
