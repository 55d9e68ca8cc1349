"""What the port's examples and scripts report beside their results: the
device they ran on, the seconds and kernel launches of each stage, and a
served model's prefill and decode times (`TimedModel`).

    stages = Stages(device)
    with stages("power_iteration"):
        pi, delta, iters = power_iteration(g, eps, device=device)
    stages.print()

A stage's seconds end in a synchronize on the card, so they hold the
card's work. Its launches are the rise of the kernels' launch counters
(`kernels.common.launches`) over the stage; the counters themselves are
left alone, so a caller that counts around a whole run still counts it.
On the CPU the kernels' plain versions run and nothing is launched.
"""
from __future__ import annotations

import contextlib
import subprocess
import time
from typing import Dict, List

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import common


def device_or_exit(device=None) -> torch.device:
    """`resolve_device(device)`; without a card and without `device`, exit
    non-zero with its message."""
    try:
        return resolve_device(device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None


def nvidia_smi_line() -> str:
    """The card's name and power limit, as `nvidia-smi` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_lines(device: torch.device) -> List[str]:
    """A line naming the device; on a card, also `nvidia_smi_line()`."""
    if device.type != "cuda":
        return [f"device: {device}"]
    return [f"device: {device} ({torch.cuda.get_device_name(device)}, "
            f"torch {torch.__version__}, CUDA {torch.version.cuda})",
            nvidia_smi_line()]


class Stages:
    """The seconds and kernel launches of each named stage of a run on
    `device`, in the order the stages ran."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: Dict[str, float] = {}
        self.launches: Dict[str, Dict[str, int]] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name: str):
        self._sync()
        before = dict(common.launches)
        t0 = time.perf_counter()
        yield
        self._sync()
        self.seconds[name] = time.perf_counter() - t0
        self.launches[name] = {k: common.launches[k] - before[k]
                               for k in before}

    def total_launches(self) -> Dict[str, int]:
        return {k: sum(s[k] for s in self.launches.values())
                for k in common.launches}

    def print(self) -> None:
        for name, secs in self.seconds.items():
            launched = {k: v for k, v in self.launches[name].items() if v}
            print(f"stage {name}: {secs:.3f} s, kernel launches "
                  f"{launched or 'none'}")

    def report(self) -> dict:
        return dict(seconds=dict(self.seconds),
                    launches={k: dict(v) for k, v in self.launches.items()})


class TimedModel:
    """`model` served through a `ContinuousBatcher` (set `batcher`), each
    prefill and decode step timed, on the card between synchronizations;
    each decode step is kept with the number of the batcher's slots that
    were active."""

    def __init__(self, model):
        self.model = model
        self.device = model.device
        self.batcher = None
        self.prefill_s = 0.0
        self.prefill_tokens = 0
        self.decode_steps = []        # (active slots, seconds)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def init_cache(self, batch, max_seq):
        return self.model.init_cache(batch, max_seq)

    def prefill(self, tokens, **kw):
        self._sync()
        t0 = time.perf_counter()
        out = self.model.prefill(tokens, **kw)
        self._sync()
        self.prefill_s += time.perf_counter() - t0
        self.prefill_tokens += tokens.numel()
        return out

    def decode_step(self, cache, token):
        active = sum(r is not None for r in self.batcher.active)
        self._sync()
        t0 = time.perf_counter()
        out = self.model.decode_step(cache, token)
        self._sync()
        self.decode_steps.append((active, time.perf_counter() - t0))
        return out
