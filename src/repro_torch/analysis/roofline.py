"""Three-term roofline model of a dry-run cell.

The JAX package's `repro.analysis.roofline`, with an NVIDIA H100's
constants in place of a TPU v5e's:

    compute    = FLOPs       / 989e12 FLOP/s dense bf16
    memory     = bytes       / 3.35e12 B/s HBM3
    collective = coll_bytes  / (25e9 B/s a NVLink 4 link, a direction
                                * 18 links)

Sources: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part (989.4
TFLOP/s bf16 dense, i.e. without sparsity; 80 GB of HBM3 at 3.35 TB/s;
NVLink 900 GB/s bidirectional); NVIDIA Hopper architecture whitepaper (fourth-
generation NVLink: 18 links of 25 GB/s each way). These are data-sheet
peaks at the full 700 W power limit, not measurements. The terms divide
by one device's rates: the FLOPs and bytes are per device. The formulas
of the `Roofline` properties and `model_flops_for` are the JAX
package's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.analysis.hlo import collective_bytes, count_ops

PEAK_FLOPS = 989e12        # bf16 dense / card
HBM_BW = 3.35e12           # B/s / card
NVLINK_BW = 25e9           # B/s / link / direction
NVLINK_LINKS = 18          # links per card
HBM_BYTES = 80e9           # B / card


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float            # per chip (counted ops; JAX's field name)
    hlo_bytes: float            # per chip (bytes the ops read and write)
    coll_bytes: float           # per chip
    coll_breakdown: Dict[str, int]
    coll_ops: Dict[str, int]
    model_flops: float          # 6*N*D (analytic, whole step, all chips)
    bytes_per_device: float     # arguments + temporaries
    output_bytes: float = 0.0
    temp_bytes: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (NVLINK_BW * NVLINK_LINKS)

    @property
    def bottleneck(self) -> str:
        terms = dict(compute=self.t_compute, memory=self.t_memory,
                     collective=self.t_collective)
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / (HLO_FLOPs * chips) — remat/redundancy waste."""
        total_hlo = self.hlo_flops * self.chips
        return self.model_flops / total_hlo if total_hlo else 0.0

    @property
    def mfu(self) -> float:
        """Roofline-implied MFU: useful FLOPs / (chips * peak * step_time)."""
        denom = self.chips * PEAK_FLOPS * self.step_time
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d |= dict(t_compute=self.t_compute, t_memory=self.t_memory,
                  t_collective=self.t_collective, bottleneck=self.bottleneck,
                  step_time=self.step_time, mfu=self.mfu,
                  useful_flops_fraction=self.useful_flops_fraction)
        return d


def model_flops_for(cfg, shape, n_tokens: Optional[int] = None) -> float:
    """Analytic MODEL_FLOPS for the cell: 6*N_active*D tokens (train) or
    2*N_active*D (forward-only serve steps)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def build_roofline(arch: str, shape_name: str, mesh_name: str, chips: int,
                   cost: dict, mem: dict, hlo_text: str,
                   model_flops: float) -> Roofline:
    coll = collective_bytes(hlo_text)
    return Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        hlo_flops=float(cost.get("flops", 0.0)),
        hlo_bytes=float(cost.get("bytes accessed", 0.0)),
        coll_bytes=float(sum(coll.values())),
        coll_breakdown=coll,
        coll_ops=count_ops(hlo_text),
        model_flops=model_flops,
        bytes_per_device=float(mem.get("argument_size_in_bytes", 0)
                               + mem.get("temp_size_in_bytes", 0)),
        output_bytes=float(mem.get("output_size_in_bytes", 0)),
        temp_bytes=float(mem.get("temp_size_in_bytes", 0)),
    )
