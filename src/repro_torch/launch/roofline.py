"""Roofline terms of a dry-run record, at the H100's published peaks.

The port of ``repro.launch.roofline``, with the constants of NVIDIA's
H100 SXM data sheet in place of TPU v5e's:

    compute term    = FLOPs per device / 989e12 bf16 dense FLOP/s
    memory term     = bytes per device / 3.35e12 B/s HBM3
    collective term = collective bytes per device / 450e9 B/s
                      (NVLink 4: 900 GB/s a card, 450 GB/s each way)

These are bounds reckoned from data-sheet peaks, not measurements.  The
collective term models NVLink inside one 8-card host; a mesh axis wider
than 8 cards crosses the network between hosts (InfiniBand, an order of
magnitude slower a card), which this bound does not model.  The
per-device FLOPs, bytes and collective bytes come from
:mod:`repro_torch.launch.cost_analysis` (the reference parses HLO text;
the port counts at dispatch, so there is no HLO parser here).
MODEL_FLOPS uses the 6ND / 2ND convention (attention FLOPs excluded), so
MODEL_FLOPS / counted FLOPs exposes remat recompute and dispatch
overheads.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

PEAK_FLOPS = 989e12        # bf16 dense FLOP/s a card (H100 SXM)
HBM_BW = 3.35e12           # bytes/s a card (HBM3)
LINK_BW = 450e9            # bytes/s each way a card (NVLink 4)


def model_flops(n_params: int, n_active_params: int, tokens: int,
                kind: str) -> float:
    """6ND (train) / 2ND (inference) with active params for MoE."""
    n = n_active_params or n_params
    return (6.0 if kind == "train" else 2.0) * n * tokens


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_device: float
    hlo_bytes_per_device: float
    collective_bytes_per_device: float
    model_flops_global: float
    bytes_per_device_peak: Optional[float]  # memory_analysis, if available

    @property
    def compute_s(self) -> float:
        return self.hlo_flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.hlo_flops_per_device * self.chips
        return self.model_flops_global / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of peak compute achievable at the modeled bottleneck:
        (useful compute time) / (dominant term time)."""
        useful_s = (self.model_flops_global / self.chips) / PEAK_FLOPS
        bound = max(self.compute_s, self.memory_s, self.collective_s)
        return useful_s / bound if bound else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(compute_s=self.compute_s, memory_s=self.memory_s,
                 collective_s=self.collective_s, dominant=self.dominant,
                 useful_flops_ratio=self.useful_flops_ratio,
                 roofline_fraction=self.roofline_fraction)
        return d


def render_table(rows) -> str:
    hdr = ("| arch | shape | mesh | compute_s | memory_s | collective_s | "
           "dominant | MODEL/HLO | roofline_frac |")
    sep = "|" + "---|" * 9
    lines = [hdr, sep]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['compute_s']:.3e} | {r['memory_s']:.3e} "
            f"| {r['collective_s']:.3e} | {r['dominant']} "
            f"| {r['useful_flops_ratio']:.3f} "
            f"| {r['roofline_fraction']:.3f} |")
    return "\n".join(lines)
