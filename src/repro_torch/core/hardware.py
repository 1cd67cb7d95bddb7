"""Hardware constants for the port's target card, plus the survey's Fig. 4
comparison devices. All roofline math in ``repro_torch.core.costmodel``
reads from here."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Chip:
    name: str
    peak_flops: float  # FLOP/s, dense bf16 on the tensor cores
    hbm_bw: float  # bytes/s
    hbm_bytes: float
    link_bw: float  # bytes/s per direction to the other cards of the host
    tdp_watts: float


# NVIDIA H100 SXM data sheet: 989 TFLOP/s dense bf16, 80 GB HBM3 at
# 3.35 TB/s, NVLink 900 GB/s (450 GB/s each way), 700 W.
H100_SXM = Chip(
    name="h100-sxm",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    hbm_bytes=80e9,
    link_bw=450e9,
    tdp_watts=700.0,
)

# Fixed per-step overhead the cost model adds to every estimate (host
# launch and runtime), seconds. A modeling constant, not a measurement.
DISPATCH_OVERHEAD_S = 45e-6

# Survey Fig. 4 comparison points (nominal public data-sheet numbers)
XEON_4116 = Chip("xeon-4116", 0.8e12, 115e9, 192 * 2 ** 30, 10e9, 85.0)
RTX_2080TI = Chip("rtx-2080ti", 26.9e12, 616e9, 11 * 2 ** 30, 16e9, 250.0)
V100 = Chip("v100", 130e12, 900e9, 32 * 2 ** 30, 25e9, 300.0)
A100 = Chip("a100", 312e12, 1555e9, 40 * 2 ** 30, 37.5e9, 400.0)

CHIPS = {c.name: c for c in (H100_SXM, XEON_4116, RTX_2080TI, V100, A100)}

# Cost of repartitioning a card's meshlets (survey §3.3.2: "several
# seconds" for MIG-class repartitioning), seconds. A modeling constant,
# not a measurement.
RECONFIG_COST_S = 5.0
