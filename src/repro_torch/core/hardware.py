"""Hardware constants for the port's target card. All roofline math in
``repro_torch.core.costmodel`` reads from here."""
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
