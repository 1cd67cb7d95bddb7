"""Heterogeneous-memory inference (survey §4.3.2, [25][47][49]).

The DRAM/SSD embedding tier on a card: hot embedding rows are cached in
device memory, cold rows stream from host memory over PCIe-class links.
The policy question ([47] FlashEmbedding, [49] RecSSD) is placement and
caching; with Zipf-distributed accesses a small device cache yields
near-device average bandwidth, which ``effective_bandwidth`` reproduces.
Bandwidths default to the H100's device memory and a PCIe-class host
link; the cold tier's is a parameter (an SSD's, say).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.hardware import H100_SXM

HBM_BW = H100_SXM.hbm_bw
HOST_BW = 32e9  # PCIe-class host link


def zipf_hit_rate(cache_rows: int, total_rows: int,
                  alpha: float = 0.8) -> float:
    """P(an access hits the ``cache_rows`` hottest rows) under Zipf(alpha).
    No cached row hits nothing (the reference's harmonic approximation
    goes negative or raises there: ROADMAP.md queue 3)."""
    if cache_rows >= total_rows:
        return 1.0
    if cache_rows <= 0:
        return 0.0

    def h(n):  # harmonic approximation
        if alpha == 1.0:
            return math.log(n) + 0.5772
        return (n ** (1 - alpha) - 1) / (1 - alpha) + 1
    return h(cache_rows) / h(total_rows)


def effective_bandwidth(hbm_frac: float, total_rows: int,
                        alpha: float = 0.8, cold_bw: float = HOST_BW,
                        hbm_bw: float = HBM_BW) -> float:
    """Average row-fetch bandwidth with the hottest ``hbm_frac`` of the
    rows in device memory: the harmonic mean of the tiers' bandwidths
    weighted by hit and miss."""
    hit = zipf_hit_rate(int(hbm_frac * total_rows), total_rows, alpha)
    return 1.0 / (hit / hbm_bw + (1 - hit) / cold_bw)


@dataclass
class TierSpec:
    """One memory tier of the heterogeneous store: its name, its read
    bandwidth (bytes/s) and its capacity (bytes). Nothing in the port
    reads it: it is kept for parity with the JAX package's
    ``core/simd/offload.py``, whose ``TierSpec`` is unused there too."""

    name: str
    bandwidth: float
    capacity_bytes: float


@dataclass
class OffloadPlan:
    hbm_rows: int
    host_rows: int
    hit_rate: float
    effective_bw: float
    slowdown_vs_hbm: float


def plan_offload(table_rows: int, row_bytes: int, hbm_budget_bytes: float,
                 alpha: float = 0.8, cold_bw: float = HOST_BW,
                 hbm_bw: float = HBM_BW) -> OffloadPlan:
    """The hottest rows that fit ``hbm_budget_bytes`` stay on the card, the
    rest on the cold tier; returns the hit rate, the effective bandwidth
    and the slowdown against all rows on the card."""
    hbm_rows = min(table_rows, int(hbm_budget_bytes // row_bytes))
    hit = zipf_hit_rate(hbm_rows, table_rows, alpha)
    eff = 1.0 / (hit / hbm_bw + (1 - hit) / cold_bw)
    return OffloadPlan(
        hbm_rows=hbm_rows,
        host_rows=table_rows - hbm_rows,
        hit_rate=hit,
        effective_bw=eff,
        slowdown_vs_hbm=hbm_bw / eff,
    )
