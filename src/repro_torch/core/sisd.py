"""SISD baseline: one model, one device, the survey's 'traditional'
quadrant, kept as the comparison baseline for every MISD and SIMD
benchmark."""
from __future__ import annotations

from typing import List

from repro_torch.core.misd.scheduler import (
    Device,
    FIFOScheduler,
    Job,
    MISDSimulator,
    SimResult,
)


def sisd_device(name: str = "chip0") -> Device:
    """Single-tenant device: max_tenants=1 (no co-location)."""
    return Device(name, max_tenants=1)


def run_single_tenant(jobs: List[Job]) -> SimResult:
    """Serialize jobs on one device: the SISD baseline for Fig. 3."""
    sim = MISDSimulator([sisd_device()], FIFOScheduler())
    return sim.run(jobs)


def run_multi_tenant(jobs: List[Job], max_tenants: int = 2,
                     scheduler=None) -> SimResult:
    sim = MISDSimulator(
        [Device("chip0", max_tenants=max_tenants)],
        scheduler or FIFOScheduler())
    return sim.run(jobs)
