"""The survey's taxonomy (Fig. 2) as a first-class object.

Instance (I) x Device (D) cardinality picks the computing paradigm; each
paradigm maps to an executor of the port. ``classify`` routes a deployment
description to its quadrant; ``executor_for`` names the executor.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass


class Paradigm(enum.Enum):
    SISD = "single-instance single-device"
    MISD = "multi-instance single-device"
    SIMD = "single-instance multi-device"
    MIMD = "multi-instance multi-device"


_EXECUTORS = {
    Paradigm.SISD: "repro_torch.serving.engine.ServingEngine (one model, "
                   "one card)",
    Paradigm.MISD: "repro_torch.core.misd: MISDSimulator + MeshPartitioner "
                   "(multi-tenant co-location)",
    Paradigm.SIMD: "repro_torch.core.simd: DLRM embedding inference "
                   "(sharding across cards: ROADMAP.md queue 1)",
    Paradigm.MIMD: "repro_torch.core.mimd.ServiceRouter over instance pools",
}


def classify(n_instances: int, n_devices: int) -> Paradigm:
    if n_instances <= 1 and n_devices <= 1:
        return Paradigm.SISD
    if n_instances > 1 and n_devices <= 1:
        return Paradigm.MISD
    if n_instances <= 1 and n_devices > 1:
        return Paradigm.SIMD
    return Paradigm.MIMD


def executor_for(p: Paradigm) -> str:
    return _EXECUTORS[p]


@dataclass(frozen=True)
class Deployment:
    """A deployment point in the taxonomy plane."""

    model: str
    n_instances: int
    n_devices: int

    @property
    def paradigm(self) -> Paradigm:
        return classify(self.n_instances, self.n_devices)
