"""MISD spatial resource management: meshlets (survey §3.3.2).

The GPU mechanisms (MPS SM partitioning, MIG slices, gpulets [4]) become
partitions of a grid of cards into disjoint rectangles. A ``Meshlet``
serves one tenant class in isolation (no interference across meshlets:
that is the point of spatial partitioning). Reconfiguring carries a real
cost (``RECONFIG_COST_S``: the survey's "several seconds").

``MeshPartitioner`` implements gpulet-style best-fit sizing: pick for each
model the smallest meshlet whose predicted latency meets the SLA and whose
cards hold its weights, then pack the meshlets into the grid.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.costmodel import estimate_decode, estimate_prefill
from repro_torch.core.hardware import H100_SXM, RECONFIG_COST_S, Chip
from repro_torch.core.misd.scheduler import Device


@dataclass(frozen=True)
class Meshlet:
    """A rectangular slice of the grid: (rows, cols) at ``origin``."""

    name: str
    shape: Tuple[int, int]
    origin: Tuple[int, int] = (0, 0)

    @property
    def n_chips(self) -> int:
        return self.shape[0] * self.shape[1]

    def as_device(self, max_tenants: int = 4) -> Device:
        # speed scales with cards (model parallel within the meshlet)
        return Device(self.name, max_tenants=max_tenants,
                      speed=self.n_chips / 1.0)


def _splits(pod_shape: Tuple[int, int],
            sizes: Sequence[int]) -> List[Meshlet]:
    """Greedy guillotine packing of power-of-two meshlets into the grid."""
    total = pod_shape[0] * pod_shape[1]
    if sum(sizes) > total:
        raise ValueError(f"meshlets {sizes} exceed the {pod_shape} grid")
    out = []
    row, col = 0, 0
    for i, n in enumerate(sorted(sizes, reverse=True)):
        rows = 2 ** (int(math.log2(n)) // 2)
        cols = n // rows
        if col + cols > pod_shape[1]:
            row += rows
            col = 0
        if row + rows > pod_shape[0]:
            raise ValueError(f"meshlets {sizes} overflow the {pod_shape} "
                             f"grid")
        out.append(Meshlet(f"meshlet{i}", (rows, cols), (row, col)))
        col += cols
    return out


@dataclass
class PartitionPlan:
    meshlets: List[Meshlet]
    assignment: Dict[str, str]  # model name -> meshlet name
    reconfig_cost_s: float = 0.0


class MeshPartitioner:
    """gpulet-style spatial partitioner for a grid of ``chip`` cards."""

    def __init__(self, pod_shape: Tuple[int, int] = (16, 16), *,
                 chip: Chip = H100_SXM):
        self.pod_shape = pod_shape
        self.chip = chip
        self.current: Optional[PartitionPlan] = None

    def size_for_sla(self, cfg, *, batch: int, context: int,
                     sla_s: float, kind: str = "decode") -> int:
        """Smallest power-of-two card count meeting the SLA (cost model)
        whose memory holds the weights (at 0.8 of it)."""
        n = 1
        total = self.pod_shape[0] * self.pod_shape[1]
        while n <= total:
            est = (estimate_decode(cfg, batch, context, n_chips=n,
                                   chip=self.chip)
                   if kind == "decode"
                   else estimate_prefill(cfg, batch, context, n_chips=n,
                                         chip=self.chip))
            wb = 2 if cfg.dtype == "bfloat16" else 4
            fits = cfg.param_count() * wb <= n * self.chip.hbm_bytes * 0.8
            if est.latency_s <= sla_s and fits:
                return n
            n *= 2
        return total

    def plan(self, tenants: List[dict]) -> PartitionPlan:
        """tenants: [{"name", "cfg", "batch", "context", "sla_s", "kind"}]"""
        total = self.pod_shape[0] * self.pod_shape[1]
        if len(tenants) > total:
            raise ValueError(f"{len(tenants)} tenants cannot each get a "
                             f"card of the {self.pod_shape} grid")
        sizes, names = [], []
        for t in tenants:
            n = self.size_for_sla(
                t["cfg"], batch=t["batch"], context=t["context"],
                sla_s=t["sla_s"], kind=t.get("kind", "decode"))
            sizes.append(n)
            names.append(t["name"])
        while sum(sizes) > total:  # shrink the largest ask until it packs
            k = sizes.index(max(sizes))
            sizes[k] //= 2
        meshlets = _splits(self.pod_shape, sizes)
        order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
        assignment = {names[i]: meshlets[rank].name
                      for rank, i in enumerate(order)}
        cost = RECONFIG_COST_S if self.current is not None else 0.0
        plan = PartitionPlan(meshlets, assignment, cost)
        self.current = plan
        return plan

    def devices(self, max_tenants: int = 4) -> List[Device]:
        if self.current is None:
            raise RuntimeError("MeshPartitioner.devices: no plan yet")
        return [m.as_device(max_tenants) for m in self.current.meshlets]
