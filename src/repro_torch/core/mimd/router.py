"""MIMD service routing (survey §2, DLIS [42]): route inference queries
across a cluster of model instances (the port's copy of the JAX package's
``core/mimd/router.py``).

The router "understands different models' requirements and places one or
multiple queries intelligently onto hardware": each model has an instance
pool (replicas on meshlets); routing policies are

  round-robin   — rotate through the pool, blind to load;
  least-loaded  — minimize the instance's instantaneous ``load()`` signal;
  p2c           — power-of-two-choices: sample two (seeded), keep the one
                  with the lower predicted completion;
  predicted     — minimize predicted completion over the whole pool.

``Instance`` is the simulation-facing replica (its load signal is the
``queue_s`` scalar the router itself maintains); live engines plug in via
``repro_torch.serving.cluster.EngineInstance``, which overrides ``load()`` /
``predicted_completion()`` with real telemetry from
``ServingEngine.load_report()`` — the SAME router policies then run
unchanged over live engines. Tie-breaks are deterministic under the
constructor seed: ties on the routing key fall back to registration order,
never to dict/hash order. Autoscaling hooks grow/shrink pools from queue
pressure — the data-center management layer the survey notes is
underexplored for inference.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.core.misd.scheduler import Device, Job

POLICIES = ("least-loaded", "p2c", "round-robin", "predicted")


@dataclass
class Instance:
    """One deployed replica of a model on a meshlet."""

    name: str
    model: str
    device: Device
    queue_s: float = 0.0  # predicted backlog seconds
    draining: bool = False  # deregistered: finish in-flight, take no routes
    failed: bool = False  # declared dead (crash/hang): work fails over
    order: int = -1  # registration sequence (deterministic tie-break key)

    def load(self) -> float:
        """Instantaneous load signal for least-loaded routing (cheaper and
        noisier than ``predicted_completion`` — no per-job service term)."""
        return self.queue_s

    def prefix_hit_s(self, job: Job) -> float:
        """Prefix-affinity term: service seconds this replica would SKIP
        because it already holds the job's prompt prefix in its KV cache.
        The simulated instance has no cache, so the default is 0; live
        engines (``repro_torch.serving.cluster.EngineInstance``) override it
        with a real ``PrefixIndex`` probe. Subtracted from the routing
        score, so template traffic gravitates to the replica that already
        paid for the prefix."""
        return 0.0

    def predicted_completion(self, job: Job) -> float:
        concurrency = len(self.device.running) + 1
        service = max(0.0, job.service_s - self.prefix_hit_s(job))
        return self.queue_s + service * concurrency / self.device.speed


class ServiceRouter:
    """Cluster-level query router over per-model instance pools."""

    def __init__(self, policy: str = "least-loaded", seed: int = 0):
        assert policy in POLICIES, f"unknown policy {policy!r} (want {POLICIES})"
        self.policy = policy
        self.pools: Dict[str, List[Instance]] = {}
        self._rr: Dict[str, int] = {}
        self._rng = random.Random(seed)
        self._next_order = 0

    def register(self, inst: Instance) -> Instance:
        inst.order = self._next_order
        self._next_order += 1
        inst.draining = False
        self.pools.setdefault(inst.model, []).append(inst)
        return inst

    def deregister(self, inst_or_name, model: Optional[str] = None) -> Optional[Instance]:
        """Retire an instance: mark it draining and remove it from its pool
        so it stops receiving routes (in-flight work finishes elsewhere —
        the caller keeps stepping it until empty). Accepts the instance or
        its name; returns the removed instance, or None if absent."""
        pools = ([self.pools.get(model, [])] if model is not None
                 else list(self.pools.values()))
        for pool in pools:
            for i, inst in enumerate(pool):
                if inst is inst_or_name or inst.name == inst_or_name:
                    pool.pop(i)
                    inst.draining = True
                    return inst
        return None

    def route(self, job: Job,
              eligible: Optional[set] = None) -> Optional[Instance]:
        """Pick a replica for ``job`` under the configured policy.
        ``eligible`` (instance names) restricts the candidate pool — the
        cluster frontend's circuit breaker passes it so a half-open
        recovering replica only sees bounded probe traffic. None = whole
        pool; an empty intersection returns None (caller holds the job)."""
        pool = self.pools.get(job.model)
        if pool and eligible is not None:
            pool = [i for i in pool if i.name in eligible]
        if not pool:
            return None
        if self.policy == "round-robin":
            i = self._rr.get(job.model, 0) % len(pool)
            self._rr[job.model] = i + 1
            chosen = pool[i]
        elif self.policy == "p2c":
            # the seeded sample order doubles as the tie-break (first of
            # the pair wins an exact tie): deterministic under the
            # constructor seed, yet persistent ties still spread; a pool
            # shrunk to one replica degrades to that replica
            pair = (self._rng.sample(pool, k=2) if len(pool) >= 2
                    else [pool[0]])
            chosen = min(pair, key=lambda x: x.predicted_completion(job))
        elif self.policy == "predicted":
            chosen = min(pool, key=lambda x: (x.predicted_completion(job),
                                              x.order))
        else:  # least-loaded: the seeded shuffle IS the tie-break, so
            # exact-tie loads spread out (deterministically under the seed)
            order = list(pool)
            self._rng.shuffle(order)
            chosen = min(order, key=lambda x: x.load())
        chosen.queue_s += job.service_s / chosen.device.speed
        return chosen

    def drain(self, inst: Instance, seconds: float):
        inst.queue_s = max(0.0, inst.queue_s - seconds)

    # -- autoscaling ---------------------------------------------------
    def pressure(self, model: str) -> float:
        """Mean predicted backlog seconds PER CHIP. The denominator is
        ``pool_chips``, not the replica count: a tp=8 replica is 8 chips
        of capacity, so the same queue spread over it is 8x less
        pressure than over a 1-chip replica — scale decisions must weigh
        hardware, not processes (each replica's ``device.speed`` mirrors
        its chip count; 1.0 for single-device engines, so homogeneous
        1-chip pools are numerically unchanged)."""
        pool = self.pools.get(model, [])
        if not pool:
            return float("inf")
        return sum(i.queue_s for i in pool) / max(1.0, self.pool_chips(model))

    def pool_chips(self, model: str) -> float:
        """Devices the pool occupies (each replica's ``device.speed``
        mirrors its chip count — 1 for single-device engines, the mesh
        size for sharded replicas via ``LoadReport.n_chips``). The
        data-center sizing denominator: a scale-out of one tp=8 replica
        costs 8 chips, not 1."""
        return sum(i.device.speed for i in self.pools.get(model, []))

    def want_scale(self, model: str, *, high_s: float = 1.0,
                   low_s: float = 0.05) -> int:
        """+1 = scale out, -1 = scale in, 0 = hold. Thresholds compare
        against chip-weighted ``pressure`` (backlog seconds per chip),
        so a pool of tp=8 replicas doesn't scale out 8x too eagerly."""
        p = self.pressure(model)
        if p > high_s:
            return 1
        if p < low_s and len(self.pools.get(model, [])) > 1:
            return -1
        return 0
