"""MISD temporal scheduling: event-driven multi-tenant simulator + the
scheduler family of survey Table 1 (the port's copy of the JAX package's
``core/misd/scheduler.py``; its cost calls price the port's card, one H100,
unless given another ``Chip``).

Schedulers:
  FIFOScheduler              — baseline co-location, admit in arrival order
  SJFScheduler               — shortest-job-first (makespan-oriented, [52])
  PremaScheduler             — token-based predictive priority + preemption
                               (PREMA [5])
  InterferenceAwareScheduler — admit only placements whose predicted mutual
                               slowdown is acceptable ([28] Mendoza et al.)

The simulator is event-driven: between events every running job progresses
at the rate given by the interference model over the demands co-located on
its device. Service times come from the analytic cost model; this is the
query-granularity analogue of the survey's GPU schedulers.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.hardware import H100_SXM, Chip
from repro_torch.core.misd.interference import (
    InterferencePredictor,
    progress_rates,
)


@dataclass
class Job:
    jid: int
    model: str
    demand: Tuple[float, float]  # (compute, memory) fractions
    service_s: float  # isolated latency on the target device
    arrival: float = 0.0
    priority: int = 0
    sla_s: float = 0.0
    # token-level shape (0/None when the caller only knows service_s):
    # lets per-replica routing re-estimate service for heterogeneous
    # hardware (n_chips) and probe prefix-cache affinity on the prompt
    prompt_tokens: int = 0
    new_tokens: int = 0
    tokens: Optional[Sequence[int]] = None  # prompt ids (affinity probe)
    # runtime state
    remaining: float = -1.0
    start: float = -1.0
    finish: float = -1.0
    device: Optional[str] = None
    preemptions: int = 0

    def __post_init__(self):
        if self.remaining < 0:
            self.remaining = self.service_s


@dataclass
class Device:
    """One schedulable hardware unit (whole chip, or a meshlet slice)."""

    name: str
    max_tenants: int = 4
    speed: float = 1.0  # relative to the reference chip (meshlet fraction)
    running: List[Job] = field(default_factory=list)

    @property
    def free_slots(self) -> int:
        return self.max_tenants - len(self.running)

    def rates(self) -> List[float]:
        r = progress_rates([j.demand for j in self.running])
        return [x * self.speed for x in r]


class Scheduler:
    """Base: admission decisions on every event. Override ``place``."""

    name = "base"

    def order(self, queue: List[Job], now: float) -> List[Job]:
        return queue

    def place(self, job: Job, devices: List[Device], now: float) -> Optional[Device]:
        for d in devices:
            if d.free_slots > 0:
                return d
        return None

    def preempt(self, queue: List[Job], devices: List[Device], now: float) -> List[Tuple[Job, Device]]:
        return []


class FIFOScheduler(Scheduler):
    name = "fifo"


class SJFScheduler(Scheduler):
    name = "sjf"

    def order(self, queue, now):
        return sorted(queue, key=lambda j: j.service_s)


class PremaScheduler(Scheduler):
    """PREMA [5]: token-based scheduling. Each waiting job accumulates
    tokens proportional to priority and waiting time; highest-token job is
    served first and may preempt the lowest-token running job when its
    tokens exceed a threshold multiple."""

    name = "prema"

    def __init__(self, token_threshold: float = 2.0):
        self.th = token_threshold

    def _tokens(self, j: Job, now: float) -> float:
        wait = max(0.0, now - j.arrival)
        return (1 + j.priority) * (1.0 + wait / max(j.service_s, 1e-6))

    def order(self, queue, now):
        return sorted(queue, key=lambda j: -self._tokens(j, now))

    def preempt(self, queue, devices, now):
        if not queue:
            return []
        top = max(queue, key=lambda j: self._tokens(j, now))
        top_tok = self._tokens(top, now)
        actions = []
        for d in devices:
            if d.free_slots > 0 or not d.running:
                continue
            victim = min(d.running, key=lambda j: self._tokens(j, now))
            if top_tok > self.th * self._tokens(victim, now):
                actions.append((victim, d))
                break
        return actions


class InterferenceAwareScheduler(Scheduler):
    """[28]: predict co-location slowdown before placing; place on the
    device minimizing predicted mutual degradation, refusing placements
    whose predicted slowdown exceeds ``max_slowdown``."""

    name = "interference-aware"

    def __init__(self, max_slowdown: float = 1.35):
        self.max_slowdown = max_slowdown
        self.predictor = InterferencePredictor()

    def place(self, job, devices, now):
        best, best_rate = None, 0.0
        for d in devices:
            if d.free_slots <= 0:
                continue
            demands = [j.demand for j in d.running] + [job.demand]
            rates = self.predictor.predict(demands)
            if 1.0 / max(rates[-1], 1e-6) > self.max_slowdown and d.running:
                continue  # would interfere too much
            if rates[-1] > best_rate:
                best, best_rate = d, rates[-1]
        if best is None:  # fall back to an empty device if any
            for d in devices:
                if not d.running and d.free_slots > 0:
                    return d
        return best


SCHEDULERS = {
    "fifo": FIFOScheduler,
    "sjf": SJFScheduler,
    "prema": PremaScheduler,
    "interference-aware": InterferenceAwareScheduler,
}


# ---------------------------------------------------------------------------
# chunked prefill <-> decode interleaving (serving-engine hook)
# ---------------------------------------------------------------------------


@dataclass
class ChunkedPrefillPolicy:
    """Decide how many prefill chunks to run ahead of each decode tick.

    Admitting a long prompt as one prefill stalls every in-flight decode
    stream for the whole prompt (head-of-line blocking — the survey's
    batching/latency tension in its sharpest form). The serving engine
    instead splits prompts into ``chunk``-token pieces and asks this policy,
    each tick, how many pieces fit: the budget is a multiple of the decode
    step's cost-model latency, so decode tick inflation is bounded by
    ``budget_ratio`` regardless of prompt length. With no active decode
    streams there is nothing to starve and prefill runs nearly unthrottled.
    """

    chunk: int = 64
    budget_ratio: float = 2.0  # max decode-tick inflation while prefilling
    max_chunks: int = 4        # hard cap per tick with active decodes
    idle_burst: int = 16       # chunks per tick when no decode is active

    # the card the cost model prices (the JAX package prices a TPU v5e)
    chip: Chip = H100_SXM

    def chunks_this_tick(self, cfg, *, n_decoding: int, pending_chunks: int,
                         context: int, n_chips: int = 1) -> int:
        if pending_chunks <= 0:
            return 0
        if n_decoding <= 0:
            return min(pending_chunks, self.idle_burst)
        from repro_torch.core.costmodel import (
            estimate_decode,
            estimate_prefill,
        )

        dec = estimate_decode(cfg, n_decoding, context, chip=self.chip,
                              n_chips=n_chips).latency_s
        pre = estimate_prefill(cfg, 1, self.chunk, chip=self.chip,
                               n_chips=n_chips).latency_s
        budget = max(self.budget_ratio - 1.0, 0.0) * dec
        n = int(budget // max(pre, 1e-12))
        return max(1, min(n, self.max_chunks, pending_chunks))


# ---------------------------------------------------------------------------
# event-driven simulator
# ---------------------------------------------------------------------------


@dataclass
class SimResult:
    completed: List[Job]
    makespan: float

    @property
    def qps(self) -> float:
        return len(self.completed) / self.makespan if self.makespan else 0.0

    def latencies(self) -> List[float]:
        return [j.finish - j.arrival for j in self.completed]

    def mean_latency(self) -> float:
        ls = self.latencies()
        return sum(ls) / len(ls) if ls else 0.0

    def p99_latency(self) -> float:
        ls = sorted(self.latencies())
        return ls[int(0.99 * (len(ls) - 1))] if ls else 0.0

    def mean_jct(self) -> float:
        return self.mean_latency()

    def sla_attainment(self) -> float:
        with_sla = [j for j in self.completed if j.sla_s > 0]
        if not with_sla:
            return 1.0
        ok = sum(1 for j in with_sla if j.finish - j.arrival <= j.sla_s)
        return ok / len(with_sla)

    def mean_slowdown(self) -> float:
        """Mean (observed service / isolated service) for completed jobs —
        Fig. 3's 'latency degradation'."""
        vals = [
            (j.finish - j.start) / j.service_s
            for j in self.completed
            if j.start >= 0 and j.service_s > 0
        ]
        return sum(vals) / len(vals) if vals else 1.0


class MISDSimulator:
    """Event-driven co-location simulator over a set of Devices."""

    def __init__(self, devices: List[Device], scheduler: Scheduler):
        self.devices = devices
        self.scheduler = scheduler

    def run(self, jobs: Sequence[Job], until: float = float("inf")) -> SimResult:
        arrivals = sorted(jobs, key=lambda j: j.arrival)
        queue: List[Job] = []
        completed: List[Job] = []
        now = 0.0
        ai = 0
        n_jobs = len(arrivals)

        def try_schedule():
            nonlocal queue
            # preemptions first
            for victim, dev in self.scheduler.preempt(queue, self.devices, now):
                dev.running.remove(victim)
                victim.preemptions += 1
                victim.device = None
                queue.append(victim)
            remaining_q = []
            for job in self.scheduler.order(queue, now):
                dev = self.scheduler.place(job, self.devices, now)
                if dev is not None and dev.free_slots > 0:
                    if job.start < 0:
                        job.start = now
                    job.device = dev.name
                    dev.running.append(job)
                else:
                    remaining_q.append(job)
            queue = remaining_q

        while len(completed) < n_jobs and now < until:
            try_schedule()
            # next arrival time
            t_arr = arrivals[ai].arrival if ai < n_jobs else float("inf")
            # next finish time under current rates
            t_fin = float("inf")
            for d in self.devices:
                rates = d.rates()
                for j, r in zip(d.running, rates):
                    if r > 0:
                        t_fin = min(t_fin, now + j.remaining / r)
            t_next = min(t_arr, t_fin)
            if t_next == float("inf"):
                break  # deadlock: nothing running, nothing arriving
            dt = t_next - now
            # advance progress
            for d in self.devices:
                rates = d.rates()
                for j, r in zip(d.running, rates):
                    j.remaining -= dt * r
            now = t_next
            # arrivals
            while ai < n_jobs and arrivals[ai].arrival <= now + 1e-12:
                queue.append(arrivals[ai])
                ai += 1
            # completions
            for d in self.devices:
                done = [j for j in d.running if j.remaining <= 1e-9]
                for j in done:
                    d.running.remove(j)
                    j.finish = now
                    completed.append(j)
        return SimResult(completed, now)
