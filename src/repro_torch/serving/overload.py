"""Overload control for multi-tenant serving: SLO tiers, weighted-fair
admission, and a graceful-degradation ladder under saturation (the port's
copy of the JAX package's ``serving/overload.py``).

The survey's central large-scale-serving challenge is traffic that
routinely exceeds provisioned capacity: production systems live or die
by their behavior *past* the knee, not by peak throughput. This module
gives the cluster frontend the four instruments it needs there:

  * ``TenantClass`` — an SLO tier: weight (fair-share ratio), tier rank
    (degradation order), and a token-per-second admission rate;
  * ``TokenBucket`` — per-tenant admission rate limiting whose refusal
    is a *contract*, not an error: a typed ``RequestRejected`` carrying
    the bucket-refill-derived ``retry_after_s``;
  * ``WeightedFairQueue`` — deficit-round-robin (DRR) across tenants
    with EDF-by-TTFT-deadline *within* each tenant. Token-cost-weighted
    quanta make isolation structural: a tenant flooding 3x capacity can
    saturate only its own sub-queue, and every backlogged tenant is
    served within a provable number of rounds
    (``ceil(max_cost / (quantum * weight))`` — see ``max_wait_rounds``);
  * ``OverloadDetector`` — pooled-histogram tail watcher (windowed p99
    TTFT/JCT vs SLO out of ``LoadReport`` v4 wire histograms, plus the
    cost model's backlog estimate as the leading signal) driving the
    deterministic degradation ladder

        NORMAL -> SHED (drop lowest tier)
               -> BROWNOUT (+ trim lower tiers' token budgets)
               -> REJECT (+ typed reject-with-retry-after at submit)

    with consecutive-breach hysteresis so one slow tick never flaps the
    ladder;
  * ``CircuitBreaker`` — failover-path protection: a replica that died
    and came back is HALF_OPEN (bounded probe dispatches) until it
    proves itself, so the retry wave cannot instantly re-flood it.

Everything here is pure host-side, virtual-time arithmetic: no wall
clock, no randomness — an overload episode replays exactly from its
request schedule (the chaos-harness discipline, applied to saturation).
"""
from __future__ import annotations

import heapq
import itertools
import math
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Mapping, Optional, Tuple

from repro_torch.serving.metrics import Histogram
from repro_torch.serving.request import Request, RequestRejected

__all__ = [
    "TenantClass",
    "TokenBucket",
    "TenantAdmission",
    "WeightedFairQueue",
    "OverloadDetector",
    "CircuitBreaker",
    "NORMAL",
    "SHED",
    "BROWNOUT",
    "REJECT",
    "LADDER_LEVELS",
    "request_cost",
]

# -- degradation ladder levels (strictly ordered) ---------------------------
NORMAL = 0  # serve everything
SHED = 1  # drop the lowest tier's queued work
BROWNOUT = 2  # + trim lower tiers' max_new_tokens budgets
REJECT = 3  # + typed reject-with-retry-after at submit (below top tier)

LADDER_LEVELS = {NORMAL: "normal", SHED: "shed", BROWNOUT: "brownout",
                 REJECT: "reject"}


def request_cost(req: Request) -> float:
    """Token cost of a request for fair-share arithmetic: prompt tokens
    plus the decode budget it asks for. Brownout trims lower this, so a
    trimmed request also charges its tenant less — the ladder and the
    fair queue agree on what 'load' means."""
    return float(req.prompt_len + req.max_new_tokens)


@dataclass(frozen=True)
class TenantClass:
    """One tenant's SLO class.

    ``tier``: degradation rank — the ladder sheds/brownouts/rejects
    strictly from the lowest tier upward; the highest registered tier is
    "protected" (served at every ladder level, never trimmed).
    ``weight``: DRR fair-share ratio (2.0 gets twice the token
    throughput of 1.0 under contention).
    ``rate_tokens_s``/``burst_tokens``: token-bucket admission limit
    (prompt + decode budget tokens per second); rate <= 0 = unlimited.
    ``brownout_frac``: fraction of ``max_new_tokens`` kept when the
    ladder reaches BROWNOUT and this tenant is below the top tier.
    """

    name: str
    tier: int = 0
    weight: float = 1.0
    rate_tokens_s: float = 0.0
    burst_tokens: float = 0.0
    brownout_frac: float = 0.5

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name!r}: weight must be > 0")
        if not (0.0 < self.brownout_frac <= 1.0):
            raise ValueError(
                f"tenant {self.name!r}: brownout_frac must be in (0, 1]")


class TokenBucket:
    """Deterministic token bucket over the serving clock (virtual time).

    ``take(cost, now)`` refills by ``rate * dt``, then either consumes
    ``cost`` (admitted) or returns the finite seconds until the bucket
    will hold ``cost`` — the ``retry_after_s`` the typed rejection
    carries. A request larger than the burst capacity still gets a
    finite answer (time to fill to capacity plus the overhang at rate),
    so *every* rate-limit rejection is retryable.
    """

    __slots__ = ("rate", "capacity", "level", "_t")

    def __init__(self, rate: float, capacity: float):
        self.rate = float(rate)
        self.capacity = float(max(capacity, rate))  # >= 1s of burst
        self.level = self.capacity
        self._t: Optional[float] = None

    def _refill(self, now: float):
        if self._t is None:
            self._t = now
        elif now > self._t:
            self.level = min(self.capacity,
                             self.level + (now - self._t) * self.rate)
            self._t = now

    def take(self, cost: float, now: float) -> float:
        """0.0 = admitted (cost consumed); > 0 = seconds until retry."""
        self._refill(now)
        if cost <= self.level:
            self.level -= cost
            return 0.0
        deficit = min(cost, self.capacity) - self.level
        wait = deficit / self.rate
        if cost > self.capacity:  # oversized: charge the overhang too
            wait += (cost - self.capacity) / self.rate
        return max(wait, 1e-9)


class TenantAdmission:
    """Per-tenant token-bucket admission front door.

    ``admit(req, now)`` raises a typed ``RequestRejected`` with a finite
    ``retry_after_s`` when the tenant's bucket cannot cover the
    request's token cost; tenants without a rate limit (or unknown
    tenants) always pass."""

    def __init__(self, classes: Mapping[str, TenantClass]):
        self.classes = dict(classes)
        self.buckets: Dict[str, TokenBucket] = {
            name: TokenBucket(tc.rate_tokens_s,
                              tc.burst_tokens or tc.rate_tokens_s)
            for name, tc in self.classes.items() if tc.rate_tokens_s > 0}

    def admit(self, req: Request, now: float) -> None:
        bucket = self.buckets.get(req.tenant)
        if bucket is None:
            return
        wait = bucket.take(request_cost(req), now)
        if wait > 0.0:
            raise RequestRejected(
                f"rejected: tenant {req.tenant!r} rate limit "
                f"({bucket.rate:g} tok/s) exceeded; retry after "
                f"{wait:.3f}s", retry_after_s=wait)


class WeightedFairQueue:
    """Deficit-round-robin fair queue across tenants, EDF within.

    Each tenant owns a heap keyed ``(ttft_deadline, seq)`` (or pure
    arrival ``seq`` with ``edf=False``) — the exact ordering the old
    flat frontend queue used, so a single-tenant queue drains
    bit-identically to the pre-DRR frontend. Across tenants, ``pop``
    runs textbook DRR: the round-robin cursor grants each backlogged
    tenant ``quantum * weight`` token-cost credit once per visit and
    serves its EDF head(s) while the deficit covers their cost; a
    drained tenant forfeits its remaining deficit (no credit hoarding).

    Starvation bound: a backlogged tenant's head (cost C, weight w) is
    served within ``ceil(C / (quantum * w))`` of its own grants, each
    round bounded by the other tenants' quantum spend — ``wait_rounds``
    / ``max_wait_rounds`` record the observed grant counts so benches
    can gate "zero starved tenants" on a hard number.
    """

    def __init__(self, *, edf: bool = True, quantum: float = 256.0,
                 weight_of: Optional[Callable[[str], float]] = None):
        self.edf = edf
        self.quantum = float(quantum)
        self._weight_of = weight_of or (lambda name: 1.0)
        self._seq = itertools.count()
        self._heaps: Dict[str, List[tuple]] = {}
        self._order: Deque[str] = deque()  # backlogged tenants, RR order
        self._deficit: Dict[str, float] = {}
        self._granted: Optional[str] = None  # cursor's tenant, post-grant
        self._total = 0
        self.queued_cost = 0.0  # token cost waiting here (overload signal)
        # starvation telemetry: grants a tenant waited for its last pop,
        # and the worst such wait ever observed (rounds, effectively)
        self._grants_waited: Dict[str, int] = {}
        self.wait_rounds: Dict[str, int] = {}
        self.max_wait_rounds = 0

    def __len__(self) -> int:
        return self._total

    def __bool__(self) -> bool:
        return self._total > 0

    def tenants(self) -> List[str]:
        return [t for t in self._order if self._heaps.get(t)]

    def push(self, req: Request) -> None:
        key = req.ttft_deadline if self.edf else 0.0
        heap = self._heaps.get(req.tenant)
        if heap is None:
            heap = self._heaps[req.tenant] = []
        if not heap:
            self._order.append(req.tenant)
            self._deficit.setdefault(req.tenant, 0.0)
            self._grants_waited.setdefault(req.tenant, 0)
        heapq.heappush(heap, (key, next(self._seq), req))
        self._total += 1
        self.queued_cost += request_cost(req)

    def _drop_head_tenant(self):
        name = self._order.popleft()
        self._heaps.pop(name, None)
        self._deficit.pop(name, None)  # forfeit credit: no hoarding
        self._grants_waited.pop(name, None)
        if self._granted == name:
            self._granted = None

    def pop(self) -> Optional[Request]:
        """Next request in DRR order (None when empty). Terminates: every
        full rotation grants each backlogged tenant a quantum, so the
        cheapest head's deficit eventually covers its cost."""
        if not self._total:
            return None
        while True:
            name = self._order[0]
            heap = self._heaps.get(name)
            if not heap:
                self._drop_head_tenant()
                continue
            if self._granted != name:
                self._deficit[name] = (self._deficit.get(name, 0.0)
                                       + self.quantum * self._weight_of(name))
                self._granted = name
                self._grants_waited[name] = self._grants_waited.get(name, 0) + 1
            _, _, head = heap[0]
            if request_cost(head) <= self._deficit[name]:
                heapq.heappop(heap)
                self._deficit[name] -= request_cost(head)
                self._total -= 1
                self.queued_cost = max(0.0,
                                       self.queued_cost - request_cost(head))
                waited = self._grants_waited.get(name, 1)
                self.wait_rounds[name] = waited
                if waited > self.max_wait_rounds:
                    self.max_wait_rounds = waited
                self._grants_waited[name] = 0
                if not heap:
                    self._drop_head_tenant()
                return head
            self._order.rotate(-1)
            self._granted = None

    def drain(self) -> List[Request]:
        """Pop everything (fair order) — requeue/teardown helper."""
        out = []
        while self._total:
            out.append(self.pop())
        return out

    def starvation_bound(self, max_cost: float) -> int:
        """Provable worst-case grants-to-service for a head of
        ``max_cost`` at the smallest registered weight (+1 slack for the
        grant that lands mid-round)."""
        w = min([self._weight_of(t) for t in self._heaps] or [1.0])
        return int(math.ceil(max_cost / (self.quantum * w))) + 1


class OverloadDetector:
    """Pooled-telemetry overload detector driving the degradation ladder.

    ``observe(now, reports)`` is called by the frontend each tick with
    every live replica's ``LoadReport``. Every ``period_s`` of serving
    time it evaluates two signals:

      * **tail signal**: windowed (delta-since-last-evaluation) pooled
        TTFT p99 vs ``ttft_slo_s`` (and JCT p99 vs ``jct_slo_s`` when
        set) out of the reports' exactly-mergeable wire histograms;
      * **backlog signal**: mean cost-model ``backlog_s`` per replica vs
        ``backlog_high_s`` — the *leading* indicator (under deep
        saturation few requests finish, so the tail histograms starve
        exactly when the ladder is needed most).

    ``patience`` consecutive breached evaluations escalate one ladder
    level; ``relax_patience`` consecutive clear evaluations (tail below
    ``relax * slo`` AND backlog below ``relax * backlog_high_s``)
    de-escalate one level. Deterministic in virtual time.
    """

    def __init__(self, *, ttft_slo_s: float, jct_slo_s: float = 0.0,
                 backlog_high_s: Optional[float] = None,
                 period_s: float = 0.25, patience: int = 2,
                 relax_patience: int = 4, relax: float = 0.7,
                 min_window: int = 4, max_level: int = REJECT):
        if ttft_slo_s <= 0:
            raise ValueError("ttft_slo_s must be > 0 (the ladder needs an "
                             "SLO to defend)")
        self.ttft_slo_s = ttft_slo_s
        self.jct_slo_s = jct_slo_s
        self.backlog_high_s = (backlog_high_s if backlog_high_s is not None
                               else 4.0 * ttft_slo_s)
        self.period_s = period_s
        self.patience = max(1, patience)
        self.relax_patience = max(1, relax_patience)
        self.relax = relax
        self.min_window = min_window
        self.max_level = max_level
        self.level = NORMAL
        self.transitions: List[Tuple[float, int]] = []  # (t, new level)
        self._last_eval: Optional[float] = None
        self._breaches = 0
        self._clears = 0
        self._prev: Dict[str, Histogram] = {}  # cumulative snapshots
        self._retry_after = 2.0 * ttft_slo_s
        # last evaluated signals (telemetry / tests)
        self.last_p99_ttft = 0.0
        self.last_p99_jct = 0.0
        self.last_backlog_s = 0.0

    @property
    def level_name(self) -> str:
        return LADDER_LEVELS[self.level]

    def _pooled(self, reports, name: str) -> Optional[Histogram]:
        merged: Optional[Histogram] = None
        for rep in reports:
            for hname, wire in rep.histograms:
                if hname != name:
                    continue
                h = Histogram.from_wire(wire)
                merged = h if merged is None else merged.merge(h)
        return merged

    def observe(self, now: float, reports,
                frontend_backlog_s: float = 0.0) -> int:
        """Fold one tick of pooled telemetry; returns the (possibly
        updated) ladder level. ``frontend_backlog_s`` is the caller's own
        queued work in cost-model seconds — under paced dispatch the
        burst waits at the FRONTEND, so engine-side ``backlog_s`` alone
        would under-read saturation exactly when it matters."""
        if self._last_eval is None:
            self._last_eval = now
            return self.level
        if now - self._last_eval < self.period_s:
            return self.level
        self._last_eval = now
        reports = list(reports)
        n = max(1, len(reports))
        self.last_backlog_s = (sum(r.backlog_s for r in reports) / n
                               + frontend_backlog_s)
        breach = self.last_backlog_s > self.backlog_high_s
        clear = self.last_backlog_s < self.relax * self.backlog_high_s
        for hname, slo, attr in (("ttft_s", self.ttft_slo_s, "last_p99_ttft"),
                                 ("jct_s", self.jct_slo_s, "last_p99_jct")):
            if slo <= 0:
                continue
            cum = self._pooled(reports, hname)
            if cum is None:
                continue
            prev = self._prev.get(hname)
            window = cum.delta(prev) if prev is not None else cum
            if window.count < self.min_window:
                continue  # too few new samples: let the window GROW
                # (the baseline snapshot only advances on evaluation, so
                # a starved tail accumulates instead of resetting)
            self._prev[hname] = cum
            p99 = window.percentile(99)
            setattr(self, attr, p99)
            breach = breach or p99 > slo
            clear = clear and p99 < self.relax * slo
        # retry-after contract: cost-model seconds to drain the pooled
        # backlog across the live replicas, floored at one SLO
        self._retry_after = max(self.ttft_slo_s,
                                min(self.last_backlog_s, 64.0 * self.ttft_slo_s))
        if breach:
            self._breaches += 1
            self._clears = 0
            if self._breaches >= self.patience and self.level < self.max_level:
                self.level += 1
                self._breaches = 0
                self.transitions.append((now, self.level))
        elif clear:
            self._clears += 1
            self._breaches = 0
            if self._clears >= self.relax_patience and self.level > NORMAL:
                self.level -= 1
                self._clears = 0
                self.transitions.append((now, self.level))
        else:
            self._breaches = 0
            self._clears = 0
        return self.level

    def retry_after_s(self) -> float:
        """Finite retry horizon for ladder rejections (cost-model
        backlog drain estimate, clamped)."""
        return self._retry_after


# -- circuit breaker --------------------------------------------------------
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class _BreakerState:
    __slots__ = ("state", "since", "probes", "successes")

    def __init__(self):
        self.state = CLOSED
        self.since = 0.0
        self.probes = 0  # outstanding half-open dispatches
        self.successes = 0


class CircuitBreaker:
    """Per-replica circuit breaker on the failover/recovery path.

    A replica declared dead trips OPEN (``trip``): no dispatches for
    ``cooldown_s``. After the cooldown it is HALF_OPEN: at most
    ``probe_limit`` outstanding requests (``allow`` + ``note_dispatch``)
    until ``close_after`` completions close it — so the backlog and the
    retry wave ramp onto a recovering replica instead of re-flooding it
    into a second death. A failure while HALF_OPEN re-trips.
    Unknown replicas are CLOSED (healthy by default)."""

    def __init__(self, *, cooldown_s: float = 1.0, probe_limit: int = 2,
                 close_after: int = 3):
        self.cooldown_s = cooldown_s
        self.probe_limit = max(1, probe_limit)
        self.close_after = max(1, close_after)
        self._states: Dict[str, _BreakerState] = {}

    def _st(self, key: str) -> _BreakerState:
        st = self._states.get(key)
        if st is None:
            st = self._states[key] = _BreakerState()
        return st

    def state(self, key: str, now: float) -> str:
        st = self._states.get(key)
        if st is None:
            return CLOSED
        if st.state == OPEN and now - st.since >= self.cooldown_s:
            st.state = HALF_OPEN
            st.since = now
            st.probes = 0
            st.successes = 0
        return st.state

    def trip(self, key: str, now: float) -> None:
        st = self._st(key)
        st.state = OPEN
        st.since = now
        st.probes = 0
        st.successes = 0

    def allow(self, key: str, now: float) -> bool:
        s = self.state(key, now)
        if s == CLOSED:
            return True
        if s == OPEN:
            return False
        return self._st(key).probes < self.probe_limit

    def note_dispatch(self, key: str, now: float) -> None:
        if self.state(key, now) == HALF_OPEN:
            self._st(key).probes += 1

    def note_success(self, key: str, now: float) -> None:
        if self.state(key, now) != HALF_OPEN:
            return
        st = self._st(key)
        st.probes = max(0, st.probes - 1)
        st.successes += 1
        if st.successes >= self.close_after:
            st.state = CLOSED
            st.since = now

    def note_failure(self, key: str, now: float) -> None:
        self.trip(key, now)
