"""Inference request/response types for the port's serving stack (the
port's own copy of the JAX package's ``serving/request.py``; the engine,
``repro_torch.serving.engine``, executes the token work on them).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.serving.metrics import Histogram, latency_histogram
from repro_torch.serving.tracing import Trace


class RequestState(str, enum.Enum):
    """Explicit request lifecycle (survey: availability and tail latency,
    not just throughput, define serving quality — a request must be
    cancellable, abortable, and preemptible at every stage).

    ::

        QUEUED -> PREFILL -> DECODE -> FINISHED
           |         |         |----> CANCELLED   (client cancel())
           |         |         |----> TIMED_OUT   (deadline-abort / shed)
           |         |         |----> FAILED      (rejection, replica loss,
           |         |         |                   retry budget exhausted)
           |         |         '----> PREEMPTED -> QUEUED  (restore)
           |         '---- same terminal edges ----'
           '------- same terminal edges -----------'

    PREEMPTED is the only non-terminal exit: the victim's generated
    tokens fold into its prompt and it requeues; the prefix-cache hit
    path restores it with suffix-only prefill, bit-identical to an
    unpreempted run (seeded sampling is keyed by absolute position).
    """

    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    FINISHED = "finished"
    CANCELLED = "cancelled"
    TIMED_OUT = "timed_out"
    FAILED = "failed"
    PREEMPTED = "preempted"

    @property
    def terminal(self) -> bool:
        return self in _TERMINAL


_TERMINAL = frozenset({RequestState.FINISHED, RequestState.CANCELLED,
                       RequestState.TIMED_OUT, RequestState.FAILED})


class RequestRejected(ValueError):
    """A request that cannot be served as submitted (oversize prompt,
    unknown model pool, tenant rate limit, overload rejection).
    ``ServingEngine.submit`` / ``ClusterFrontend.submit`` catch it and
    turn the request into a FAILED outcome with ``fail_reason`` set
    (counted in ``ServeMetrics.rejected``) instead of letting one poison
    request crash the serving loop; the low-level ``try_admit`` path
    still raises it for direct callers. Subclasses ``ValueError`` for
    backward compatibility.

    ``retry_after_s`` is the rejection contract under overload (survey:
    serverless inference makes typed retry-after the saturated-pool
    protocol): cost-model-derived seconds after which a resubmission has
    a real chance of admission. 0.0 means "permanent" — the request is
    malformed and retrying will never help (oversize prompt); a finite
    positive value means "come back later" (rate limit / load shedding).
    """

    def __init__(self, reason: str = "", retry_after_s: float = 0.0):
        super().__init__(reason)
        self.retry_after_s = float(retry_after_s)


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decode sampling configuration (survey: widening the
    workload mix a serving stack can host beyond deterministic decode).

    Greedy argmax is the degenerate case ``temperature <= 0`` — the
    default, so every existing caller keeps deterministic streams. A
    stochastic request's token stream is a pure function of ``seed`` and
    the absolute token position (the engine keys its PRNG noise by
    ``fold_in(key(seed), position)``), so a fixed seed reproduces the
    stream bit-for-bit across engine restarts, slot assignments, batch
    compositions, and cluster replicas.
    """

    temperature: float = 0.0  # <= 0: greedy argmax (deterministic)
    top_k: int = 0  # keep the k largest logits; 0 = no top-k cut
    top_p: float = 1.0  # nucleus mass; >= 1 = no top-p cut
    seed: int = 0  # PRNG stream identity (stable under routing)

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (prompt_len,) int32 token ids
    max_new_tokens: int
    arrival_time: float = 0.0
    priority: int = 0  # higher = more urgent
    sla_ms: float = 0.0  # legacy whole-request SLA; 0 = best-effort
    model: str = ""  # routing pool tag (cluster frontend); "" = default pool
    # --- multi-tenant SLO classes (overload control; see serving/overload) ---
    # tenant identity for weighted-fair admission; "" = untagged traffic
    # (single-tenant path: no per-tenant accounting, no fair queueing)
    tenant: str = ""
    # SLO tier (higher = more protected). Stamped by the frontend from the
    # registered TenantClass at submit; the degradation ladder sheds /
    # brownouts / rejects strictly from the lowest tier upward.
    tier: int = 0
    # --- per-request SLOs (survey §3.2.3; 0 = untracked) ---
    ttft_slo_s: float = 0.0  # time-to-first-token deadline after arrival
    tpot_slo_s: float = 0.0  # mean time-per-output-token bound
    # --- filled during serving ---
    output: List[int] = field(default_factory=list)
    prefill_done: float = -1.0
    finish_time: float = -1.0
    routed_to: str = ""  # cluster frontend: name of the serving replica
    # True when the engine shortened max_new_tokens to fit its per-request
    # token capacity (paged KV: prompt + output <= max_seq) — the stream
    # ends early by budget, not by eos.
    budget_capped: bool = False
    # tokens the overload ladder's brownout trimmed off max_new_tokens at
    # dispatch (per-tier budget trim under saturation); 0 = full budget.
    # A browned-out stream is a bit-identical PREFIX of the unclamped one
    # (greedy/seeded decode is position-keyed), so the degradation is
    # "shorter answer", never "different answer".
    browned_out_tokens: int = 0
    # rejection contract: finite seconds after which a resubmission has a
    # real chance (set with a "rejected:"/"shed:" fail_reason; 0 = n/a)
    retry_after_s: float = 0.0
    # prompt tokens served from the shared-prefix KV cache (their prefill
    # was skipped: the pages were aliased from the PrefixIndex); 0 = cold
    prefix_hit_tokens: int = 0
    # decode sampling configuration; the default is greedy argmax
    sampling: SamplingParams = field(default_factory=SamplingParams)
    # --- lifecycle (fault tolerance) ---
    state: RequestState = RequestState.QUEUED
    # whole-request deadline after arrival; 0 = never times out
    timeout_s: float = 0.0
    fail_reason: str = ""  # set with CANCELLED/TIMED_OUT/FAILED
    cancel_requested: bool = False  # set by cancel(); acted on next tick
    retries: int = 0  # failover re-submissions consumed (cluster frontend)
    preemptions: int = 0  # times this request was evicted mid-stream
    # generated tokens folded into ``prompt`` by preemption (restore
    # context); ``output`` keeps them too, so the client-visible stream
    # is unchanged and ``done`` keeps counting against the full budget
    restored_tokens: int = 0
    # --- observability ---
    # span trace stamped by engine/frontend at phase boundaries; None
    # unless tracing is enabled somewhere along the request's path.
    # Survives preemption AND failover (reset_for_retry leaves it alone)
    # so one trace tells the request's whole story across replicas.
    trace: Optional[Trace] = None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def done(self) -> bool:
        return len(self.output) >= self.max_new_tokens

    @property
    def ttft(self) -> float:
        """Time to first token (prefill completion) relative to arrival."""
        if self.prefill_done < 0:
            return -1.0
        return self.prefill_done - self.arrival_time

    @property
    def tpot(self) -> float:
        """Mean time per output token over the decode phase (excludes the
        prefill token); -1 before completion or for single-token streams."""
        if self.finish_time < 0 or self.prefill_done < 0:
            return -1.0
        n_decode = len(self.output) - 1
        if n_decode <= 0:
            return 0.0
        return (self.finish_time - self.prefill_done) / n_decode

    @property
    def ttft_deadline(self) -> float:
        """Absolute deadline for the first token — the EDF ordering key.
        Untracked requests sort last (infinite deadline)."""
        if self.ttft_slo_s <= 0:
            return float("inf")
        return self.arrival_time + self.ttft_slo_s

    def meets_slo(self) -> Optional[bool]:
        """True/False once finished against the declared SLOs; None when
        the request declares no SLO (untracked — excluded from goodput)."""
        if self.ttft_slo_s <= 0 and self.tpot_slo_s <= 0:
            return None
        ok = True
        if self.ttft_slo_s > 0:
            ok = ok and 0 <= self.ttft <= self.ttft_slo_s
        if self.tpot_slo_s > 0:
            ok = ok and 0 <= self.tpot <= self.tpot_slo_s
        return ok

    # -- lifecycle ---------------------------------------------------------
    @property
    def remaining_tokens(self) -> int:
        """Tokens still owed against the budget (restore-aware: a
        preempted request's folded tokens are already in ``output``)."""
        return max(0, self.max_new_tokens - len(self.output))

    @property
    def jct_deadline(self) -> float:
        """Absolute whole-request abort deadline (inf = never)."""
        if self.timeout_s <= 0:
            return float("inf")
        return self.arrival_time + self.timeout_s

    def cancel(self):
        """Client-side cancellation: flags the request; the engine (or the
        frontend, if still queued there) aborts it at its next tick and
        frees the slot and pages it holds. Idempotent; a no-op once the
        request reached a terminal state."""
        self.cancel_requested = True

    def overdue(self, now: float) -> Optional["RequestState"]:
        """The terminal state a doomed request should abort into at
        ``now`` — CANCELLED beats TIMED_OUT — or None while healthy."""
        if self.cancel_requested:
            return RequestState.CANCELLED
        if now > self.jct_deadline:
            return RequestState.TIMED_OUT
        return None

    def fold_output_into_prompt(self):
        """Preemption support: generated-but-unfolded tokens become prompt
        context, so re-admission treats them as prefill input (and the
        prefix-cache hit path can restore them with zero recompute). The
        tokens stay in ``output`` — the client-visible stream and the
        ``done`` budget arithmetic are unchanged."""
        new = self.output[self.restored_tokens:]
        if new:
            self.prompt = np.concatenate(
                [np.asarray(self.prompt, np.int32),
                 np.asarray(new, np.int32)])
            self.restored_tokens = len(self.output)

    def reset_for_retry(self):
        """Rewind to a just-submitted state for failover replay on a
        surviving replica: unfold any preemption context and drop every
        generated token. Seeded sampling keys noise by (seed, absolute
        position), so the replayed stream is bit-identical to the lost
        one — replay is safe to stream to a deduplicating client."""
        if self.restored_tokens:
            self.prompt = np.asarray(
                self.prompt[:self.prompt_len - self.restored_tokens],
                np.int32)
            self.restored_tokens = 0
        self.output = []
        self.prefill_done = -1.0
        self.finish_time = -1.0
        self.routed_to = ""
        self.prefix_hit_tokens = 0
        self.state = RequestState.QUEUED


@dataclass
class TenantMetrics:
    """Per-tenant serving counters + TTFT tail (overload control's
    accounting unit). Exactly mergeable across replicas like everything
    else in ``ServeMetrics``: counters add, the histogram merges bucket-
    for-bucket — so cluster-wide per-tenant goodput needs no sample
    shipping. Ships on the ``LoadReport`` v4 wire via ``to_wire``."""

    admitted: int = 0  # requests that reached a slot (first token emitted)
    completed: int = 0
    total_tokens: int = 0
    rejected: int = 0  # typed rejections (rate limit / ladder / unservable)
    shed: int = 0  # dropped by the degradation ladder or deadline-doom
    browned_out: int = 0  # served with a ladder-trimmed token budget
    brownout_trimmed_tokens: int = 0  # tokens the trims removed in total
    slo_tracked: int = 0
    slo_met: int = 0
    ttfts: Histogram = field(default_factory=latency_histogram)

    @property
    def goodput(self) -> float:
        if not self.slo_tracked:
            return 1.0
        return self.slo_met / self.slo_tracked

    def merge(self, other: "TenantMetrics") -> "TenantMetrics":
        self.admitted += other.admitted
        self.completed += other.completed
        self.total_tokens += other.total_tokens
        self.rejected += other.rejected
        self.shed += other.shed
        self.browned_out += other.browned_out
        self.brownout_trimmed_tokens += other.brownout_trimmed_tokens
        self.slo_tracked += other.slo_tracked
        self.slo_met += other.slo_met
        self.ttfts.merge(other.ttfts)
        return self

    _COUNTERS = ("admitted", "completed", "total_tokens", "rejected",
                 "shed", "browned_out", "brownout_trimmed_tokens",
                 "slo_tracked", "slo_met")

    def to_wire(self) -> tuple:
        """Hashable ((counter values...), ttft-histogram-wire-or-()) —
        one ``LoadReport.tenant_stats`` row body."""
        return (tuple(getattr(self, f) for f in self._COUNTERS),
                self.ttfts.to_wire() if self.ttfts.count else ())

    @classmethod
    def from_wire(cls, w) -> "TenantMetrics":
        counters, hist = w
        tm = cls(**dict(zip(cls._COUNTERS, (int(c) for c in counters))))
        if hist:
            tm.ttfts = Histogram.from_wire(hist)
        return tm


@dataclass
class ServeMetrics:
    """Aggregated server-side + client-side metrics (survey §3.2.3).

    Latency series are bounded fixed-bucket histograms (see
    repro_torch.serving.metrics), not sample lists: memory stays O(buckets)
    under sustained traffic, ``merge`` stays exact across replicas
    (bucket counts and sum/count/min/max add), and percentiles come from
    the histogram within one bucket width of the sample-exact value.
    The old list call sites keep working — ``Histogram.append`` is an
    ``observe`` alias and ``extend`` folds iterables.
    """

    completed: int = 0
    total_tokens: int = 0
    total_time: float = 0.0
    latencies: Histogram = field(default_factory=latency_histogram)
    jcts: Histogram = field(default_factory=latency_histogram)  # completion
    ttfts: Histogram = field(default_factory=latency_histogram)  # first token
    tpots: Histogram = field(default_factory=latency_histogram)  # per token
    sla_violations: int = 0
    decode_ticks: int = 0  # batched decode steps executed
    host_syncs: int = 0  # device->host token transfers (1 per N ticks)
    prefill_chunks: int = 0  # chunked-prefill pieces interleaved with decode
    # --- shared-prefix KV cache ---
    prefix_hits: int = 0  # admissions that aliased cached prefix pages
    prefix_hit_tokens: int = 0  # prompt tokens whose prefill was skipped
    # --- stochastic decode ---
    sampled_requests: int = 0  # admissions with non-greedy SamplingParams
    # --- SLO attainment (requests declaring ttft_slo_s / tpot_slo_s) ---
    slo_tracked: int = 0  # finished requests that declared any SLO
    slo_met: int = 0  # ...that met every declared SLO
    ttft_slo_misses: int = 0
    tpot_slo_misses: int = 0
    # --- fault tolerance / lifecycle ---
    rejected: int = 0  # typed RequestRejected outcomes (never admitted)
    cancelled: int = 0  # client cancel() honored
    timed_out: int = 0  # whole-request deadline aborts
    shed: int = 0  # SLO-doomed requests dropped under overload
    browned_out: int = 0  # requests served with a ladder-trimmed budget
    failed: int = 0  # mid-stream failures (e.g. bypassed reservation)
    preempted: int = 0  # slot evictions (victim requeued for restore)
    preempt_restores: int = 0  # preempted requests re-admitted
    retried: int = 0  # failover re-submissions (cluster frontend)
    failed_over: int = 0  # requests harvested from a failed replica
    # --- MoE layers (port-only, kept on the host from the steps' shapes;
    # not in ``registry``, which mirrors the reference's exposition) ---
    moe_routed_pairs: int = 0  # (token, expert) pairs, idle lanes' too
    moe_expert_rows: int = 0  # rows the expert products computed
    # --- multi-tenant overload control (keyed by Request.tenant; untagged
    # traffic stays out of this dict, so the single-tenant path is free) ---
    tenants: Dict[str, TenantMetrics] = field(default_factory=dict)

    def tenant(self, name: str) -> TenantMetrics:
        """The named tenant's accumulator (created on first touch)."""
        tm = self.tenants.get(name)
        if tm is None:
            tm = self.tenants[name] = TenantMetrics()
        return tm

    @property
    def qps(self) -> float:
        return self.completed / self.total_time if self.total_time else 0.0

    @property
    def throughput_tps(self) -> float:
        return self.total_tokens / self.total_time if self.total_time else 0.0

    def p(self, q: float) -> float:
        return self.latencies.percentile(q)

    @property
    def mean_jct(self) -> float:
        return self.jcts.mean  # exact: histogram keeps a raw-sum accumulator

    def ttft_p(self, q: float) -> float:
        return self.ttfts.percentile(q)

    def tpot_p(self, q: float) -> float:
        return self.tpots.percentile(q)

    # -- SLO attainment ----------------------------------------------------
    def record_slo(self, req: Request):
        """Fold one finished request's SLO verdict into the counters
        (called by the engine at finalize; no-op for untracked requests)."""
        verdict = req.meets_slo()
        if verdict is None:
            return
        self.slo_tracked += 1
        if verdict:
            self.slo_met += 1
        if req.tenant:
            tm = self.tenant(req.tenant)
            tm.slo_tracked += 1
            if verdict:
                tm.slo_met += 1
        if req.ttft_slo_s > 0 and not (0 <= req.ttft <= req.ttft_slo_s):
            self.ttft_slo_misses += 1
        if req.tpot_slo_s > 0 and not (0 <= req.tpot <= req.tpot_slo_s):
            self.tpot_slo_misses += 1

    @property
    def goodput(self) -> float:
        """Fraction of SLO-tracked completions meeting every declared SLO
        (1.0 when nothing is tracked — no SLO means nothing to violate)."""
        if not self.slo_tracked:
            return 1.0
        return self.slo_met / self.slo_tracked

    def merge(self, other: "ServeMetrics"):
        """Accumulate another engine's counters (cluster-wide rollup)."""
        self.completed += other.completed
        self.total_tokens += other.total_tokens
        self.total_time = max(self.total_time, other.total_time)
        self.latencies.merge(other.latencies)  # exact histogram merge
        self.jcts.merge(other.jcts)
        self.ttfts.merge(other.ttfts)
        self.tpots.merge(other.tpots)
        self.sla_violations += other.sla_violations
        self.decode_ticks += other.decode_ticks
        self.host_syncs += other.host_syncs
        self.prefill_chunks += other.prefill_chunks
        self.prefix_hits += other.prefix_hits
        self.prefix_hit_tokens += other.prefix_hit_tokens
        self.sampled_requests += other.sampled_requests
        self.slo_tracked += other.slo_tracked
        self.slo_met += other.slo_met
        self.ttft_slo_misses += other.ttft_slo_misses
        self.tpot_slo_misses += other.tpot_slo_misses
        self.rejected += other.rejected
        self.cancelled += other.cancelled
        self.timed_out += other.timed_out
        self.shed += other.shed
        self.browned_out += other.browned_out
        self.failed += other.failed
        self.preempted += other.preempted
        self.preempt_restores += other.preempt_restores
        self.retried += other.retried
        self.failed_over += other.failed_over
        self.moe_routed_pairs += other.moe_routed_pairs
        self.moe_expert_rows += other.moe_expert_rows
        for name, tm in other.tenants.items():
            self.tenant(name).merge(tm)

    # -- observability -----------------------------------------------------
    _HISTOGRAMS = (("latency_s", "latencies"), ("jct_s", "jcts"),
                   ("ttft_s", "ttfts"), ("tpot_s", "tpots"))

    def histogram_wire(self) -> tuple:
        """Non-empty latency histograms in LoadReport wire form:
        ((name, sparse-histogram-tuple), ...)."""
        return tuple((name, getattr(self, attr).to_wire())
                     for name, attr in self._HISTOGRAMS
                     if getattr(self, attr).count)

    def tenant_wire(self) -> tuple:
        """Per-tenant rollups in LoadReport v4 wire form:
        ((tenant, (counters...), ttft-wire-or-()), ...), sorted by name."""
        return tuple((name, *tm.to_wire())
                     for name, tm in sorted(self.tenants.items()))

    def registry(self, prefix: str = "serving_") -> "MetricsRegistry":
        """Snapshot this struct as a MetricsRegistry for exposition.
        Histograms are registered by reference (zero copies); counters
        are copied point-in-time values."""
        from repro_torch.serving.metrics import MetricsRegistry
        reg = MetricsRegistry()
        for name, attr in self._HISTOGRAMS:
            reg.register(f"{prefix}{name.rsplit('_', 1)[0]}_seconds",
                         getattr(self, attr))
        for f in ("completed", "total_tokens", "rejected", "cancelled",
                  "timed_out", "shed", "browned_out", "failed", "preempted",
                  "preempt_restores", "retried", "failed_over",
                  "decode_ticks", "host_syncs", "prefill_chunks",
                  "prefix_hits", "prefix_hit_tokens", "sampled_requests",
                  "slo_tracked", "slo_met", "ttft_slo_misses",
                  "tpot_slo_misses"):
            reg.set_counter(f"{prefix}{f}_total", getattr(self, f))
        for name, tm in sorted(self.tenants.items()):
            lbl = f'{{tenant="{name}"}}'
            for f in TenantMetrics._COUNTERS:
                reg.set_counter(f"{prefix}tenant_{f}_total{lbl}",
                                getattr(tm, f))
            reg.set_gauge(f"{prefix}tenant_goodput{lbl}", tm.goodput)
            if tm.ttfts.count:
                reg.register(f"{prefix}tenant_ttft_seconds{lbl}", tm.ttfts)
        reg.set_gauge(f"{prefix}goodput", self.goodput)
        reg.set_gauge(f"{prefix}qps", self.qps)
        reg.set_gauge(f"{prefix}throughput_tokens_per_s",
                      self.throughput_tps)
        return reg
