"""Multi-engine cluster frontend: SLO-aware routing of live traffic across
``ServingEngine`` replicas (the survey's MIMD quadrant made real); the
port's copy of the JAX package's ``serving/cluster.py``, over the port's
engine. Every estimate is priced at the replica's own card
(``engine.chip``) and mesh (``engine.mesh_axes``).

The survey (§2) calls for a datacenter tier that "understands different
models' requirements and places one or multiple queries intelligently onto
hardware". ``repro_torch.core.mimd.router`` has that tier for *simulated*
instances; this module unifies it with reality:

  * ``EngineInstance`` adapts a live ``ServingEngine`` to the router's
    ``Instance`` protocol — ``load()`` / ``predicted_completion()`` read
    real telemetry from ``ServingEngine.load_report()`` (free slots, free
    pages, queued prefill tokens, cost-model backlog seconds), so every
    ``ServiceRouter`` policy (round-robin, least-loaded,
    power-of-two-choices, predicted-completion) runs unchanged over live
    engines;
  * predictions are closed-loop: each instance owns an
    ``InterferencePredictor`` that folds observed TTFT / completion
    latency back into a multiplicative residual on the cost model
    (``corrected_latency``), so a replica that is slower than the model
    thinks (noisy host, co-tenant, weaker chip) organically repels load;
  * ``ClusterFrontend`` owns the replicas plus one shared frontend queue
    with SLO-aware EDF ordering (earliest TTFT deadline dispatches first),
    and exposes autoscaling hooks (``autoscale``: grow a pool via a spawn
    callback under queue pressure, retire + drain the least-loaded replica
    when idle).

Dispatch is eager: a routed request enters its engine's own admission
machinery (accumulator -> backlog -> paged backpressure), so per-engine
invariants — all-or-nothing page reservation, single-trace probes,
bit-identical token streams — hold unchanged under the cluster. A retired
replica keeps being stepped until it drains empty; it just stops
receiving routes.

Per-request ``SamplingParams`` ride the ``Request`` across the frontend
untouched, and a stochastic stream is a pure function of (seed, token
position) — never of the replica, slot, or batch the router lands it in —
so seeded sampled streams are bit-identical under every routing policy,
autoscale event, and replica count.

Fault tolerance: the frontend
keeps its own per-replica ledger of dispatched-but-unresolved requests.
A replica that raises ``EngineFailure`` (crash) or whose progress
signature freezes past ``health_timeout_s`` while holding work (hang) is
deregistered, and every request on its ledger is replayed on survivors —
``reset_for_retry`` + position-keyed seeded sampling make the replayed
streams bit-identical — under a per-request retry budget with
exponential backoff. Typed rejections (unknown model, oversize prompt)
resolve as FAILED outcomes instead of exceptions.

Overload control (``serving/overload.py``): with
``tenants`` registered, the frontend queue is a token-cost-weighted
deficit-round-robin ``WeightedFairQueue`` (EDF within a tenant, DRR
across tenants) and dispatch is *paced* — each replica's queue is fed
only to a bounded depth, so excess burst load waits at the frontend
where fair queueing (not engine-side EDF luck) decides who goes next.
Per-tenant ``TokenBucket`` admission and the ``OverloadDetector``'s
degradation ladder (shed lowest tier -> brownout budget trims -> typed
reject-with-retry-after) ride on top; a ``CircuitBreaker`` keeps the
failover retry wave from re-flooding a replica that just recovered.
Without tenants, the queue degenerates to the exact old flat-EDF order
and dispatch stays eager — the single-tenant path is unchanged.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Dict, List, Mapping, Optional, Sequence, Union

from repro_torch.core.costmodel import estimate_decode, estimate_prefill
from repro_torch.core.mimd.router import Instance, ServiceRouter
from repro_torch.core.misd.interference import InterferencePredictor
from repro_torch.core.misd.scheduler import Device, Job
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.faults import EngineFailure
from repro_torch.serving.metrics import MetricsRegistry, latency_histogram
from repro_torch.serving.overload import (
    BROWNOUT,
    NORMAL,
    REJECT,
    SHED,
    CircuitBreaker,
    OverloadDetector,
    TenantAdmission,
    TenantClass,
    WeightedFairQueue,
)
from repro_torch.serving.request import (
    Request,
    RequestRejected,
    RequestState,
    ServeMetrics,
)
from repro_torch.serving.tracing import Trace

DEFAULT_POOL = ""  # model tag for homogeneous (single-model) clusters


class EngineInstance(Instance):
    """A live ``ServingEngine`` behind the router's ``Instance`` protocol.

    ``sync()`` mirrors the engine's cost-model backlog into the simulation
    field ``queue_s``, so router machinery written for simulated instances
    (``pressure``, ``want_scale``) keeps working; the routing-policy hooks
    themselves (``load`` / ``predicted_completion``) take a fresh
    ``load_report()`` every call — telemetry, not the mirror."""

    def __init__(self, name: str, engine: ServingEngine,
                 model: str = DEFAULT_POOL):
        super().__init__(
            name=name, model=model,
            # device speed mirrors the replica's chip count so router
            # machinery written for simulated instances scales its
            # fallback predictions on heterogeneous pools
            device=Device(name=f"dev:{name}", max_tenants=engine.slots,
                          speed=float(engine.n_chips)))
        self.engine = engine
        self.corrector = InterferencePredictor()
        # frontend-side accounting (per-replica utilization)
        self.routed = 0
        self.ticks = 0
        self.busy_ticks = 0
        # health-watchdog state: last virtual time the engine's progress
        # signature changed while it had work (None until first observed)
        self.last_progress_t = 0.0
        self._progress_sig = None

    def sync(self):
        self.queue_s = self.engine.load_report().backlog_s

    def load(self) -> float:
        """Instantaneous occupancy signal for least-loaded routing: queued
        requests plus busy slots, normalized by slot count so replicas of
        different widths compare fairly. No cost model involved."""
        rep = self.engine.load_report()
        busy = rep.slots - rep.free_slots
        return (rep.queued_requests + busy) / max(1, rep.slots)

    @staticmethod
    def _slot_wait_ticks(rep) -> float:
        """Decode ticks until a slot opens for ONE MORE request, simulating
        the engine's drain: each busy slot frees after its remaining token
        budget, the queued requests (in drain order) claim slots as they
        free, and the new request takes the next opening. Exact under
        FCFS/EDF + one-token-per-tick; the closed loop absorbs the rest
        (fused scans, chunk interleave)."""
        frees = [0.0] * rep.free_slots + sorted(rep.active_remaining)
        frees = frees[:max(1, rep.slots)]
        heapq.heapify(frees)
        for budget in rep.queued_budgets:
            heapq.heappush(frees, heapq.heappop(frees) + budget)
        return heapq.heappop(frees)

    def queue_wait_s(self, rep=None) -> float:
        """Uncorrected cost-model seconds a new request would wait before
        its slot opens: slot-drain simulation plus queued prefill work.
        Pass a ``load_report()`` snapshot to amortize it across calls."""
        rep = rep if rep is not None else self.engine.load_report()
        return rep.tick_est_s * self._slot_wait_ticks(rep) + rep.queued_prefill_s

    def prefix_hit_s(self, job: Job) -> float:
        """Live prefix-affinity probe: cost-model prefill seconds this
        replica's ``PrefixIndex`` would skip for the job's prompt (0 when
        the cache is off, the prompt is unknown, or nothing matches)."""
        if job.tokens is None or job.prompt_tokens <= 0:
            return 0.0
        hit = self.engine.prefix_match_len(job.tokens)
        if hit <= 0:
            return 0.0
        eng = self.engine
        full = estimate_prefill(eng.cfg, 1, job.prompt_tokens,
                                chip=eng.chip, n_chips=eng.n_chips,
                                mesh_axes=eng.mesh_axes).latency_s
        rest = estimate_prefill(eng.cfg, 1, job.prompt_tokens,
                                chip=eng.chip, n_chips=eng.n_chips,
                                mesh_axes=eng.mesh_axes,
                                prefix_hit=hit).latency_s
        return max(0.0, full - rest)

    def service_s(self, job: Job) -> float:
        """The job's isolated service time ON THIS replica: re-estimated
        from its token shape with this engine's chip count (heterogeneous
        pools) and discounted by the prefix-affinity hit. Falls back to
        the pool-reference ``job.service_s`` when the token shape is
        unknown."""
        if job.prompt_tokens <= 0:
            return job.service_s
        eng = self.engine
        hit = (self.engine.prefix_match_len(job.tokens)
               if job.tokens is not None else 0)
        pre = estimate_prefill(eng.cfg, 1, job.prompt_tokens,
                               chip=eng.chip, n_chips=eng.n_chips,
                               mesh_axes=eng.mesh_axes,
                               prefix_hit=max(0, hit)).latency_s
        dec = estimate_decode(eng.cfg, 1, eng.window,
                              chip=eng.chip, n_chips=eng.n_chips,
                              mesh_axes=eng.mesh_axes).latency_s
        return pre + dec * max(0, job.new_tokens - 1)

    def predicted_completion(self, job: Job) -> float:
        """Cost-model completion estimate on THIS replica, residual-
        corrected by what the closed loop has observed here: seconds until
        a decode slot opens for the job (slot-drain simulation over the
        telemetry), plus the engine's queued prefill work, plus the job's
        own service time on this hardware (chip count + prefix affinity)."""
        return self.corrector.corrected_latency(
            self.queue_wait_s() + self.service_s(job))

    def predicted_wait(self, prefill_s: float, rep=None) -> float:
        """Corrected seconds until the job's FIRST token (TTFT component):
        slot wait plus queued prefill work plus the job's own prefill."""
        return self.corrector.corrected_latency(
            self.queue_wait_s(rep) + prefill_s)

    @property
    def utilization(self) -> float:
        return self.busy_ticks / self.ticks if self.ticks else 0.0


class ClusterFrontend:
    """Owns N live engine replicas (homogeneous, or pools keyed by model
    tag) behind one shared, SLO-aware frontend queue.

    ``engines``: a sequence of ``ServingEngine`` (single default pool) or a
    mapping ``model -> sequence of engines`` (multi-model pools; requests
    select a pool via ``Request.model``). ``policy``: any
    ``repro_torch.core.mimd.router.POLICIES`` entry. ``edf``: order the frontend
    queue by TTFT deadline (earliest first; untracked requests last) —
    False preserves FIFO arrival order. ``edf`` also turns on each
    engine's EDF backlog drain so deadline order survives engine-side
    queueing.
    """

    def __init__(self,
                 engines: Union[Sequence[ServingEngine],
                                Mapping[str, Sequence[ServingEngine]]],
                 *, policy: str = "predicted", seed: int = 0,
                 edf: bool = True, health_timeout_s: float = 0.0,
                 max_retries: int = 3, retry_backoff_s: float = 0.0,
                 tracing: bool = False,
                 tenants: Optional[Mapping[str, TenantClass]] = None,
                 overload: Optional[OverloadDetector] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 fair_quantum: float = 256.0,
                 dispatch_depth: Optional[int] = None):
        self.router = ServiceRouter(policy=policy, seed=seed)
        self.edf = edf
        # --- multi-tenant overload control (serving/overload.py) ---
        # tenants: name -> TenantClass turns on weighted-fair queueing +
        # paced dispatch; overload: the degradation-ladder detector;
        # breaker: circuit breaker over the failover/recovery path.
        self.tenants: Dict[str, TenantClass] = dict(tenants or {})
        self.fair = bool(self.tenants)
        self.overload = overload
        self.breaker = breaker
        self.dispatch_depth = dispatch_depth
        self._admission = (TenantAdmission(self.tenants)
                           if self.tenants else None)
        tiers = [tc.tier for tc in self.tenants.values()]
        self._top_tier = max(tiers) if tiers else 0
        self._low_tier = min(tiers) if tiers else 0
        # frontend-side span tracing: every submitted request gets a Trace
        # stamped with queue/dispatch/failover events here; engines stamp
        # their phases into the SAME trace (engine-side tracing need not
        # be on), so one trace tells the request's cross-replica story
        self.tracing = tracing
        # fault tolerance: a replica whose progress signature freezes for
        # longer than health_timeout_s while it holds work is declared
        # failed (0 disables the watchdog — crashes are still caught via
        # EngineFailure); its requests fail over to survivors with at most
        # max_retries re-submissions per request, exponentially backed off
        # from retry_backoff_s (0 = immediate requeue).
        self.health_timeout_s = health_timeout_s
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.instances: List[EngineInstance] = []
        self.draining: List[EngineInstance] = []
        self.retired: List[EngineInstance] = []  # drained + reaped
        self.failed: List[EngineInstance] = []  # declared dead
        # the frontend queue: weighted-fair across tenants (DRR), EDF
        # within each tenant. With a single (untagged) tenant its drain
        # order is exactly the old flat-EDF heap's.
        # (the weights read the tenants dict, not self: a frontend that
        # its queue referred back to would free its replicas' device
        # memory only at the garbage collector's next pass)
        classes = self.tenants
        self._queue = WeightedFairQueue(
            edf=edf, quantum=fair_quantum,
            weight_of=lambda name: (classes[name].weight
                                    if name in classes else 1.0))
        self._seq = itertools.count()
        self._names = itertools.count()
        # per-replica ledger of dispatched-but-unresolved requests: the
        # frontend's own copy of what each replica owes it, harvested on
        # failure (a dead machine's memory cannot be read back)
        self._outstanding: Dict[str, Dict[int, Request]] = {}
        self._held_retries: List = []  # heap of (release_t, seq, Request)
        self._resolved: List[Request] = []  # frontend-resolved (no engine)
        self.metrics = ServeMetrics()  # frontend-level counters
        if isinstance(engines, Mapping):
            for model, pool in engines.items():
                for eng in pool:
                    self.add_engine(eng, model=model)
        else:
            for eng in engines:
                self.add_engine(eng)

    # -- pool management ---------------------------------------------------
    def add_engine(self, engine: ServingEngine,
                   model: str = DEFAULT_POOL,
                   name: Optional[str] = None) -> EngineInstance:
        """Register a live replica into ``model``'s pool (autoscale grow
        path). The engine starts receiving routes immediately."""
        if self.edf:
            engine.edf_backlog = True
        name = name or f"{model or 'pool'}/e{next(self._names)}"
        inst = EngineInstance(name, engine, model=model)
        self.router.register(inst)
        self.instances.append(inst)
        return inst

    def retire(self, inst_or_name) -> Optional[EngineInstance]:
        """Deregister a replica (autoscale shrink path): it stops receiving
        routes NOW, its queued-but-unstarted backlog migrates back through
        the frontend queue to be re-routed across survivors, and it keeps
        being stepped until its in-flight (slot-resident) work drains,
        then drops out of the cluster. Returns the retiring instance."""
        inst = self.router.deregister(inst_or_name)
        if inst is None:
            return None
        self.instances.remove(inst)
        self.draining.append(inst)
        # migrate unstarted work: the same requeue primitive failover
        # uses, minus the retry accounting (nothing was lost — these
        # requests never touched a slot on the retiree)
        ledger = self._outstanding.get(inst.name, {})
        for req in inst.engine.takeover_queue():
            ledger.pop(req.rid, None)
            req.routed_to = ""
            self._enqueue(req)
        return inst

    def pool(self, model: str = DEFAULT_POOL) -> List[EngineInstance]:
        return list(self.router.pools.get(model, []))

    @property
    def engines(self) -> List[ServingEngine]:
        return [i.engine for i in self.instances]

    # -- request path ------------------------------------------------------
    def submit(self, req: Request, now: float) -> bool:
        """Enqueue a request at the frontend queue. Routing happens at the
        next ``step``: every request submitted inside one tick is dispatched
        in EDF order (earliest TTFT deadline routes first — and therefore
        lands earliest in its engine's own queue), not arrival order.

        An unroutable request (unknown model tag) is a typed REJECTION,
        not an exception: it resolves as FAILED with a reason, counts in
        the frontend's ``metrics.rejected``, and surfaces from the next
        ``step`` — one bad request must never kill the frontend loop.
        Returns True iff the request was accepted into the queue."""
        if self.tracing and req.trace is None:
            req.trace = Trace(req.rid)
            req.trace.begin("queued", now)
        if req.model not in self.router.pools or not self.router.pools[req.model]:
            self._resolve(req, now, RequestState.FAILED,
                          f"rejected: no engine pool for model "
                          f"{req.model!r} (pools: {list(self.router.pools)})")
            self._count_rejected(req)
            return False
        tc = self.tenants.get(req.tenant)
        if tc is not None:
            req.tier = tc.tier  # the registered class is authoritative
        # degradation ladder, top rung: under sustained saturation every
        # sub-protected submission is refused OUTRIGHT with a finite
        # cost-model retry horizon — the serverless-inference contract
        if (self.overload is not None and self.overload.level >= REJECT
                and req.tier < self._top_tier):
            req.retry_after_s = self.overload.retry_after_s()
            self._resolve(req, now, RequestState.FAILED,
                          f"rejected: cluster overloaded (ladder="
                          f"{self.overload.level_name}); retry after "
                          f"{req.retry_after_s:.3f}s")
            self._count_rejected(req)
            return False
        # per-tenant token-bucket rate limit (typed, finite retry-after)
        if self._admission is not None:
            try:
                self._admission.admit(req, now)
            except RequestRejected as e:
                req.retry_after_s = e.retry_after_s
                self._resolve(req, now, RequestState.FAILED, str(e))
                self._count_rejected(req)
                return False
        self._enqueue(req)
        return True

    def _enqueue(self, req: Request):
        self._queue.push(req)

    def _count_rejected(self, req: Request):
        self.metrics.rejected += 1
        if req.tenant:
            self.metrics.tenant(req.tenant).rejected += 1

    def _resolve(self, req: Request, now: float, state: RequestState,
                 reason: str):
        """Terminally resolve a request at the frontend (it never reaches —
        or never returns from — an engine); surfaced by the next step."""
        req.state = state
        req.fail_reason = reason
        req.finish_time = now
        if req.trace is not None:
            req.trace.close_all(now)
            req.trace.event("abort", now, state=state.value,
                            reason=reason[:120])
        self._resolved.append(req)

    def _dispatch_credit(self, now: float, reports=None) -> Optional[int]:
        """Paced-dispatch budget for this tick (fair mode only): feed
        each live replica's queue to a bounded depth (``dispatch_depth``,
        default its slot count) and hold the rest at the frontend, where
        DRR — not engine-side EDF — decides who goes next. None =
        unlimited (the pre-fair eager dispatch)."""
        if not self.fair:
            return None
        credit = 0
        for inst in self.instances:
            rep = (reports or {}).get(inst.name)
            if rep is None:
                rep = inst.engine.load_report()
            depth = (self.dispatch_depth if self.dispatch_depth is not None
                     else rep.slots)
            credit += max(0, depth + rep.free_slots - rep.queued_requests)
        return credit

    def _shed(self, req: Request, now: float):
        """Degradation-ladder shed: a lowest-tier request dropped under
        overload, with the same retry-after contract as a rejection."""
        req.retry_after_s = (self.overload.retry_after_s()
                             if self.overload is not None else 0.0)
        if req.trace is not None:
            req.trace.event("shed", now, tier=req.tier,
                            level=self.overload.level_name)
        self.metrics.shed += 1
        if req.tenant:
            self.metrics.tenant(req.tenant).shed += 1
        self._resolve(req, now, RequestState.TIMED_OUT,
                      f"shed: overload ladder ({self.overload.level_name}) "
                      f"dropped tier {req.tier}; retry after "
                      f"{req.retry_after_s:.3f}s")

    def _brownout(self, req: Request, now: float):
        """Degradation-ladder brownout: trim a sub-protected request's
        decode budget (recorded on the request + in metrics; the served
        stream stays a bit-identical prefix of the unclamped one)."""
        tc = self.tenants.get(req.tenant)
        frac = tc.brownout_frac if tc is not None else 0.5
        cap = max(1, int(req.max_new_tokens * frac))
        if cap >= req.max_new_tokens:
            return
        trimmed = req.max_new_tokens - cap
        req.max_new_tokens = cap
        req.browned_out_tokens = trimmed
        if req.trace is not None:
            req.trace.event("brownout", now, tier=req.tier,
                            trimmed=trimmed, budget=cap)

    def _dispatch(self, now: float, reports=None):
        """Drain the frontend queue in weighted-fair order (single-tenant:
        plain EDF), routing each request to the policy-chosen replica.
        Without tenants routing is eager — engine-side backlogs (and
        their paged backpressure) do the holding — so every policy pays
        the same queueing machinery and differs ONLY in choice. In fair
        mode dispatch is paced by ``_dispatch_credit`` and the overload
        ladder sheds/brownouts sub-protected work at the pop point."""
        level = self.overload.level if self.overload is not None else NORMAL
        credit = self._dispatch_credit(now, reports)
        held = []
        while self._queue and (credit is None or credit > 0):
            req = self._queue.pop()
            doomed = req.overdue(now)
            if doomed is not None:
                # cancelled / JCT-expired while still queued at the
                # frontend: resolve here, never spend a route on it
                if doomed is RequestState.CANCELLED:
                    self.metrics.cancelled += 1
                    self._resolve(req, now, doomed, "cancelled at frontend")
                else:
                    self.metrics.timed_out += 1
                    self._resolve(req, now, doomed,
                                  "deadline passed while queued at frontend")
                continue
            # degradation ladder at the pop point: shed the lowest tier
            # outright, trim lower tiers' budgets under brownout. The
            # protected (top) tier passes untouched at every level.
            if (level >= SHED and req.tier <= self._low_tier
                    and self._low_tier < self._top_tier):
                self._shed(req, now)
                continue
            if (level >= BROWNOUT and req.tier < self._top_tier
                    and not req.browned_out_tokens):
                self._brownout(req, now)
            if not self.router.pools.get(req.model):
                # pool emptied (every replica retired or failed) after
                # this request was accepted: hold it at the frontend — it
                # dispatches the moment add_engine repopulates the pool —
                # rather than crashing the step and losing the request
                held.append(req)
                continue
            eligible = None
            if self.breaker is not None:
                pool = self.router.pools.get(req.model, [])
                eligible = {i.name for i in pool
                            if self.breaker.allow(i.name, now)}
                if not eligible:
                    # every replica open/half-open at probe capacity:
                    # hold — the breaker cooldown bounds the wait
                    held.append(req)
                    continue
                if len(eligible) == len(pool):
                    eligible = None  # all healthy: no filtering cost
            job = self._job_for(req, now)
            inst = self.router.route(job, eligible=eligible)
            if inst is None:
                held.append(req)
                continue
            # stash the closed-loop anchors on the request: the RAW
            # (uncorrected) predictions, so the residual is learned
            # against the cost model itself — observing the corrected
            # value would converge to sqrt of the true slowdown. One
            # telemetry snapshot serves both (route() already took
            # per-instance snapshots for its own scoring).
            rep = inst.engine.load_report()
            base = inst.queue_wait_s(rep)
            # one radix probe + one estimate pair for both anchors (the
            # per-candidate probes during route() scoring are inherent
            # to the policy; the chosen replica's is not re-run)
            eng = inst.engine
            hit = eng.prefix_match_len(req.prompt)
            pre_s = estimate_prefill(eng.cfg, 1, max(1, req.prompt_len),
                                     chip=eng.chip, n_chips=eng.n_chips,
                                     mesh_axes=eng.mesh_axes,
                                     prefix_hit=hit).latency_s
            dec_s = estimate_decode(eng.cfg, 1, eng.window,
                                    chip=eng.chip, n_chips=eng.n_chips,
                                    mesh_axes=eng.mesh_axes).latency_s
            req._pred_wait_s = base + pre_s
            req._pred_complete_s = (base + pre_s
                                    + dec_s * max(0, req.max_new_tokens - 1))
            req._dispatch_t = now
            req.routed_to = inst.name
            inst.routed += 1
            if req.trace is not None:
                req.trace.event("dispatch", now, replica=inst.name,
                                pred_wait_s=req._pred_wait_s)
            try:
                accepted = inst.engine.submit(req, now)
            except EngineFailure:
                # the chosen replica died between routing decisions: fail
                # it over and re-run this request through the (now
                # smaller) pool — survivors pick it up this same tick
                self._fail_instance(inst, now)
                self._retry(req, now)
                continue
            if accepted is not False:
                # ledger entry until the engine resolves it (engine-side
                # typed rejections return False and self-report through
                # the engine's own finished stream)
                self._outstanding.setdefault(inst.name, {})[req.rid] = req
                if self.breaker is not None:
                    self.breaker.note_dispatch(inst.name, now)
                if credit is not None:
                    credit -= 1
        for req in held:
            self._enqueue(req)

    def _job_for(self, req: Request, now: float) -> Job:
        pool = self.router.pools[req.model]
        eng = pool[0].engine
        cfg, chip, n_chips = eng.cfg, eng.chip, eng.n_chips
        mesh_axes = eng.mesh_axes
        ctx = eng.window
        dec = estimate_decode(cfg, 1, ctx, chip=chip, n_chips=n_chips,
                              mesh_axes=mesh_axes)
        pre_s = estimate_prefill(cfg, 1, max(1, req.prompt_len),
                                 chip=chip, n_chips=n_chips,
                                 mesh_axes=mesh_axes).latency_s
        service = pre_s + dec.latency_s * max(0, req.max_new_tokens - 1)
        return Job(jid=req.rid, model=req.model, demand=dec.demand,
                   service_s=service, arrival=now, priority=req.priority,
                   sla_s=req.ttft_slo_s,
                   # token shape: lets each EngineInstance re-estimate
                   # service for its own chips and probe prefix affinity
                   prompt_tokens=req.prompt_len,
                   new_tokens=req.max_new_tokens, tokens=req.prompt)

    def step(self, now: float) -> List[Request]:
        """One cluster tick: release due retries, dispatch anything queued,
        step every replica (live and draining) catching replica death,
        watchdog wedged replicas, observe finished requests into each
        replica's closed-loop corrector, and reap fully-drained retirees.
        The returned list carries every request resolved this tick —
        finished, rejected, aborted, or failed over to exhaustion."""
        while self._held_retries and self._held_retries[0][0] <= now:
            _, _, req = heapq.heappop(self._held_retries)
            self._enqueue(req)
        reports = None
        if self.fair or self.overload is not None:
            reports = {i.name: i.engine.load_report()
                       for i in self.instances}
            if self.overload is not None:
                # frontend-queue drain estimate: queued token cost over
                # the pool's aggregate per-tick token rate — under paced
                # dispatch the burst waits HERE, invisible to engine-side
                # backlog_s
                ticks = [r.tick_est_s for r in reports.values()
                         if r.tick_est_s > 0]
                slots = sum(r.slots for r in reports.values())
                fb = (self._queue.queued_cost
                      * (sum(ticks) / len(ticks)) / max(1, slots)
                      if ticks else 0.0)
                self.overload.observe(now, reports.values(),
                                      frontend_backlog_s=fb)
        self._dispatch(now, reports)
        finished: List[Request] = []
        for inst in list(self.instances) + list(self.draining):
            eng = inst.engine
            inst.ticks += 1
            busy = bool(eng.n_decoding or eng.n_prefilling or eng.backlog
                        or eng.admission.pending)
            if busy:
                inst.busy_ticks += 1
            try:
                out = eng.step(now)
            except EngineFailure:
                self._fail_instance(inst, now)
                continue
            ledger = self._outstanding.get(inst.name, {})
            for req in out:
                ledger.pop(req.rid, None)
                self._observe(inst, req)
                if (self.breaker is not None
                        and req.state is RequestState.FINISHED):
                    self.breaker.note_success(inst.name, now)
                finished.append(req)
            if self._wedged(inst, now, busy):
                self._fail_instance(inst, now)
                continue
            inst.sync()
        reaped = [i for i in self.draining if i.engine.idle]
        if reaped:
            # keep reaped retirees for the metrics rollup — the traffic
            # they served must not vanish from completed/goodput
            self.retired.extend(reaped)
            self.draining = [i for i in self.draining
                             if not i.engine.idle]
        if self._resolved:
            finished.extend(self._resolved)
            self._resolved = []
        return finished

    # -- failure detection + failover --------------------------------------
    def _wedged(self, inst: EngineInstance, now: float, busy: bool) -> bool:
        """Staleness watchdog over the replica's progress signature: a
        replica that HOLDS work but whose observable counters have not
        moved for health_timeout_s is wedged (hung host, livelocked
        runtime) — indistinguishable from slow until the timeout, exactly
        as in production. Idle replicas are healthy by definition."""
        if self.health_timeout_s <= 0:
            return False
        eng, m = inst.engine, inst.engine.metrics
        sig = (m.decode_ticks, m.prefill_chunks, m.completed, m.rejected,
               m.cancelled, m.timed_out, m.shed, m.failed, m.preempted,
               eng.n_decoding, eng.n_prefilling, len(eng.backlog),
               len(eng.admission.pending))
        if sig != inst._progress_sig or not busy:
            inst._progress_sig = sig
            inst.last_progress_t = now
            return False
        return now - inst.last_progress_t > self.health_timeout_s

    def _fail_instance(self, inst: EngineInstance, now: float):
        """Declare a replica dead: deregister it from routing, and fail
        over every request the ledger says it still owes — its in-flight
        AND queued work — to the survivors. The dead engine is never
        touched again (a crashed machine's memory is unreadable); requests
        are replayed from the frontend's own copies."""
        self.router.deregister(inst)
        if inst in self.instances:
            self.instances.remove(inst)
        if inst in self.draining:
            self.draining.remove(inst)
        inst.failed = True
        self.failed.append(inst)
        if self.breaker is not None:
            self.breaker.trip(inst.name, now)
        for req in list(self._outstanding.pop(inst.name, {}).values()):
            self.metrics.failed_over += 1
            self._retry(req, now)

    def revive(self, inst: EngineInstance, now: float = 0.0
               ) -> EngineInstance:
        """Re-register a previously failed replica whose host recovered
        (chaos 'recover' + operator revive). The engine restarts EMPTY —
        ``reset()`` drops whatever the dead process held; its ledgered
        work was already replayed on survivors at failure time — and
        keeps its compiled steps warm. With a circuit breaker armed, the
        replica re-enters HALF_OPEN after the cooldown: dispatch ramps
        through bounded probes instead of re-flooding it (the breaker
        keys on the instance NAME, which revive preserves)."""
        if inst in self.failed:
            self.failed.remove(inst)
        inst.failed = False
        inst._progress_sig = None
        inst.last_progress_t = now
        inst.engine.reset()
        if self.edf:
            inst.engine.edf_backlog = True
        self.router.register(inst)
        self.instances.append(inst)
        inst.sync()
        return inst

    def _retry(self, req: Request, now: float):
        """Re-submit a harvested request to the survivors, within its
        retry budget. ``reset_for_retry`` rewinds the request to its
        original submission state (un-folding any preemption fold), so
        the survivor replays it from scratch — and seeded sampling keyed
        on (seed, absolute position) makes the replayed stream
        bit-identical to the one the dead replica was producing."""
        if req.retries >= self.max_retries:
            self.metrics.failed += 1
            self._resolve(req, now, RequestState.FAILED,
                          f"retry budget exhausted ({self.max_retries})")
            return
        req.retries += 1
        self.metrics.retried += 1
        req.reset_for_retry()  # leaves req.trace alone: history survives
        if req.trace is not None:
            req.trace.close_all(now)
            req.trace.event("failover_retry", now, retries=req.retries)
            req.trace.begin("queued", now)
        if self.retry_backoff_s > 0:
            delay = min(self.retry_backoff_s * (2 ** (req.retries - 1)),
                        8 * self.retry_backoff_s)
            heapq.heappush(self._held_retries,
                           (now + delay, next(self._seq), req))
        else:
            self._enqueue(req)

    def _observe(self, inst: EngineInstance, req: Request):
        """Close the loop: predicted vs observed wait (TTFT) and completion
        latency, measured from dispatch, feed the instance's residual."""
        if req.state is not RequestState.FINISHED:
            return  # aborted/rejected requests carry no latency signal
        t0 = getattr(req, "_dispatch_t", None)
        if t0 is None:
            return
        if req.prefill_done >= 0 and getattr(req, "_pred_wait_s", 0) > 0:
            inst.corrector.observe_latency(req._pred_wait_s,
                                           req.prefill_done - t0)
        if req.finish_time >= 0 and getattr(req, "_pred_complete_s", 0) > 0:
            inst.corrector.observe_latency(req._pred_complete_s,
                                           req.finish_time - t0)

    def drain(self, now: float) -> List[Request]:
        """Flush every replica's deferred tokens (end-of-run bookkeeping),
        plus any frontend-resolved requests not yet surfaced."""
        out: List[Request] = list(self._resolved)
        self._resolved = []
        for inst in self.instances + self.draining:
            ledger = self._outstanding.get(inst.name, {})
            for req in inst.engine.drain(now):
                ledger.pop(req.rid, None)
                out.append(req)
        return out

    # -- autoscaling -------------------------------------------------------
    def autoscale(self, now: float, *, spawn=None, model: str = DEFAULT_POOL,
                  high_s: float = 1.0, low_s: float = 0.05):
        """One autoscaling decision from queue pressure: pressure above
        ``high_s`` spawns a replica (via the ``spawn`` callback — building
        a ServingEngine is the caller's business), pressure below ``low_s``
        retires the least-loaded replica (it drains, then drops). Returns
        the instance added or retired, else None. ``sync`` during ``step``
        keeps ``router.pressure`` fed with live backlog telemetry."""
        sig = self.router.want_scale(model, high_s=high_s, low_s=low_s)
        if sig > 0 and spawn is not None:
            return self.add_engine(spawn(), model=model)
        if sig < 0:
            pool = self.router.pools.get(model, [])
            if len(pool) > 1:
                victim = min(pool, key=lambda i: (i.queue_s, i.order))
                return self.retire(victim)
        return None

    # -- rollups -----------------------------------------------------------
    def merged_metrics(self) -> ServeMetrics:
        """Cluster-wide ServeMetrics: every replica's counters summed —
        including replicas retired (reaped) or failed along the way —
        plus the frontend's own lifecycle counters (rejections, retries,
        failovers, frontend-queue aborts)."""
        m = ServeMetrics()
        m.merge(self.metrics)
        for inst in (self.instances + self.draining + self.retired
                     + self.failed):
            m.merge(inst.engine.metrics)
        return m

    def metrics_registry(self) -> MetricsRegistry:
        """Cluster-wide exposition: the merged ServeMetrics plus engine-
        level rollups — compile events and span totals summed across every
        replica (dead ones included), step-wall histograms exactly merged,
        and each live replica's closed-loop residual state."""
        reg = self.merged_metrics().registry(prefix="cluster_")
        compile_events: Dict[str, int] = {}
        span_totals: Dict[str, list] = {}
        tick_wall = latency_histogram()
        for inst in (self.instances + self.draining + self.retired
                     + self.failed):
            eng = inst.engine
            for k, n in eng.compile_events.items():
                compile_events[k] = compile_events.get(k, 0) + n
            for k, (c, s) in eng.tracer.span_totals.items():
                cur = span_totals.setdefault(k, [0, 0.0])
                cur[0] += c
                cur[1] += s
            tick_wall.merge(eng._tick_wall)
        for k, n in sorted(compile_events.items()):
            reg.set_counter(f"cluster_compile_events_total{{key=\"{k}\"}}", n)
        for k, (c, s) in sorted(span_totals.items()):
            reg.set_counter(f"cluster_span_count_total{{kind=\"{k}\"}}", c)
            reg.set_gauge(f"cluster_span_seconds{{kind=\"{k}\"}}", s)
        if tick_wall.count:
            reg.register("cluster_step_wall_seconds", tick_wall)
        for inst in self.instances:
            reg.set_gauge(
                f"cluster_residual_correction{{replica=\"{inst.name}\"}}",
                inst.corrector.correction)
            reg.register(
                f"cluster_residuals{{replica=\"{inst.name}\"}}",
                inst.corrector.residuals)
        return reg

    def utilization(self) -> Dict[str, float]:
        return {i.name: i.utilization
                for i in (self.instances + self.draining + self.retired
                          + self.failed)}

    @property
    def idle(self) -> bool:
        return (not self._queue and not self._held_retries
                and all(i.engine.idle
                        for i in self.instances + self.draining))
