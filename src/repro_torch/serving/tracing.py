"""Request span tracing: the ``Span`` and ``Trace`` types that
``request.py`` carries and the engine-level ``Tracer`` whose per-kind
rollups ``load_report`` ships (a copy of the JAX package's
``serving/tracing.py``). The engine stamps with ``tracing=True``, the
cluster frontend with its own ``tracing`` flag.

Every traced ``Request`` carries a ``Trace``: an append-only list of
typed ``Span``s stamped at phase boundaries.  The span taxonomy:

==================  ========================================================
kind                stamped at
==================  ========================================================
``queued``          frontend/engine submit -> admission (re-opened after
                    preemption and failover re-queue)
``prefill``         slot admission -> first token (meta: path=full/prefix/
                    chunked, prefix_hit tokens)
``prefill_chunk``   instant event per chunked-prefill tick
``decode``          first token -> terminal state
``decode_window``   one span per fused decode window whose host sync
                    delivered tokens to this request (meta: tokens)
``sample``          instant event when stochastic sampling is armed
``preempt``         instant event when a slot is preempted
``restore``         instant event when a preempted request re-activates
``dispatch``        instant event when the frontend routes to a replica
``failover_retry``  instant event when the frontend re-queues after a
                    replica failure
``shed``            instant event when the overload ladder drops a
                    low-tier request at dispatch (meta: level,
                    retry_after_s)
``brownout``        instant event when the ladder trims a request's
                    token budget (meta: level, max_new_tokens before/
                    after)
``rejected``/``abort``  instant terminal events for non-completion paths
``compile``         engine-level event per new compiled-step key (meta:
                    the reference's trace-cache key)
==================  ========================================================

Stamping discipline — the part that keeps tracing off the hot path:
timestamps are *host* clocks the engine already has in hand (the ``now``
argument threaded through every engine entry point), recorded only at
existing host-sync points.  Tracing never adds a device sync, and when
tracing is off a request's ``trace`` stays ``None`` so the per-token
cost is one attribute check.

``end`` is lenient (no-op if no span of that kind is open) because
requests can enter the engine through several doors (frontend submit,
direct ``try_admit`` in tests, failover re-queue) and the engine must
not need to know which spans a previous owner opened.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["Span", "Trace", "Tracer"]


@dataclass
class Span:
    kind: str
    t0: float
    t1: Optional[float] = None  # None while open
    meta: dict = field(default_factory=dict)

    @property
    def open(self) -> bool:
        return self.t1 is None

    @property
    def dur(self) -> float:
        return 0.0 if self.t1 is None else self.t1 - self.t0


class Trace:
    """Append-only span list for one request (or one engine)."""

    __slots__ = ("rid", "spans")

    def __init__(self, rid: int = -1):
        self.rid = rid
        self.spans: List[Span] = []

    def begin(self, kind: str, t: float, **meta) -> Span:
        sp = Span(kind, float(t), None, meta)
        self.spans.append(sp)
        return sp

    def end(self, kind: str, t: float, **meta) -> Optional[Span]:
        """Close the most recent open span of ``kind``; no-op if none."""
        for sp in reversed(self.spans):
            if sp.kind == kind and sp.t1 is None:
                sp.t1 = float(t)
                if meta:
                    sp.meta.update(meta)
                return sp
        return None

    def event(self, kind: str, t: float, **meta) -> Span:
        """Zero-duration (instant) span."""
        t = float(t)
        sp = Span(kind, t, t, meta)
        self.spans.append(sp)
        return sp

    def add(self, kind: str, t0: float, t1: float, **meta) -> Span:
        sp = Span(kind, float(t0), float(t1), meta)
        self.spans.append(sp)
        return sp

    def is_open(self, kind: str) -> bool:
        return any(sp.kind == kind and sp.t1 is None for sp in self.spans)

    def close_all(self, t: float) -> int:
        """Close every open span at ``t`` (terminal paths: abort/failover)."""
        n = 0
        for sp in self.spans:
            if sp.t1 is None:
                sp.t1 = float(t)
                n += 1
        return n

    def validate(self) -> List[str]:
        """Well-formedness problems for a *terminal* trace (empty = ok):
        no open spans, every span non-negative, start times monotonically
        non-decreasing in record order."""
        problems = []
        prev_t0 = None
        for i, sp in enumerate(self.spans):
            if sp.t1 is None:
                problems.append(f"span[{i}] {sp.kind} still open (t0={sp.t0})")
            elif sp.t1 < sp.t0:
                problems.append(
                    f"span[{i}] {sp.kind} negative ({sp.t0}->{sp.t1})")
            if prev_t0 is not None and sp.t0 < prev_t0:
                problems.append(
                    f"span[{i}] {sp.kind} starts at {sp.t0} before "
                    f"span[{i-1}] at {prev_t0}")
            prev_t0 = sp.t0
        return problems

    def totals(self) -> Dict[str, Tuple[int, float]]:
        """Per-kind (count, total seconds) over closed spans."""
        out: Dict[str, Tuple[int, float]] = {}
        for sp in self.spans:
            if sp.t1 is None:
                continue
            c, s = out.get(sp.kind, (0, 0.0))
            out[sp.kind] = (c + 1, s + sp.dur)
        return out

    def kinds(self) -> List[str]:
        return sorted({sp.kind for sp in self.spans})

    def __len__(self) -> int:
        return len(self.spans)

    def __repr__(self) -> str:
        return f"Trace(rid={self.rid}, spans={len(self.spans)})"


class Tracer:
    """Engine-level trace sink: an engine-scoped trace (compile/profile
    events) plus per-kind rollups folded in from terminal request traces.

    ``span_totals`` is what ``LoadReport`` v3 ships — bounded per-kind
    aggregates, not the spans themselves.  ``ring`` > 0 additionally
    retains the last N finished request traces (a bounded deque) for
    post-hoc inspection without unbounded memory growth.
    """

    __slots__ = ("enabled", "engine", "span_totals", "collected", "ring")

    def __init__(self, enabled: bool = False, ring: int = 0):
        self.enabled = enabled
        self.engine = Trace(rid=-1)  # engine-scoped events (compile, profile)
        self.span_totals: Dict[str, Tuple[int, float]] = {}
        self.collected = 0
        self.ring = deque(maxlen=ring) if ring > 0 else None

    def event(self, kind: str, t: float, **meta) -> None:
        self.engine.event(kind, t, **meta)

    def collect(self, trace: Optional[Trace]) -> None:
        """Fold a terminal request trace into the per-kind rollup."""
        if trace is None:
            return
        self.collected += 1
        for kind, (c, s) in trace.totals().items():
            c0, s0 = self.span_totals.get(kind, (0, 0.0))
            self.span_totals[kind] = (c0 + c, s0 + s)
        if self.ring is not None:
            self.ring.append(trace)

    def totals_wire(self) -> tuple:
        """Hashable, JSON-safe ((kind, count, seconds), ...) for LoadReport."""
        return tuple((k, c, s)
                     for k, (c, s) in sorted(self.span_totals.items()))
