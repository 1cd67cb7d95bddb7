"""Adaptive batching under SLA (survey §3.3.2, [8][4]); the port's copy,
priced on the H100 cost model.

Batching raises device utilization (throughput) but inflates per-query
latency; the right batch size depends on the model's roofline position and
the SLA. ``adaptive_batch_size`` searches the batch dimension with the cost
model; ``BatchAccumulator`` is the runtime piece: accumulate queries until
either the target batch or the SLA-derived deadline is hit.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from repro_torch.core.costmodel import (
    estimate_decode,
    estimate_prefill,
    kv_bytes_per_token,
)


def adaptive_batch_size(cfg, *, context: int, sla_s: float,
                        kind: str = "decode", n_chips: int = 1,
                        max_batch: int = 512) -> Tuple[int, float]:
    """Largest batch whose step latency stays within the SLA budget.
    Returns (batch, latency_s). Batch 1 is returned even if it misses."""
    best, best_lat = 1, None
    b = 1
    while b <= max_batch:
        est = (estimate_decode(cfg, b, context, n_chips=n_chips)
               if kind == "decode"
               else estimate_prefill(cfg, b, context, n_chips=n_chips))
        if best_lat is None:
            best, best_lat = b, est.latency_s
        if est.latency_s <= sla_s:
            best, best_lat = b, est.latency_s
        else:
            break
        b *= 2
    return best, best_lat


@dataclass(frozen=True)
class AdmissionPlan:
    """Cost-model-derived admission policy for the serving engine: how many
    decode slots to run and how long queued requests may wait to batch up
    before being force-admitted (survey §3.3.2: batch occupancy is the
    first-order throughput knob; the deadline bounds the latency cost)."""

    slots: int
    flush_deadline_s: float
    step_latency_s: float


def plan_admission(cfg, *, context: int, sla_s: float, n_chips: int = 1,
                   max_slots: int = 256,
                   kv_hbm_budget_bytes: Optional[float] = None,
                   mean_context: Optional[int] = None,
                   kv_cache_dtype: str = "") -> AdmissionPlan:
    """Derive (slot count, admission flush deadline) from the cost model:
    slots = largest decode batch meeting the per-step SLA budget; deadline =
    SLA headroom left after one decode step (floored at 10% of the SLA so a
    mis-modeled step cannot zero the accumulation window).

    ``kv_hbm_budget_bytes`` additionally caps slots by KV memory:
    each slot reserves ``mean_context`` cached tokens (a paged cache's
    *expected* resident length; a rolling cache pays the full ``context``
    window, so pass mean_context=context for it). Defaults to ``context``
    when unset — the conservative rolling-cache bound.

    ``kv_cache_dtype`` is the dtype THIS pool actually stores ("" = model
    dtype, "int8" = quantized pages) — the per-token byte cost is a
    per-pool property, not a global constant, and a mismatched estimate
    over-admits (``kv_bytes_per_token`` asserts on unknown dtypes)."""
    slots, lat = adaptive_batch_size(
        cfg, context=context, sla_s=sla_s, kind="decode", n_chips=n_chips,
        max_batch=max_slots)
    if kv_hbm_budget_bytes:
        per_tok = kv_bytes_per_token(cfg, kv_cache_dtype)
        resident = max(1, mean_context or context)
        if per_tok > 0:
            slots = min(slots, max(1, int(kv_hbm_budget_bytes
                                          // (per_tok * resident))))
    lat = lat or 0.0
    deadline = max(sla_s - lat, 0.1 * sla_s)
    return AdmissionPlan(slots=slots, flush_deadline_s=deadline,
                         step_latency_s=lat)


@dataclass
class BatchAccumulator:
    """Deadline-bounded query accumulator."""

    target_batch: int
    deadline_s: float
    pending: List = field(default_factory=list)
    window_open: float = -1.0

    def add(self, query, now: float) -> Optional[List]:
        if not self.pending:
            self.window_open = now
        self.pending.append(query)
        if len(self.pending) >= self.target_batch:
            return self.flush()
        return None

    def poll(self, now: float) -> Optional[List]:
        if self.pending and now - self.window_open >= self.deadline_s:
            return self.flush()
        return None

    def flush(self) -> List:
        out, self.pending = self.pending, []
        return out
