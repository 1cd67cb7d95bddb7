"""Inter-tenant interference model (survey §3.2.1, Fig. 3); the port's
copy of the JAX package's ``core/misd/interference.py``.

Co-located jobs on one device (or meshlet) contend for compute units and
memory bandwidth. Each job carries a demand vector (c_i, m_i) from the cost
model. A proportional-share model gives each job a progress rate:

    C = sum_i c_i          (aggregate compute demand)
    M = sum_i m_i          (aggregate bandwidth demand)
    rate_i = 1 / max(1, C, M)

so a compute-bound job pairs with a memory-bound job nearly for free
(max(C, M) ~ 1: the survey's "perfectly interleaving compute-intensive and
memory-intensive queries"), while two same-class jobs halve each other.
An extra ``cross_penalty`` models imperfect overlap (cache thrash, operator
concurrency limits) — calibrated so bi-model co-location shows the 5–17%
degradation band of Fig. 3.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

CROSS_PENALTY = 0.07  # fractional slowdown per co-tenant beyond the first


def progress_rates(demands: Sequence[Tuple[float, float]],
                   cross_penalty: float = CROSS_PENALTY) -> List[float]:
    """Progress rate in (0, 1] for each co-located job."""
    if not demands:
        return []
    agg_c = sum(d[0] for d in demands)
    agg_m = sum(d[1] for d in demands)
    base = max(1.0, agg_c, agg_m)
    overhead = 1.0 + cross_penalty * (len(demands) - 1)
    return [1.0 / (base * overhead) for _ in demands]


def pairwise_degradation(d1: Tuple[float, float],
                         d2: Tuple[float, float]) -> float:
    """Latency inflation factor for job1 when co-run with job2 (>= 1)."""
    r = progress_rates([d1, d2])[0]
    return 1.0 / r


class InterferencePredictor:
    """ML-style latency predictor ([28]): here a calibrated analytic model
    with a learned residual hook. ``observe`` accumulates (predicted,
    actual) pairs; ``predict`` applies the mean residual correction —
    the survey's online-learning feedback loop in miniature.

    The latency-domain twins (``observe_latency`` / ``corrected_latency``)
    serve the cluster frontend's predicted-completion routing: the cost
    model predicts a completion latency, the frontend observes the real
    TTFT/JCT, and the mean multiplicative residual closes the loop (rates
    are reciprocal latencies, so the same accumulator serves both views).

    Residuals live in a bounded ``repro_torch.serving.metrics.Histogram``: the
    ``correction`` mean comes from its EXACT raw-sum accumulator (bit-
    identical to a bare running mean — routing behavior is unchanged),
    while the bucket counts give the observability layer the residual
    *distribution* each replica has learned, for free.
    """

    def __init__(self):
        # lazy import: the serving package imports this module (through
        # the scheduler), so a top-level import back into it would cycle
        from repro_torch.serving.metrics import residual_histogram
        self.residuals = residual_histogram()

    # bare-accumulator views, kept for callers/tests of the old fields
    @property
    def _resid_sum(self) -> float:
        return self.residuals.sum

    @property
    def _n(self) -> int:
        return self.residuals.count

    @property
    def correction(self) -> float:
        """Mean fractional residual: positive when reality runs slower
        than predicted (rates were over-estimated)."""
        h = self.residuals
        return h.sum / h.count if h.count else 0.0

    def predict(self, demands: Sequence[Tuple[float, float]]) -> List[float]:
        rates = progress_rates(demands)
        corr = self.correction
        return [max(1e-3, r * (1.0 - corr)) for r in rates]

    def observe(self, predicted_rate: float, actual_rate: float):
        if predicted_rate > 0:
            self.residuals.observe(
                (actual_rate - predicted_rate) / predicted_rate * -1.0)

    def observe_latency(self, predicted_s: float, actual_s: float):
        """Record one (predicted, observed) latency pair (seconds).

        Outlier rejection keeps the residual a *model correction*, not a
        noise accumulator: a pair more than 32x apart (an instant first
        token on an idle engine, a host stall, mismatched clocks) is a
        different regime from model error and is dropped entirely; pairs
        within band are clamped to 4x so one tail observation nudges the
        mean instead of dominating it. Persistent in-band bias still
        converges, one clamped step per observation."""
        p = max(predicted_s, 1e-9)
        if not (p / 32.0 <= actual_s <= 32.0 * p):
            return
        a = min(max(actual_s, 0.25 * p), 4.0 * p)
        self.observe(1.0 / p, 1.0 / a)

    def corrected_latency(self, predicted_s: float) -> float:
        """Apply the learned residual to a cost-model latency estimate.
        The correction is clamped so a burst of pathological observations
        can never flip the rate negative or amplify it without bound."""
        corr = min(0.95, max(-20.0, self.correction))
        rate = (1.0 / max(predicted_s, 1e-9)) * (1.0 - corr)
        return 1.0 / max(rate, 1e-9)
