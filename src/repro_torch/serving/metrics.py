"""Bounded serving metrics: counters, gauges, fixed-bucket histograms.

The survey frames serving as a closed loop between measurement and
scheduling: SLO attainment and tail latency can only be optimized if the
system can *see* them, cheaply, forever.  Python lists of per-request
latencies (the pre-observability `ServeMetrics`) grow without bound and
cannot be merged across replicas without shipping every sample.  This
module replaces them with fixed-bucket histograms:

- **Bounded**: memory is O(buckets), independent of request count.
- **Exactly mergeable**: two histograms over the same bounds merge by
  elementwise count addition plus exact sum/count/min/max accumulators —
  ``merge(a, b)`` equals the histogram of the concatenated samples,
  bucket-for-bucket, which is what lets a cluster frontend aggregate
  replica reports without bias.
- **Quantile-accurate to one bucket width**: ``percentile(q)`` walks the
  cumulative counts and linearly interpolates inside the target bucket,
  so the answer is always within the containing bucket's bounds.

Buckets are *fixed at construction* (no rebinning): log-spaced for
latencies (constant relative error), linear for residuals.  Named
presets in ``BUCKET_PRESETS`` keep the ``LoadReport`` wire form small —
a histogram serializes as ``(preset-or-bounds, nonzero (idx, count)
pairs, sum, count, min, max)`` rather than the full bucket vector.

``MetricsRegistry`` is the exposition layer: named counters / gauges /
histograms rendered either as Prometheus-style text (cumulative
``_bucket{le=...}`` lines) or a JSON snapshot, behind
``launch/serve.py --metrics-out``.
"""
from __future__ import annotations

import math
from bisect import bisect_left
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "BUCKET_PRESETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "latency_histogram",
    "residual_histogram",
]


def _log_bounds(lo: float, hi: float, per_decade: int) -> Tuple[float, ...]:
    """Increasing log-spaced bucket upper bounds covering [lo, hi]."""
    n = int(round(math.log10(hi / lo) * per_decade))
    return tuple(lo * 10.0 ** (i / per_decade) for i in range(n + 1))


def _linear_bounds(lo: float, hi: float, n: int) -> Tuple[float, ...]:
    """n+1 evenly spaced bucket upper bounds from lo to hi inclusive."""
    step = (hi - lo) / n
    return tuple(lo + i * step for i in range(n + 1))


# Latencies (TTFT / TPOT / JCT / tick wall): virtual-time benches emit
# values from sub-millisecond ticks up to multi-thousand-second JCTs on
# slow virtual clocks; 8 buckets per decade bounds quantile error at
# ~33% relative (one bucket width), plenty for p50/p99 gating.
LATENCY_BOUNDS = _log_bounds(1e-5, 1e4, per_decade=8)

# Interference-predictor residuals: observe_latency clamps actuals to
# [0.25p, 4p], so residuals -(a-p)/p live in [-3, 0.75]; a linear grid
# over [-4, 1] covers them with uniform resolution.
RESIDUAL_BOUNDS = _linear_bounds(-4.0, 1.0, 100)

# Wire-form presets: histograms built from a preset serialize by NAME,
# not by shipping ~80 bound floats per LoadReport (load_report() runs on
# every routing dispatch).
BUCKET_PRESETS: Dict[str, Tuple[float, ...]] = {
    "latency_s": LATENCY_BOUNDS,
    "residual": RESIDUAL_BOUNDS,
}


class Histogram:
    """Fixed-bucket histogram with exact sum/count/min/max side state.

    ``bounds`` are increasing bucket *upper* bounds; an implicit +inf
    overflow bucket catches everything above ``bounds[-1]``, so
    ``counts`` has ``len(bounds) + 1`` entries.  Bucket i holds values
    ``v <= bounds[i]`` (first bucket also absorbs anything below the
    range).  ``sum`` accumulates raw values, so ``mean`` is exact even
    though individual samples are binned.
    """

    __slots__ = ("bounds", "counts", "sum", "count", "vmin", "vmax", "preset")

    def __init__(self, bounds: Sequence[float], preset: Optional[str] = None):
        bounds = tuple(float(b) for b in bounds)
        if not bounds or any(b <= a for a, b in zip(bounds, bounds[1:])):
            raise ValueError("histogram bounds must be non-empty and increasing")
        self.bounds = bounds
        self.counts: List[int] = [0] * (len(bounds) + 1)
        self.sum = 0.0
        self.count = 0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.preset = preset

    # -- recording ---------------------------------------------------------

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    # list-compat shims: ServeMetrics call sites did latencies.append(x)
    append = observe

    def extend(self, vs: Iterable[float]) -> None:
        for v in vs:
            self.observe(v)

    def bucket_index(self, v: float) -> int:
        return bisect_left(self.bounds, float(v))

    # -- reading -----------------------------------------------------------

    def __len__(self) -> int:  # `if not hist:` == empty, like the old lists
        return self.count

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """q in [0, 1]; linear interpolation inside the target bucket.

        Matches ``np.percentile``'s rank convention (h = q*(n-1)) at the
        bucket level, so the result is within one bucket width of the
        exact sample quantile.
        """
        if self.count == 0:
            return 0.0
        if q <= 0.0 or self.count == 1:
            return self.vmin
        if q >= 1.0:
            return self.vmax
        rank = q * (self.count - 1)
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c > rank:
                lo = self.bounds[i - 1] if i > 0 else self.vmin
                hi = self.bounds[i] if i < len(self.bounds) else self.vmax
                lo = max(lo, self.vmin)
                hi = min(hi, self.vmax)
                if hi <= lo:
                    return lo
                return lo + (hi - lo) * min(1.0, (rank - cum) / c)
            cum += c
        return self.vmax  # unreachable unless counts were mutated externally

    def percentile(self, q: float) -> float:
        """q in [0, 100] — np.percentile-shaped front door."""
        return self.quantile(q / 100.0)

    # -- merging -----------------------------------------------------------

    def merge(self, other: "Histogram") -> "Histogram":
        """Exact in-place merge; equals histogramming the concatenation."""
        if self.bounds != other.bounds:
            raise ValueError(
                f"cannot merge histograms with different bounds "
                f"({len(self.bounds)} vs {len(other.bounds)} buckets; "
                f"presets {self.preset!r} vs {other.preset!r})")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.sum += other.sum
        self.count += other.count
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        return self

    def delta(self, prev: "Histogram") -> "Histogram":
        """Windowed view: the histogram of samples observed since ``prev``
        (a past snapshot of this same series). Counts and sum subtract
        exactly; min/max are NOT recoverable from cumulative state, so
        the window's vmin/vmax are approximated by its populated bucket
        bounds — quantiles stay within one bucket width, same guarantee
        as everywhere else. Used by the overload detector to get a recent
        p99 out of cumulative LoadReport histograms."""
        if self.bounds != prev.bounds:
            raise ValueError("delta requires identical bucket bounds")
        h = Histogram(self.bounds, preset=self.preset)
        for i, (a, b) in enumerate(zip(self.counts, prev.counts)):
            if a < b:
                raise ValueError(
                    f"bucket {i} went backwards ({b} -> {a}); delta needs "
                    f"snapshots of one monotonically growing histogram")
            h.counts[i] = a - b
        h.sum = self.sum - prev.sum
        h.count = self.count - prev.count
        if h.count:
            nz = [i for i, c in enumerate(h.counts) if c]
            lo = self.bounds[nz[0] - 1] if nz[0] > 0 else self.vmin
            hi = (self.bounds[nz[-1]] if nz[-1] < len(self.bounds)
                  else self.vmax)
            h.vmin, h.vmax = min(lo, hi), max(lo, hi)
        return h

    def copy(self) -> "Histogram":
        h = Histogram(self.bounds, preset=self.preset)
        h.counts = list(self.counts)
        h.sum, h.count = self.sum, self.count
        h.vmin, h.vmax = self.vmin, self.vmax
        return h

    # -- wire form ---------------------------------------------------------

    def to_wire(self) -> tuple:
        """Sparse, hashable, JSON-round-trippable tuple form.

        ``(preset-name-or-bounds, ((bucket, count), ...), sum, count,
        min, max)`` — empty histograms ship min/max as 0.0 so plain JSON
        readers never see Infinity.
        """
        key = self.preset if self.preset is not None else self.bounds
        nz = tuple((i, c) for i, c in enumerate(self.counts) if c)
        vmin = self.vmin if self.count else 0.0
        vmax = self.vmax if self.count else 0.0
        return (key, nz, self.sum, self.count, vmin, vmax)

    @classmethod
    def from_wire(cls, w: Sequence) -> "Histogram":
        key, nz, s, n, vmin, vmax = w
        if isinstance(key, str):
            h = cls(BUCKET_PRESETS[key], preset=key)
        else:
            h = cls(key)
        for i, c in nz:
            h.counts[int(i)] = int(c)
        h.sum, h.count = float(s), int(n)
        if h.count:
            h.vmin, h.vmax = float(vmin), float(vmax)
        return h

    def __eq__(self, other) -> bool:
        if not isinstance(other, Histogram):
            return NotImplemented
        return (self.bounds == other.bounds and self.counts == other.counts
                and self.sum == other.sum and self.count == other.count
                and self.vmin == other.vmin and self.vmax == other.vmax)

    def __repr__(self) -> str:
        return (f"Histogram(count={self.count}, mean={self.mean:.4g}, "
                f"buckets={len(self.counts)}, preset={self.preset!r})")


def latency_histogram() -> Histogram:
    """The shared latency preset (TTFT / TPOT / JCT / tick wall)."""
    return Histogram(LATENCY_BOUNDS, preset="latency_s")


def residual_histogram() -> Histogram:
    """Interference-predictor residual preset."""
    return Histogram(RESIDUAL_BOUNDS, preset="residual")


class Counter:
    """Monotonic counter."""

    __slots__ = ("value",)

    def __init__(self, value: float = 0):
        self.value = value

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        self.value += n


class Gauge:
    """Point-in-time value."""

    __slots__ = ("value",)

    def __init__(self, value: float = 0.0):
        self.value = value

    def set(self, v: float) -> None:
        self.value = v


class MetricsRegistry:
    """Named metrics with Prometheus-style text + JSON exposition.

    Registration order is preserved in both outputs so expositions diff
    cleanly across runs.
    """

    def __init__(self):
        self._metrics: Dict[str, tuple] = {}  # name -> (kind, help, obj)

    def _add(self, name: str, kind: str, obj, help_: str):
        if name in self._metrics:
            existing = self._metrics[name]
            if existing[0] != kind:
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{existing[0]}, not {kind}")
            return existing[2]
        self._metrics[name] = (kind, help_, obj)
        return obj

    def counter(self, name: str, help: str = "") -> Counter:
        return self._add(name, "counter", Counter(), help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._add(name, "gauge", Gauge(), help)

    def histogram(self, name: str, bounds: Sequence[float] = LATENCY_BOUNDS,
                  help: str = "", preset: Optional[str] = "latency_s",
                  ) -> Histogram:
        return self._add(name, "histogram", Histogram(bounds, preset=preset),
                         help)

    def register(self, name: str, obj, help: str = ""):
        """Adopt an externally owned metric (e.g. a ServeMetrics histogram)."""
        kind = ("histogram" if isinstance(obj, Histogram)
                else "gauge" if isinstance(obj, Gauge) else "counter")
        return self._add(name, kind, obj, help)

    def set_counter(self, name: str, value: float, help: str = "") -> None:
        self.counter(name, help).value = value

    def set_gauge(self, name: str, value: float, help: str = "") -> None:
        self.gauge(name, help).set(value)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def get(self, name: str, default=None):
        entry = self._metrics.get(name)
        return entry[2] if entry is not None else default

    # -- exposition --------------------------------------------------------

    def exposition(self) -> str:
        """Prometheus text format (cumulative le= histogram buckets)."""
        lines: List[str] = []
        for name, (kind, help_, obj) in self._metrics.items():
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {kind}")
            if kind in ("counter", "gauge"):
                lines.append(f"{name} {_fmt(obj.value)}")
                continue
            cum = 0
            for i, c in enumerate(obj.counts):
                cum += c
                le = (_fmt(obj.bounds[i]) if i < len(obj.bounds) else "+Inf")
                lines.append(f'{name}_bucket{{le="{le}"}} {cum}')
            lines.append(f"{name}_sum {_fmt(obj.sum)}")
            lines.append(f"{name}_count {obj.count}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-safe dict: scalars verbatim, histograms in wire form plus
        convenience quantiles."""
        out = {}
        for name, (kind, _help, obj) in self._metrics.items():
            if kind in ("counter", "gauge"):
                out[name] = obj.value
            else:
                out[name] = {
                    "wire": _listify(obj.to_wire()),
                    "count": obj.count,
                    "mean": obj.mean,
                    "p50": obj.percentile(50),
                    "p90": obj.percentile(90),
                    "p99": obj.percentile(99),
                }
        return out


def _fmt(v: float) -> str:
    """Render ints without a trailing .0 (Prometheus-conventional)."""
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _listify(x):
    if isinstance(x, tuple):
        return [_listify(v) for v in x]
    return x
