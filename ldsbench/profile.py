"""Reduction of a ``torch.profiler`` trace of the traced sub-window to the
numbers the per-layer metrics read: each device activity's interval, the
busy time (the union of intervals), the longest idle gaps labelled by the
host span ("ldsbench:" annotations) that was open across them, and the
device time by kernel name."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

LABEL = "ldsbench:"
WINDOW = LABEL + "window"
NOT_KERNELS = ("Memcpy", "Memset")


@dataclass
class Reduced:
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, int, int]]  # (name, start ns, duration ns)
    by_name: dict = field(default_factory=dict)  # name -> seconds
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def seconds(self, needle: str) -> float:
        return sum(d for n, _, d in self.kernels if needle in n) * 1e-9


def union(intervals, lo: int, hi: int):
    """Merged [start, end) intervals clipped to [lo, hi), in order."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(device_events, host_spans, lo: int, hi: int, top: int = 10):
    """device_events: (name, start ns, duration ns) of every device
    activity; host_spans: (label, start ns, end ns); [lo, hi) the
    window in the same clock. Idle gaps are summed by the innermost host
    span open at each gap's middle (the harness itself where none
    is)."""
    acts = [(n, s, d) for n, s, d in device_events if s < hi and s + d > lo]
    busy = union([(s, s + d) for _, s, d in acts], lo, hi)
    busy_ns = sum(e - s for s, e in busy)
    kernels = [a for a in acts if not a[0].startswith(NOT_KERNELS)]
    by_name = {}
    for n, _, d in acts:
        by_name[n] = by_name.get(n, 0.0) + d * 1e-9
    gaps, prev = [], lo
    for s, e in busy + [[hi, hi]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    spans = sorted(host_spans, key=lambda t: t[2] - t[1])
    idle = {}
    for s, e in gaps:
        mid = (s + e) // 2
        label = next((lab for lab, a, b in spans if a <= mid < b),
                     "harness, between engine calls")
        idle[label] = idle.get(label, 0.0) + (e - s) * 1e-9
    return Reduced(window_s=(hi - lo) * 1e-9, busy_s=busy_ns * 1e-9,
                   kernels=kernels, by_name=by_name,
                   idle_gaps=sorted(idle.items(), key=lambda kv: -kv[1])[:top])


def from_profiler(prof) -> Reduced:
    """Read a finished ``torch.profiler.profile``: its device activities
    and its "ldsbench:" host annotations, in the profiler's clock; the
    window is the "ldsbench:window" annotation's extent."""
    dev, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        kind = str(e.device_type())
        if kind.endswith("CUDA"):
            # a host annotation's shadow on the device is not device work
            if not e.name().startswith(LABEL):
                dev.append((e.name(), e.start_ns(), e.duration_ns()))
        elif e.name() == WINDOW:
            window = (e.start_ns(), e.start_ns() + e.duration_ns())
        elif e.name().startswith(LABEL):
            host.append((e.name()[len(LABEL):], e.start_ns(),
                         e.start_ns() + e.duration_ns()))
    if window is None:
        raise RuntimeError("the profile holds no ldsbench:window span")
    return reduce(dev, host, *window)


def breakdown(red: Reduced, top: int = 10) -> dict:
    ops = sorted(red.by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in red.idle_gaps[:top]]}
