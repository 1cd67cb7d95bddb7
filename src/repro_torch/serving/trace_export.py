"""Chrome-trace / Perfetto JSON export for request span traces (the port's
copy of the JAX package's ``serving/trace_export.py``).

Produces the Trace Event Format (the ``{"traceEvents": [...]}`` JSON
Chrome's ``about:tracing`` and https://ui.perfetto.dev load directly):
one complete event (``ph: "X"``) per closed span, instant events
(``ph: "i"``) for zero-duration markers, and metadata events naming
each process/thread.  Mapping:

- **pid** = one serving process lane per replica (requests grouped by
  ``Request.routed_to``; engine-level traces get their own lane),
- **tid** = request id, so one request's lifecycle reads as one row,
- **ts/dur** = serving-clock seconds scaled to microseconds (the trace
  format's unit) — virtual benchmark clocks export fine because the
  viewer only needs relative time.

``write_chrome_trace`` is the one-call path of ``launch/serve.py
--trace-out``.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.serving.tracing import Trace

__all__ = [
    "chrome_events",
    "chrome_trace",
    "request_traces",
    "validate_chrome_trace",
    "write_chrome_trace",
]

_US = 1e6  # trace-event timestamps are microseconds


def _san(meta: dict) -> dict:
    """JSON-safe copy of span meta (numpy scalars -> python)."""
    out = {}
    for k, v in meta.items():
        if hasattr(v, "item"):
            v = v.item()
        out[k] = v
    return out


def chrome_events(trace: Trace, *, pid: int, tid: Optional[int] = None,
                  scale: float = _US) -> List[dict]:
    """Trace-event dicts for one Trace (no metadata events)."""
    tid = trace.rid if tid is None else tid
    events = []
    for sp in trace.spans:
        t1 = sp.t1 if sp.t1 is not None else sp.t0  # open spans: render 0-len
        base = {"name": sp.kind, "cat": "serving", "pid": pid, "tid": tid,
                "ts": sp.t0 * scale}
        if t1 > sp.t0:
            base["ph"] = "X"
            base["dur"] = (t1 - sp.t0) * scale
        else:
            base["ph"] = "i"
            base["s"] = "t"  # thread-scoped instant
        if sp.meta:
            base["args"] = _san(sp.meta)
        events.append(base)
    return events


def chrome_trace(traces: Iterable[Tuple[str, Trace]], *,
                 scale: float = _US) -> dict:
    """Assemble a full Chrome-trace document from (lane-name, Trace)
    pairs.  Lane names map to pids; rids map to tids; metadata events
    label both so the viewer shows real names."""
    pids: Dict[str, int] = {}
    events: List[dict] = []
    for lane, trace in traces:
        if lane not in pids:
            pids[lane] = len(pids) + 1
            events.append({"name": "process_name", "ph": "M",
                           "pid": pids[lane], "tid": 0,
                           "args": {"name": lane}})
        pid = pids[lane]
        tid = trace.rid if trace.rid >= 0 else 0
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid,
                       "args": {"name": f"rid {trace.rid}"
                                if trace.rid >= 0 else "engine"}})
        events.extend(chrome_events(trace, pid=pid, tid=tid, scale=scale))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def request_traces(reqs, prefix: str = "") -> List[Tuple[str, Trace]]:
    """(lane, Trace) pairs for every traced request, grouped by the
    replica that served it (``routed_to``; un-routed requests land in a
    'frontend' lane)."""
    out = []
    for r in reqs:
        if getattr(r, "trace", None) is None:
            continue
        lane = prefix + (r.routed_to or "frontend")
        out.append((lane, r.trace))
    return out


def write_chrome_trace(path: str, traces: Iterable[Tuple[str, Trace]], *,
                       scale: float = _US) -> dict:
    doc = chrome_trace(traces, scale=scale)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def validate_chrome_trace(doc: dict) -> List[str]:
    """Structural problems with an exported trace document (empty = ok)."""
    problems = []
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents missing or empty"]
    for i, ev in enumerate(events):
        for key in ("name", "ph", "pid", "tid"):
            if key not in ev:
                problems.append(f"event[{i}] missing {key!r}")
                break
        else:
            if ev["ph"] == "X" and ("ts" not in ev or "dur" not in ev):
                problems.append(f"event[{i}] complete event without ts/dur")
            elif ev["ph"] == "X" and ev["dur"] < 0:
                problems.append(f"event[{i}] negative duration")
    return problems
