"""What the step-timeline readers share: the ``timing`` records that the
engine's step timeline puts on its request spans
(``repro_torch/serving/tracing.py``; the traced run, where the engine
traces). A delivery period is read once, by its ``serial`` (every
request its sync delivered to shares the record), when its
``decode_window`` span ends inside the window; a prefill is read from
the first ``prefill`` span of each request whose first token came inside
the window. A profiled run reads only the spans that end before its
sub-window opens, as ``queue_wait_ms_p95`` does: the profiler's start
stalls the loop, its stop backs the open loop up, and after it the
host's time inside each step stays many times higher for the rest of
the process. A program without the timeline gives nothing to read: the
readers return None."""


def _read(run, t) -> bool:
    """Whether a span ending at ``t`` is read."""
    return (t is not None and run.t0 <= t <= run.t1
            and (run.profiled_at is None or t < run.profiled_at))


def periods(run) -> list:
    """The window's delivery periods (``Timing`` records), each once."""
    out = {}
    for rec in run.recs:
        trace = getattr(rec.req, "trace", None)
        for sp in (trace.spans if trace is not None else ()):
            timing = getattr(sp, "timing", None)
            if (timing is not None and sp.kind == "decode_window"
                    and _read(run, sp.t1)):
                out.setdefault(timing.serial, timing)
    return list(out.values())


def prefills(run) -> list:
    """The ``Timing`` records of the window's prefills."""
    out = []
    for rec in run.recs:
        trace = getattr(rec.req, "trace", None)
        if (trace is None or rec.first is None
                or not run.t0 <= rec.first <= run.t1):
            continue
        sp = next((s for s in trace.spans if s.kind == "prefill"), None)
        timing = getattr(sp, "timing", None)
        if timing is not None and _read(run, sp.t1):
            out.append(timing)
    return out


def on_device(run) -> list:
    """The window's delivery periods that carry device seconds (the
    engine on one card)."""
    return [p for p in periods(run) if p.device_s is not None]
