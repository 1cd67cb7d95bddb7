"""Engine layer: 95th percentile of the wait from a request's due or
send time to the end of the engine's ``queued`` span (its admission),
in ms. Needs the engine's span tracing (the traced run). The profiler
slows the engine while it records, which backs an open loop up behind
its sub-window, so a profiled run reads the requests admitted before the
sub-window opened."""
from ldsbench.stats import percentile


def read(run):
    end = run.profiled_at if run.profiled_at is not None else float("inf")
    waits = [r.queue_end - r.due for r in run.recs
             if r.queue_end is not None and r.sent >= run.t0
             and r.queue_end < end]
    p = percentile(waits, 95)
    return None if p is None else p * 1e3
