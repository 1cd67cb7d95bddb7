"""Engine layer: blocking host syncs (every named site of the engine's
step timeline: the delivery syncs, the first tokens, the host-to-card
copies of the steps' inputs, the sampling and slot writes) per decode
tick, over the window's delivery periods (before the profiled
sub-window: ``_timeline``)."""
from ldsbench.metrics._timeline import periods


def read(run):
    ps = periods(run)
    ticks = sum(p.ticks for p in ps)
    if not ticks:
        return None
    return sum(sum(p.syncs.values()) for p in ps) / ticks
