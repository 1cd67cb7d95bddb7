"""Model-step layer: device milliseconds of the decode steps (single
ticks and fused windows, from the CUDA events the engine's step timeline
records around each) per decode tick, over the window's delivery
periods (before the profiled sub-window: ``_timeline``)."""
from ldsbench.metrics._timeline import on_device


def read(run):
    ps = on_device(run)
    ticks = sum(p.ticks for p in ps)
    if not ticks:
        return None
    return 1e3 * sum(p.device_s.get("decode", 0.0) for p in ps) / ticks
