"""Engine layer: the share of the engine's delivery periods (host clock,
from the end of one delivery sync to the end of the next; an idle
engine's period opens at its next call) in which no step of the engine
runs on the device (the steps' CUDA-event seconds, all kinds), over the
window (before the profiled sub-window: ``_timeline``): the time the
host holds the device back. An eager step's events span the device's
waits for the host's launches too, so its host pacing counts as device
time here."""
from ldsbench.metrics._timeline import on_device


def read(run):
    ps = on_device(run)
    wall = sum(p.wall_s or 0.0 for p in ps)
    if wall <= 0:
        return None
    busy = sum(sum(p.device_s.values()) for p in ps)
    return 100.0 * (1.0 - busy / wall)
