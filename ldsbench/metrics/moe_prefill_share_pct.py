"""MoE layer: the share of the window's prefills' device time spent in
the MoE MLPs and shared experts (each layer's CUDA-event pair inside the
eager exact-length prefill, the prefill span's ``device_s["moe"]``) over
the prefills' whole device time (``device_s["prefill"]``), over the
prefills of the requests whose first token came inside the window
(before the profiled sub-window: ``_timeline``). A program that times no
MoE part gives nothing to read."""
from ldsbench.metrics._timeline import prefills


def read(run):
    ts = [t for t in prefills(run)
          if t.device_s is not None and "moe" in t.device_s]
    total = sum(t.device_s["prefill"] for t in ts)
    if total <= 0:
        return None
    return 100.0 * sum(t.device_s["moe"] for t in ts) / total
