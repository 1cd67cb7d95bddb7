"""Model-step layer: the model operations of the window's work (the
family's count from the configuration's shapes) over the window's
seconds times the chip's bf16 peak."""
from ldsbench.metrics._common import window_flops
from ldsbench.peaks import FLOPS


def read(run):
    if not run.on_card:
        return None
    return 100.0 * window_flops(run) / (run.seconds * FLOPS["bfloat16"])
