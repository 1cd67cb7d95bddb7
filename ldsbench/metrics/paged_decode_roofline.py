"""Kernels layer: the paged-decode kernel's share of its roofline over
the profiled sub-window: the least time its launches could take (per
launch, one layer of one tick: every valid K and V byte of each live
slot read once, q read and o written once, over the memory bandwidth,
or the operations over the bf16 peak where that is larger), over the
device time the profiler gives its launches. Nothing to read without a
decode tick in the sub-window; decode ticks without the kernel's
launches are an error, not a silent gap."""
from ldsbench.peaks import bound_s

KERNEL = "twin_kernel"


def read(run):
    if run.trace is None or not run.trace_kv:
        return None
    spent = run.trace.seconds(KERNEL)
    if spent <= 0:
        raise RuntimeError(f"decode ticks ran in the profiled sub-window but "
                           f"no {KERNEL!r} launch did: the paged-decode "
                           f"kernel's name changed")
    least = sum(bound_s(*run.family.paged_decode_cost(run.arch, kv))
                for kv in run.trace_kv) * run.arch["num_layers"]
    return 100.0 * least / spent
