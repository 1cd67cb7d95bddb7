"""Model-step layer: device kernels in the profiled sub-window per
decode tick run in it."""


def read(run):
    if run.trace is None or not run.trace_ticks:
        return None
    return len(run.trace.kernels) / run.trace_ticks
