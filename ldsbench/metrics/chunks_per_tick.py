"""Engine layer: prefill chunks run per decode tick over the window
(``ServeMetrics.prefill_chunks`` / ``decode_ticks``)."""


def read(run):
    ticks = run.delta("decode_ticks")
    return run.delta("prefill_chunks") / ticks if ticks else None
