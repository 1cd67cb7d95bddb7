"""Engine layer: 95th percentile over the window's prefills (requests
whose first token came inside the window; before the profiled
sub-window: ``_timeline``) of the host milliseconds spent inside their
prefill steps (the ``prefill`` span's ``launch_s``: a bucket, suffix or
exact step, or every chunk, seed and insert step; waits at host syncs
excluded)."""
from ldsbench.metrics._timeline import prefills
from ldsbench.stats import percentile


def read(run):
    p = percentile([t.launch_s for t in prefills(run)], 95)
    return None if p is None else p * 1e3
