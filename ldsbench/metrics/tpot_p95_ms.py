"""95th percentile over requests of the time per output token after
the first, in ms (host clock)."""
from ldsbench.metrics._common import tpots
from ldsbench.stats import percentile


def read(run):
    p = percentile(tpots(run), 95)
    return None if p is None else p * 1e3
