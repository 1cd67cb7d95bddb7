"""95th percentile of the time to first token, in ms (host clock)."""
from ldsbench.metrics._common import ttfts
from ldsbench.stats import percentile


def read(run):
    p = percentile(ttfts(run), 95)
    return None if p is None else p * 1e3
