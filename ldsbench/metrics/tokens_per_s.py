"""Output tokens delivered to the host inside the window, per second of
the window (host clock)."""
from ldsbench.metrics._common import tokens_in_window


def read(run):
    return tokens_in_window(run) / run.seconds
