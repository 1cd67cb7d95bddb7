"""Seconds from process start to the window's first request: kernels
loaded (built on a checkout's first run), weights made, engine built,
its shapes warmed and the traffic's own set-up done (host clock)."""


def read(run):
    return run.setup_s
