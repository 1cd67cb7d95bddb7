"""Percentile, rate and window arithmetic on synthetic stamps, and the
trace reduction on synthetic device events."""
import statistics

import numpy as np
import pytest

from ldsbench import profile, stats
from ldsbench.harness import Rec, Run
from ldsbench.metrics import (
    _common,
    device_idle_pct,
    queue_wait_ms_p95,
    tokens_per_s,
    tpot_p95_ms,
    ttft_p95_ms,
)


def test_percentile_matches_numpy():
    rng = np.random.default_rng(0)
    xs = list(rng.exponential(size=257))
    for q in (0, 50, 95, 99, 100):
        assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))
    assert stats.percentile([], 95) is None


def test_spread_uses_statistics_quartiles():
    xs = [10.0, 11.0, 9.0, 10.5, 9.5, 12.0]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / med)


def make_run(loop="open", stall=0.0, n=200):
    """n requests due every 0.1 s in a 20 s window, first token 0.05 s
    after the due time, then a token every 0.02 s for 9 more; a stall
    delays the first tokens of requests 100 to 119."""
    recs = []
    for i in range(n):
        due = 0.1 * i
        first = due + 0.05 + (stall if 100 <= i < 120 else 0.0)
        r = Rec(i, np.zeros(50, np.int32), True, due, due)
        r.first, r.last, r.n_out = first, first + 9 * 0.02, 10
        r.n_win, r.last_win = 10, r.last
        recs.append(r)
    return Run(20.0, 1.0, {}, None, recs, 0.0, 20.0, loop, {}, {})


def test_ttft_and_tpot_from_stamps():
    run = make_run()
    assert ttft_p95_ms.read(run) == pytest.approx(50.0)
    assert tpot_p95_ms.read(run) == pytest.approx(20.0)
    assert tokens_per_s.read(run) == pytest.approx(200 * 10 / 20.0)


def test_a_planted_stall_moves_the_p95():
    calm, stalled = make_run(), make_run(stall=0.5)
    assert ttft_p95_ms.read(stalled) > ttft_p95_ms.read(calm) + 400
    # a stall that hits fewer than 5% of the requests stays under the p95
    few = make_run(stall=0.5)
    for r in few.recs[105:120]:
        r.first -= 0.5
    assert ttft_p95_ms.read(few) == pytest.approx(50.0)


def test_closed_loop_counts_only_the_window():
    run = make_run(loop="closed")
    late = run.recs[-1]
    late.first = 20.5  # first token after the close
    late.n_win, late.last_win = 0, None
    assert len(_common.ttfts(run)) == len(run.recs) - 1
    assert len(_common.tpots(run)) == len(run.recs) - 1


def test_queue_wait_leaves_out_the_profiled_backlog():
    """Admitted 0.03 s after the due time, except behind the profiled
    sub-window (8 s to 10 s), where the profiler's slowdown backs the
    queue up: a profiled run reads the requests admitted before it."""
    run = make_run()
    for r in run.recs:
        r.queue_end = r.due + (2.0 if 80 <= r.idx < 120 else 0.03)
    assert queue_wait_ms_p95.read(run) > 1000
    run.profiled_at = 8.0
    assert queue_wait_ms_p95.read(run) == pytest.approx(30.0)


def test_trace_union_and_idle_gaps():
    ms = 1_000_000
    dev = [("gemm", 0, 4 * ms), ("gemm", 2 * ms, 4 * ms),  # overlap: 0-6
           ("Memcpy HtoD", 7 * ms, ms), ("twin_kernel<x>", 10 * ms, 2 * ms)]
    host = [("engine.step", 6 * ms, 10 * ms), ("engine._flush", 8 * ms,
                                                10 * ms)]
    red = profile.reduce(dev, host, 0, 20 * ms)
    assert red.busy_s == pytest.approx(9e-3)
    assert red.window_s == pytest.approx(20e-3)
    assert red.seconds("twin_kernel") == pytest.approx(2e-3)
    assert red.seconds("gemm") == pytest.approx(8e-3)
    assert len(red.kernels) == 3  # the copy is busy time, not a kernel
    gaps = dict(red.idle_gaps)
    assert gaps["engine.step"] == pytest.approx(1e-3)  # 6-7
    assert gaps["engine._flush"] == pytest.approx(2e-3)  # 8-10
    assert gaps["harness, between engine calls"] == pytest.approx(8e-3)

    class R:
        trace = red
    assert device_idle_pct.read(R) == pytest.approx(55.0)
    bd = profile.breakdown(red)
    assert bd["device_ops"][0][0] == "gemm"
    assert len(bd["idle_gaps"]) <= 10
