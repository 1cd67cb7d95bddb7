"""The step-timeline readers (``metrics/_timeline.py`` and the four
metrics on it) on synthetic runs: a delivery period shared by several
requests is read once, periods outside the window or, in a profiled
run, ending at or after the sub-window's start are left out, prefills
are read from the requests whose first token came inside the window, and
a run whose spans carry no timing (a program without the timeline) reads
None."""
from types import SimpleNamespace

import numpy as np
import pytest

from ldsbench.harness import PROFILE_S, Rec, Run
from ldsbench.metrics import (
    _timeline,
    decode_device_ms_per_tick,
    host_paced_pct,
    host_syncs_per_tick,
    prefill_host_ms_p95,
)
from repro_torch.serving.tracing import Timing, Trace

KINDS = ("decode", "prefill", "aux")
READERS = (decode_device_ms_per_tick, host_paced_pct, host_syncs_per_tick,
           prefill_host_ms_p95)


def period(serial, ticks, wall, decode, prefill=0.0, syncs=None,
           device=True):
    t = Timing(serial, KINDS if device else None)
    t.ticks, t.wall_s = ticks, wall
    if device:
        t.device_s.update(decode=decode, prefill=prefill)
    t.syncs = dict(syncs or {"window": 1})
    return t


def prefill(launch):
    t = Timing(None, KINDS)
    t.launch_s = launch
    return t


def request(i, first, prefill_end, pre, windows):
    """A request whose prefill span ends at ``prefill_end`` with record
    ``pre`` and whose ``decode_window`` spans end at the given times with
    the given records."""
    tr = Trace(i)
    tr.begin("queued", 0.0)
    tr.end("queued", prefill_end - 0.1)
    sp = tr.begin("prefill", prefill_end - 0.1)
    tr.end("prefill", prefill_end)
    sp.timing = pre
    for t1, rec in windows:
        tr.add("decode_window", t1 - 0.05, t1, tokens=8).timing = rec
    rec = Rec(i, np.zeros(4, np.int32), True, 0.0, 0.0,
              req=SimpleNamespace(trace=tr))
    rec.first = first
    return rec


def make_run(recs, profiled_at=None):
    return Run(seconds=10.0, setup_s=1.0, arch={}, family=None, recs=recs,
               t0=100.0, t1=110.0, loop="closed", counters0={},
               counters1={}, profiled_at=profiled_at)


def test_a_shared_period_is_read_once():
    shared = period(1, 8, 0.2, 0.12, syncs={"window": 1, "sampling": 5})
    own = period(2, 1, 0.05, 0.01, prefill=0.02, syncs={"flush": 1})
    recs = [request(0, 101.0, 101.0, prefill(0.003), [(102.0, shared)]),
            request(1, 101.5, 101.5, prefill(0.005),
                    [(102.0, shared), (103.0, own)])]
    run = make_run(recs)
    assert sorted(p.serial for p in _timeline.periods(run)) == [1, 2]
    assert decode_device_ms_per_tick.read(run) == pytest.approx(
        1e3 * 0.13 / 9)
    assert host_paced_pct.read(run) == pytest.approx(
        100 * (1 - 0.15 / 0.25))
    assert host_syncs_per_tick.read(run) == pytest.approx(7 / 9)
    assert prefill_host_ms_p95.read(run) == pytest.approx(
        1e3 * (0.003 + 0.95 * 0.002))


def test_window_and_profiled_run_are_clipped():
    keep = period(1, 8, 0.2, 0.1)
    edge = period(5, 8, 0.2, 0.1)  # just before the sub-window opens
    before = period(2, 8, 0.2, 0.2)  # ends before the window opens
    after = period(3, 8, 0.2, 0.2)  # after it closes
    profiled = period(4, 8, 14.0, 0.01)  # the profiler's start inside
    late = period(6, 8, 0.2, 0.01)  # after the sub-window
    at = 104.0
    recs = [request(0, 99.0, 99.0, prefill(1.0),
                    [(99.5, before), (101.0, keep), (at - 0.01, edge),
                     (at + 0.5, profiled), (at + PROFILE_S + 0.5, late),
                     (110.5, after)]),
            request(1, at + 1.0, at + 1.0, prefill(2.0), []),
            request(2, 102.0, 102.0, prefill(0.004), []),
            request(3, 109.0, 109.0, prefill(0.5), []),
            request(4, 111.0, 111.0, prefill(3.0), [])]
    run = make_run(recs, profiled_at=at)
    assert sorted(p.serial for p in _timeline.periods(run)) == [1, 5]
    assert decode_device_ms_per_tick.read(run) == pytest.approx(
        1e3 * 0.2 / 16)
    assert host_paced_pct.read(run) == pytest.approx(50.0)
    assert prefill_host_ms_p95.read(run) == pytest.approx(4.0)
    # unprofiled, the whole window counts
    run = make_run(recs)
    assert sorted(p.serial for p in _timeline.periods(run)) == [1, 4, 5, 6]
    assert prefill_host_ms_p95.read(run) == pytest.approx(
        1e3 * (0.5 + 0.9 * 1.5))


def test_nothing_to_read_without_timing():
    recs = [request(0, 101.0, 101.0, None, [(102.0, None), (103.0, None)])]
    run = make_run(recs)
    assert [r.read(run) for r in READERS] == [None] * 4
    # untraced requests: no trace at all
    bare = Rec(1, np.zeros(4, np.int32), True, 0.0, 0.0,
               req=SimpleNamespace(trace=None))
    bare.first = 101.0
    assert [r.read(make_run([bare])) for r in READERS] == [None] * 4
    # a program on the CPU: syncs, no device seconds
    cpu = period(1, 4, 0.1, 0.0, device=False)
    run = make_run([request(0, 101.0, 101.0, prefill(0.002),
                            [(102.0, cpu)])])
    assert decode_device_ms_per_tick.read(run) is None
    assert host_paced_pct.read(run) is None
    assert host_syncs_per_tick.read(run) == pytest.approx(0.25)
    assert prefill_host_ms_p95.read(run) == pytest.approx(2.0)
