"""The serving engine's step timeline (``graphs.StepTimeline``, the
``timing`` of the engine's ``decode_window`` and ``prefill`` spans) on a
tiny granite-8b (``reduced()``, two kv heads, float32) and a tiny
mamba2-1.3b, port only.

On the CPU: every ``decode_window`` and ``prefill`` span carries a
record; the delivery periods' ticks add up to ``decode_ticks`` and their
delivery syncs to ``host_syncs``; the sync counts per site equal what a
scripted scenario implies (a chunked prompt, a bucketed one, a prefix hit's
suffix with a sampled admission, an exact-length SSD prefill); host
seconds are non-negative and ``device_s`` is None; with tracing off there
is no record, no CUDA event and no profiler range; a ``torch.profiler``
run from outside sees no ``repro_torch/`` range while the engine's hook
is disarmed, and the armed hook's trace holds them. The timeline's event
handling is checked with stand-in events: they are read only at a
delivery, and reused.

On a card (marked ``gpu``; run there with ``PYTHONPATH=src python -m
pytest -q --noconftest -m gpu tests/test_torch_timeline.py``): under
``torch.cuda.set_sync_debug_mode("error")``, with only the named sites
exempted, the engine serves without any other blocking call, and each
delivery period's device seconds stay within its wall seconds."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro_torch import serving as ts
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.serving.graphs import StepTimeline

torch.set_num_threads(2)

ENGINE = dict(slots=2, window=64, max_seq=128, sync_every=4,
              chunk_prefill=16, prefix_cache=True)
SP = dict(temperature=0.8, top_k=20, top_p=0.95)


def _cfg(arch):
    cfg = get_config(arch).reduced()
    if arch == "granite-8b":
        cfg = dataclasses.replace(cfg, num_kv_heads=2)
    return cfg


@pytest.fixture(scope="module")
def granite():
    cfg = _cfg("granite-8b")
    return cfg, init_params(cfg, 0, device="cpu")


def _engine(model, device="cpu", **kw):
    cfg, params = model
    return ts.ServingEngine(cfg, params, ts.EngineConfig(**kw),
                            device=device)


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, 500, n).astype(np.int32)


def _run(eng, reqs, t=0.0):
    for r in reqs:
        eng.submit(r, t)
    while any(r.finish_time < 0 for r in reqs):
        t += 1.0
        eng.step(t)
        assert t < 500
    eng.drain(t)
    return t


def _scenario(eng):
    """A chunked prompt (40 tokens: three chunks of 16) beside a bucketed
    one (10 tokens), then a prefix hit on the first's two full pages with
    a 13-token suffix step, sampled."""
    a = ts.Request(rid=0, prompt=_prompt(40), max_new_tokens=3)
    c = ts.Request(rid=2, prompt=_prompt(10, seed=2), max_new_tokens=9)
    t = _run(eng, [a, c])
    b = ts.Request(rid=1, prompt=np.concatenate([a.prompt, _prompt(5, 1)]),
                   max_new_tokens=6, sampling=ts.SamplingParams(seed=3, **SP))
    _run(eng, [b], t)
    return [a, c, b]


def _prefill(req):
    (sp,) = [s for s in req.trace.spans if s.kind == "prefill"]
    return sp.timing


def _periods(reqs):
    out = {}
    for r in reqs:
        for sp in r.trace.spans:
            if sp.kind == "decode_window":
                assert sp.timing is not None
                out.setdefault(sp.timing.serial, sp.timing)
                assert out[sp.timing.serial] is sp.timing  # one shared record
    return list(out.values())


def _total(recs, key):
    out = {}
    for rec in recs:
        for site, n in getattr(rec, key).items():
            out[site] = out.get(site, 0) + n
    return out


def test_spans_carry_the_timeline(granite):
    eng = _engine(granite, tracing=True, **ENGINE)
    a, c, b = _scenario(eng)
    assert _prefill(a).syncs == {"chunk.tokens": 3, "chunk.args": 3,
                                 "insert.args": 1, "first_token": 1}
    assert _prefill(c).syncs == {"bucket.tokens": 1, "bucket.args": 1,
                                 "first_token": 1}
    # the sampled admission writes its lane's five sampling leaves
    assert _prefill(b).syncs == {"suffix.tokens": 1, "suffix.args": 1,
                                 "sampling": 5, "first_token": 1}
    assert [s.meta.get("prefix_hit") for s in b.trace.spans
            if s.kind == "prefill"] == [32]
    periods = _periods([a, c, b])
    assert sum(p.ticks for p in periods) == eng.metrics.decode_ticks
    total = _total(periods + [eng._tl.period], "syncs")
    assert total["window"] + total["flush"] == eng.metrics.host_syncs
    for site in ("chunk.tokens", "chunk.args", "insert.args",
                 "bucket.tokens", "bucket.args", "suffix.tokens",
                 "suffix.args", "first_token"):
        assert total[site] == sum(_prefill(r).syncs.get(site, 0)
                                  for r in (a, c, b)), site
    # b's lane is put back to greedy when it is released; every request
    # releases its slot once
    assert total["sampling"] == 10 and total["release"] == 3
    for rec in periods + [_prefill(r) for r in (a, c, b)]:
        assert rec.launch_s >= 0 and rec.device_s is None
        assert all(w >= 0 for w in rec.wait_s.values())
        assert set(rec.wait_s) == set(rec.syncs)
    for p in periods:
        assert p.wall_s >= 0 and p.ticks > 0
    assert _prefill(a).launch_s > 0 and _prefill(a).ticks == 0
    assert len({p.serial for p in periods}) == len(periods)


def test_exact_prefill_sites(tmp_path):
    cfg = _cfg("mamba2-1.3b")
    eng = _engine((cfg, init_params(cfg, 0, device="cpu")), tracing=True,
                  slots=2, window=64, sync_every=4)
    reqs = [ts.Request(rid=i, prompt=_prompt(n, i), max_new_tokens=5,
                       sampling=ts.SamplingParams(seed=4, **SP) if i else None)
            for i, n in enumerate((9, 14))]
    _run(eng, reqs)
    assert _prefill(reqs[0]).syncs == {"exact.tokens": 1, "exact.len": 1,
                                       "exact.slot": 1, "first_token": 1}
    assert _prefill(reqs[1]).syncs == {"exact.tokens": 1, "exact.len": 1,
                                       "exact.slot": 1, "sampling": 5,
                                       "first_token": 1}
    periods = _periods(reqs)
    assert sum(p.ticks for p in periods) == eng.metrics.decode_ticks
    assert eng.prefill_traces == 2  # one eager key per prompt length


def test_tracing_off_makes_no_record_event_or_range(granite, monkeypatch):
    made = []

    class Refused:
        def __init__(self, *a, **kw):
            made.append(a)
            raise AssertionError("made with tracing off")

    monkeypatch.setattr(torch.cuda, "Event", Refused)
    monkeypatch.setattr(torch.profiler, "record_function", Refused)
    eng = _engine(granite, **ENGINE)
    assert eng._tl is None and eng.graphs.timeline is None
    reqs = _scenario(eng)
    assert all(r.trace is None for r in reqs) and not made
    # tracing on, the hook disarmed: records, no range (no event on a CPU)
    eng = _engine(granite, tracing=True, **ENGINE)
    _scenario(eng)
    assert not made


def _range_names(events):
    return {n for n in events if n.startswith("repro_torch/")}


def test_ranges_only_with_the_hook_armed(granite, tmp_path):
    eng = _engine(granite, tracing=True, **ENGINE)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _scenario(eng)
    names = [e.name for e in prof.events()]
    assert any(n.startswith("aten::") for n in names)
    assert not _range_names(names)
    out = tmp_path / "prof"
    eng = _engine(granite, profile_dir=str(out), **ENGINE)
    assert eng._tl is None
    assert eng.start_profile()
    assert eng._tl is not None and not eng._tl.timing
    reqs = _scenario(eng)
    assert eng.stop_profile()
    assert eng._tl is None and eng.graphs.timeline is None
    assert all(r.trace is None for r in reqs)
    (path,) = [out / f for f in os.listdir(out)]
    doc = json.loads(path.read_text())
    got = _range_names(e.get("name", "") for e in doc["traceEvents"])
    assert {"repro_torch/submit", "repro_torch/step", "repro_torch/drain",
            "repro_torch/run decode/scan4", "repro_torch/run decode/tick1",
            "repro_torch/run aux/chunk16", "repro_torch/run prefill/suffix16",
            "repro_torch/wait flush", "repro_torch/wait window",
            "repro_torch/wait first_token",
            "repro_torch/wait chunk.tokens"} <= got
    # a tracing engine keeps its timeline when the hook is disarmed
    eng = _engine(granite, tracing=True, profile_dir=str(tmp_path / "p2"),
                  **ENGINE)
    tl = eng._tl
    assert eng.start_profile() and eng._tl is tl and tl.ranges
    assert eng.stop_profile() and eng._tl is tl and not tl.ranges


class _Stream:
    pass


def test_events_read_only_at_a_delivery_and_reused(monkeypatch):
    """Stand-in CUDA events on a fake device clock: an event can be read
    only once a sync has passed it; ``deliver`` reads them, charges the
    period (and the owner) by kind, and returns them to the pool."""
    clock, passed, made = [0.0], set(), []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            made.append(self)

        def record(self, stream=None):
            assert isinstance(stream, _Stream)
            self.t = clock[0]
            passed.discard(id(self))

        def elapsed_time(self, end):
            assert id(self) in passed and id(end) in passed, "not reached"
            return (end.t - self.t) * 1e3

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    tl = StepTimeline(torch.device("cuda"), timing=True, events=True)

    def run(dt):
        def go(kind, name, n, step, capture):
            clock[0] += dt
            return name
        return go

    def sync():  # a delivery sync: every event recorded so far is reached
        passed.update(id(e) for e in made)

    owner = tl.record()
    tl.owner = owner
    assert tl.step(run(0.25), "prefill", "paged", 64, None, True) == "paged"
    tl.owner = None
    tl.step(run(0.5), "aux", "chunk", 64, None, True)
    tl.step(run(1.0), "decode", "tick", 1, None, True)
    assert tl.wait("flush", sync, delivery=True) is None
    rec = tl.deliver(1)
    assert rec.device_s == {"decode": 1.0, "prefill": 0.25, "aux": 0.5}
    assert owner.device_s == {"decode": 0.0, "prefill": 0.25, "aux": 0.0}
    assert rec.syncs == {"flush": 1} and owner.syncs == {}
    assert rec.ticks == 1 and rec.wall_s >= 0 and len(made) == 6
    for _ in range(3):
        tl.step(run(2.0), "decode", "scan", 8, None, True)
        tl.wait("window", sync, delivery=True)
        nxt = tl.deliver(8)
        assert nxt.device_s["decode"] == 2.0 and nxt.serial > rec.serial
        rec = nxt
    assert len(made) == 6  # the pool's pairs, reused
    tl.step(run(1.0), "decode", "tick", 1, None, True)
    tl.reset()  # a pending pair is dropped, never read
    assert tl.period.device_s == {"decode": 0.0, "prefill": 0.0, "aux": 0.0}


def _exempt_named_sites(eng):
    """Route the timeline's waits out of the sync check: every named
    site may block, nothing else may."""
    tl = eng._tl
    wait = tl.wait

    def exempt(site, fn, *args, **kw):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return wait(site, fn, *args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    tl.wait = exempt


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-8b", "mamba2-1.3b"])
def test_only_named_sites_block_on_the_card(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = _cfg(arch)
    params = _to(init_params(cfg, 0, device="cpu"), "cuda")
    knobs = (ENGINE if arch == "granite-8b"
             else dict(slots=2, window=64, sync_every=4))
    eng = _engine((cfg, params), "cuda", tracing=True, **knobs)

    def serve():
        if arch == "granite-8b":
            return _scenario(eng)
        reqs = [ts.Request(rid=i, prompt=_prompt(n, i), max_new_tokens=7,
                           sampling=ts.SamplingParams(seed=4, **SP)
                           if i % 2 else None)
                for i, n in enumerate((9, 14, 9))]
        _run(eng, reqs)
        return reqs

    serve()  # every step key run once and captured
    torch.cuda.synchronize()
    eng.reset()
    _exempt_named_sites(eng)
    torch.cuda.set_sync_debug_mode("error")
    try:
        reqs = serve()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    periods = _periods(reqs)
    assert sum(p.ticks for p in periods) == eng.metrics.decode_ticks
    for p in periods:
        dev = sum(p.device_s.values())
        assert 0 < dev <= p.wall_s + 1e-6, p
    for r in reqs:
        rec = _prefill(r)
        assert rec.launch_s > 0 and sum(rec.device_s.values()) > 0
