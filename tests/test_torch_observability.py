"""The PyTorch port's observability against the JAX package's: the engine's
span tracing, ``metrics_registry``, the profiler hook and the compile
events, and the cluster's traces and registry, on granite-8b
``reduced()`` with two kv heads, float32, the same converted weights,
both packages' engines priced at the reference's chip constants.

Each test replays an engine or cluster case of the reference suite
(``tests/test_observability.py``) on both packages on a virtual clock and
compares, per rid, every span and event of its trace (kind, t0, t1, meta)
and the traces' Chrome export, which must validate. Also: with tracing off
no trace object exists; tracing on leaves streams, host syncs and step
keys as they are; preempt and restore spans; failover spans; compile
events flat across a second workload; a real ``torch.profiler`` run into
a directory; the engine's and the cluster's metrics exposition, names and
values (the step wall histogram's values are the host's wall clock, so
only its name and count are compared); ``load_report`` histograms merged
across replicas; and the exact-length prefill of recurrentgemma counted
as the reference counts it (``prefill/exact{L}``)."""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro import models as jm
from repro import serving as js
from repro.configs import get_config as jax_config
from repro.core.hardware import TPU_V5E
from repro_torch import models as tm
from repro_torch import serving as ts
from repro_torch.configs import get_config as torch_config
from repro_torch.core.hardware import Chip

torch.set_num_threads(2)

TPU = Chip(**dataclasses.asdict(TPU_V5E))
ENGINE = dict(slots=2, window=64, max_seq=128)
PARTITIONABLE = bool(jax.config.jax_threefry_partitionable)


class Side:
    def __init__(self, pkg, cfg, params, extra):
        self.pkg, self.cfg, self.params, self.extra = pkg, cfg, params, extra

    def engine(self, **kw):
        return self.pkg.ServingEngine(self.cfg, self.params,
                                      self.pkg.EngineConfig(**kw),
                                      **self.extra)

    def request(self, rid, prompt, max_new, seed=None):
        sp = (self.pkg.SamplingParams(temperature=0.7, top_k=20, top_p=0.95,
                                      seed=seed)
              if seed is not None else None)
        return self.pkg.Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                                max_new_tokens=max_new, sampling=sp)


def _side(pkg, cfg, params):
    extra = ({} if pkg is js else dict(
        device="cpu", chip=TPU, threefry_partitionable=PARTITIONABLE))
    return Side(pkg, cfg, params, extra)


@pytest.fixture(scope="module")
def setup():
    jc = dataclasses.replace(jax_config("granite-8b").reduced(),
                             num_kv_heads=2)
    tc = dataclasses.replace(torch_config("granite-8b").reduced(),
                             num_kv_heads=2)
    jp = jm.init_params(jc, jax.random.key(0))
    tp = tm.params_from_jax(tc, jax.tree.map(np.asarray, jp), "cpu")
    return {"jax": _side(js, jc, jp), "torch": _side(ts, tc, tp)}


def _prompt(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 500, n).astype(np.int32)


def _run(eng, reqs, *, max_steps=500):
    resolved, t = {}, 0.0
    for r in reqs:
        eng.submit(r, t)
    while len(resolved) < len(reqs) and max_steps:
        t += 1.0
        for r in eng.step(t):
            resolved[r.rid] = r
        max_steps -= 1
    for r in eng.drain(t):
        resolved[r.rid] = r
    return resolved, t


def _spans(trace):
    if trace is None:
        return None
    return [(sp.kind, sp.t0, sp.t1, dict(sp.meta)) for sp in trace.spans]


def _traces(reqs):
    return {r.rid: _spans(r.trace) for r in reqs}


def _both(setup, scenario):
    return [scenario(setup[w]) for w in ("jax", "torch")]


@pytest.mark.parametrize("sync_every", [1, 4])
def test_engine_lifecycle_spans_match_jax(setup, sync_every):
    """test_engine_stamps_full_lifecycle: every span and event per rid,
    the rollups, and the exported trace."""

    def scenario(side):
        eng = side.engine(sync_every=sync_every, tracing=True, **ENGINE)
        reqs = [side.request(i, _prompt(8 + 9 * i, seed=i), 4 + i % 3,
                             seed=(100 + i if i % 2 else None))
                for i in range(5)]
        resolved, _ = _run(eng, reqs)
        doc = side.pkg.chrome_trace(
            side.pkg.request_traces(resolved.values()))
        assert side.pkg.validate_chrome_trace(doc) == []
        assert all(r.trace.validate() == [] for r in reqs)
        assert eng._tick_wall.count > 0
        return (_traces(reqs), eng.tracer.collected,
                dict(eng.tracer.span_totals), eng.tracer.totals_wire(),
                doc, _spans(eng.tracer.engine))

    jax_obs, torch_obs = _both(setup, scenario)
    assert torch_obs == jax_obs
    for spans in torch_obs[0].values():
        assert {"queued", "prefill", "decode",
                "decode_window"} <= {s[0] for s in spans}
    assert torch_obs[1] == 5
    assert {s[0] for s in torch_obs[5]} == {"compile"}


def test_chunked_and_prefix_spans_match_jax(setup):
    """A chunked prompt (``prefill_chunk`` events), then prefix hits with a
    synchronous and a chunked suffix (``prefill`` path ``prefix``)."""

    def scenario(side):
        eng = side.engine(sync_every=4, tracing=True, chunk_prefill=16,
                          prefix_cache=True, **ENGINE)
        tpl = _prompt(48, seed=5)
        first = [side.request(0, tpl, 3)]
        _run(eng, first)
        hits = [side.request(1, np.concatenate([tpl, _prompt(5, seed=6)]), 4,
                             seed=7),
                side.request(2, np.concatenate([tpl, _prompt(40, seed=8)]),
                             4)]
        _run(eng, hits)
        return _traces(first + hits), eng.tracer.totals_wire()

    jax_obs, torch_obs = _both(setup, scenario)
    assert torch_obs == jax_obs
    spans = torch_obs[0]
    assert any(s[0] == "prefill_chunk" for s in spans[0])
    assert [s[3].get("prefix_hit") for s in spans[1]
            if s[0] == "prefill"] == [48]


def test_tracing_off_adds_nothing(setup):
    """test_tracing_off_means_no_trace_objects and
    test_streams_bit_identical_tracing_on_vs_off: off, no trace objects,
    no step walls, nothing collected; on and off, the same streams, host
    syncs and step keys on each package, and the port's equal the
    reference's."""

    def scenario(side):
        out = {}
        for tracing in (False, True):
            eng = side.engine(sync_every=4, tracing=tracing, **ENGINE)
            reqs = [side.request(i, _prompt(9 + i, seed=i), 5, seed=300 + i)
                    for i in range(4)]
            resolved, _ = _run(eng, reqs)
            if not tracing:
                assert all(r.trace is None for r in resolved.values())
                assert eng._tick_wall.count == 0
                assert eng.tracer.collected == 0
            out[tracing] = ({rid: list(map(int, r.output))
                             for rid, r in resolved.items()},
                            eng.metrics.host_syncs, eng.metrics.decode_ticks,
                            dict(eng.compile_events),
                            eng.prefill_traces, eng.decode_traces)
        assert out[False] == out[True]
        return out[False]

    jax_obs, torch_obs = _both(setup, scenario)
    assert torch_obs == jax_obs
    eng = setup["torch"].engine(sync_every=4, tracing=True, **ENGINE)
    _run(eng, [setup["torch"].request(0, _prompt(9), 5)])
    assert eng.graphs.captures == 0  # on the CPU every step runs eagerly


def test_preempt_restore_spans_match_jax(setup):
    def scenario(side):
        eng = side.engine(sync_every=1, prefix_cache=True, tracing=True,
                          **ENGINE)
        victim = side.request(0, _prompt(12), 8, seed=42)
        eng.submit(victim, 0.0)
        for t in (1.0, 2.0, 3.0):
            eng.step(t)
        assert eng.preempt(0, 3.0) is victim
        eng.submit(victim, 4.0)
        t = 4.0
        while not victim.done:
            t += 1.0
            eng.step(t)
        eng.drain(t)
        assert victim.trace.validate() == []
        return _spans(victim.trace), list(map(int, victim.output))

    jax_obs, torch_obs = _both(setup, scenario)
    assert torch_obs == jax_obs
    kinds = [s[0] for s in torch_obs[0]]
    assert {"preempt", "restore"} <= set(kinds)
    assert kinds.count("decode") == 2


def test_failover_spans_match_jax(setup):
    """test_failover_spans_survive_replica_death: the frontend's traces
    (queued, dispatch, failover_retry) and the engines' phases in one
    trace per request, lanes by serving replica."""

    def scenario(side):
        proxies = [side.pkg.FaultyEngine(side.engine(
            sync_every=1, tracing=True, **ENGINE)) for _ in range(2)]
        fe = side.pkg.ClusterFrontend(proxies, policy="round-robin", seed=0,
                                      health_timeout_s=50.0, max_retries=3,
                                      retry_backoff_s=1.0, tracing=True)
        reqs = [side.request(i, _prompt(10 + i, seed=i), 6, seed=500 + i)
                for i in range(6)]
        resolved, t = {}, 0.0
        for r in reqs:
            fe.submit(r, 0.0)
        while len(resolved) < len(reqs) and t < 200.0:
            t += 1.0
            if t == 2.0:
                proxies[0].inject("kill")
            for r in fe.step(t):
                resolved[r.rid] = r
        assert all(r.trace.validate() == [] for r in reqs)
        lanes = side.pkg.request_traces(reqs)
        doc = side.pkg.chrome_trace(lanes)
        assert side.pkg.validate_chrome_trace(doc) == []
        return _traces(reqs), [lane for lane, _ in lanes], doc

    jax_obs, torch_obs = _both(setup, scenario)
    assert torch_obs == jax_obs
    retried = [s for s in torch_obs[0].values()
               if any(k[0] == "failover_retry" for k in s)]
    assert retried and all(lane.startswith("pool/") for lane in torch_obs[1])


def test_compile_events_flat_across_a_second_workload(setup):
    def scenario(side):
        eng = side.engine(sync_every=4, tracing=True, **ENGINE)
        _run(eng, [side.request(i, _prompt(9 + i, seed=i), 4)
                   for i in range(3)])
        warm = dict(eng.compile_events)
        events = _spans(eng.tracer.engine)
        eng.reset()
        assert eng.compile_events == warm
        _run(eng, [side.request(10 + i, _prompt(9 + i, seed=i), 4)
                   for i in range(3)])
        assert eng.compile_events == warm
        assert dict(eng.load_report().compile_events) == warm
        return warm, events, _spans(eng.tracer.engine)

    jax_obs, torch_obs = _both(setup, scenario)
    assert torch_obs == jax_obs
    assert torch_obs[2] == []  # nothing new compiled after reset()


def test_exact_prefill_probes_match_jax():
    """recurrentgemma ``reduced()`` cut to 5 layers prefills at the exact
    prompt length: the reference retraces once per length and counts it
    (``prefill/exact{L}`` in ``compile_events`` and ``prefill_traces``);
    the port runs that step eagerly on a key per length and counts it
    the same way, so ``load_report`` and the trace's compile events
    agree."""
    jc = dataclasses.replace(jax_config("recurrentgemma-9b").reduced(),
                             num_layers=5)
    tc = dataclasses.replace(torch_config("recurrentgemma-9b").reduced(),
                             num_layers=5)
    jp = jm.init_params(jc, jax.random.key(0))
    tp = tm.params_from_jax(tc, jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(3)
    lens = (5, 23, 64, 40)
    prompts = [rng.integers(0, jc.vocab_size, n).astype(np.int32)
               for n in lens]
    got = {}
    for w, side in (("jax", _side(js, jc, jp)), ("torch", _side(ts, tc, tp))):
        eng = side.engine(slots=3, chunk_prefill=0, tracing=True)
        assert not eng.paged
        _run(eng, [side.request(i, p, 6) for i, p in enumerate(prompts)])
        first = (eng.prefill_traces, eng.decode_traces,
                 dict(eng.compile_events))
        eng.reset()
        _run(eng, [side.request(10 + i, p, 6)
                   for i, p in enumerate(prompts[:2])])
        got[w] = (first, eng.prefill_traces, dict(eng.compile_events),
                  dict(eng.load_report().compile_events),
                  _spans(eng.tracer.engine))
    assert got["torch"] == got["jax"]
    assert got["torch"][0][0] == len(lens)
    assert {f"prefill/exact{n}" for n in lens} <= set(got["torch"][2])


def test_profiler_hook_gated_by_config(setup, tmp_path):
    """Disarmed without ``profile_dir``; armed once; a real
    ``torch.profiler`` run whose Chrome trace lands in the directory;
    the start and stop events stamped into the engine's trace."""
    side = setup["torch"]
    bare = side.engine(**ENGINE)
    assert bare.start_profile() is False and bare.stop_profile() is False
    out = tmp_path / "prof"
    eng = side.engine(tracing=True, profile_dir=str(out), **ENGINE)
    assert eng.start_profile() is True
    assert eng.start_profile() is False
    _run(eng, [side.request(0, _prompt(9), 3)])
    assert eng.stop_profile() is True
    assert eng.stop_profile() is False
    files = os.listdir(out)
    assert files and all(os.path.getsize(out / f) > 0 for f in files)
    kinds = [sp.kind for sp in eng.tracer.engine.spans]
    assert kinds[0] == "profile_start" and kinds[-1] == "profile_stop"
    # two engines share the process's one profiler: the last stop writes
    peers = [side.engine(profile_dir=str(tmp_path / "two"), **ENGINE)
             for _ in range(2)]
    assert all(p.start_profile() for p in peers)
    assert peers[0].stop_profile() and not os.path.exists(tmp_path / "two")
    assert peers[1].stop_profile() and os.listdir(tmp_path / "two")


def _expo(reg):
    """Exposition lines as {name: value}; the step-wall histogram's values
    are host wall seconds, so only its count line is kept."""
    out = {}
    for line in reg.exposition().splitlines():
        if line.startswith("#"):
            continue
        name, value = line.rsplit(" ", 1)
        if "step_wall_seconds" in name and not name.endswith("_count"):
            continue
        out[name] = float(value)
    return out


def test_engine_and_cluster_registries_match_jax(setup):
    """test_engine_and_cluster_metrics_registries: every exposed name and
    value, engine and cluster."""

    def scenario(side):
        engines = [side.engine(sync_every=4, tracing=True, **ENGINE)
                   for _ in range(2)]
        fe = side.pkg.ClusterFrontend(engines, policy="round-robin", seed=0,
                                      tracing=True)
        reqs = [side.request(i, _prompt(8 + i, seed=i), 4) for i in range(6)]
        resolved, t = {}, 0.0
        for r in reqs:
            fe.submit(r, 0.0)
        while len(resolved) < len(reqs) and t < 200.0:
            t += 1.0
            for r in fe.step(t):
                resolved[r.rid] = r
        reg, creg = engines[0].metrics_registry(), fe.metrics_registry()
        snap = creg.snapshot()
        return (_expo(reg), _expo(creg), snap["cluster_completed_total"],
                creg.get("cluster_jct_seconds").count)

    jax_obs, torch_obs = _both(setup, scenario)
    assert set(torch_obs[0]) == set(jax_obs[0])
    assert set(torch_obs[1]) == set(jax_obs[1])
    assert torch_obs == jax_obs
    assert "serving_prefill_traces_total" in torch_obs[0]
    assert torch_obs[2:] == (6, 6)


def test_load_report_histograms_merge_like_jax(setup):
    """test_load_report_histograms_merge_across_replicas: the wire
    histograms of both packages merge exactly, across packages too."""
    wires = {}
    for w in ("jax", "torch"):
        side = setup[w]
        hists = []
        for k in range(2):
            eng = side.engine(sync_every=4, **ENGINE)
            _run(eng, [side.request(10 * k + i, _prompt(8 + i, seed=i), 4)
                       for i in range(3)])
            hists.append(dict(eng.load_report().histograms)["jct_s"])
        wires[w] = hists
    assert wires["torch"] == wires["jax"]
    merged = ts.latency_histogram()
    for wire in wires["torch"] + wires["jax"]:
        merged.merge(ts.Histogram.from_wire(wire))
    assert merged.count == 12 and merged.percentile(50) > 0
