"""The PyTorch port's overload control (``repro_torch.serving.overload``)
against the JAX package's: the pure pieces operation by operation, the
cluster's ladder over both packages' engines (granite-8b ``reduced()`` as
the reference suite serves it, float32, the same converted weights, both
priced at the reference's chip constants).

Pure pieces, from ``tests/test_overload.py`` and
``tests/test_overload_property.py``: the token bucket's waits, typed
admission rejections, the weighted-fair queue's pop order (flat EDF, weight
shares, a flood beside a victim, forfeited deficit, and under hypothesis
random tenant mixes with a mid-drain flood, the DRR property checked on
the port's queue and its pop order held to the reference's), the
detector's levels and transitions, the circuit breaker's states, and
``TenantMetrics`` / ``LoadReport`` wire round trips read across packages.
In the cluster: shed, brownout and reject counts per tenant with the same
``retry_after_s``, per-tenant stats on the wire, the single-tenant path,
the brownout-prefix property, and the engine's trace sampling and ring."""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import models as jm
from repro import serving as js
from repro.configs import get_config as jax_config
from repro.core.hardware import TPU_V5E
from repro.serving import metrics as jmet
from repro_torch import models as tm
from repro_torch import serving as ts
from repro_torch.configs import get_config as torch_config
from repro_torch.core.hardware import Chip
from repro_torch.serving import metrics as tmet

torch.set_num_threads(2)

TPU = Chip(**dataclasses.asdict(TPU_V5E))
PKGS = {"jax": (js, jmet), "torch": (ts, tmet)}
ENGINE = dict(slots=2, window=64, max_seq=128, sync_every=4)


def _prompt(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 500, n).astype(np.int32)


def _req(pkg, rid, tenant="", plen=8, budget=4, arrival=0.0, slo=0.0,
         seed=0):
    return pkg.Request(rid, _prompt(plen, seed=seed or rid),
                       max_new_tokens=budget, arrival_time=arrival,
                       tenant=tenant, ttft_slo_s=slo)


def _pure(scenario):
    """The scenario's observations on the JAX package and on the port."""
    return [scenario(*PKGS[w]) for w in ("jax", "torch")]


# -- token bucket, admission -------------------------------------------------


def test_token_bucket_and_admission_match_jax():
    def scenario(pkg, _):
        b = pkg.TokenBucket(rate=10.0, capacity=20.0)
        waits = [b.take(20.0, 0.0), b.take(10.0, 0.0)]
        waits.append(b.take(10.0, waits[-1]))
        waits.append(pkg.TokenBucket(rate=10.0, capacity=20.0).take(50.0,
                                                                     0.0))
        b = pkg.TokenBucket(rate=3.0, capacity=1.0)
        for i in range(12):
            waits.append(b.take(1.0 + i % 4, 0.37 * i))
        adm = pkg.TenantAdmission({"t": pkg.TenantClass(
            "t", rate_tokens_s=10.0, burst_tokens=16.0)})
        out = [adm.admit(_req(pkg, 0, "t", plen=8, budget=4), 0.0)]
        with pytest.raises(pkg.RequestRejected) as ei:
            adm.admit(_req(pkg, 1, "t", plen=8, budget=8), 0.0)
        out.append((str(ei.value), ei.value.retry_after_s))
        adm.admit(_req(pkg, 2, "other", plen=100, budget=100), 0.0)
        return waits, out

    jax_obs, torch_obs = _pure(scenario)
    assert torch_obs == jax_obs
    assert torch_obs[0][1] == pytest.approx(1.0) and torch_obs[1][1][1] > 0


# -- weighted-fair queue -----------------------------------------------------


def _pop_all(q):
    out = []
    while len(q):
        r = q.pop()
        out.append((r.rid, r.tenant))
    return out


def test_wfq_sequences_match_jax():
    """Flat EDF, 2:1 weight shares, a flood beside a victim and a drained
    tenant's forfeited deficit: the same pops, waits and bounds."""

    def scenario(pkg, _):
        q = pkg.WeightedFairQueue(edf=True)
        for i, slo in enumerate([5.0, 2.0, 9.0, 2.0]):
            q.push(_req(pkg, i, arrival=0.0, slo=slo))
        flat = _pop_all(q)
        w = {"a": 2.0, "b": 1.0}
        q = pkg.WeightedFairQueue(quantum=16.0, weight_of=lambda t: w[t])
        for i in range(40):
            q.push(_req(pkg, 100 + i, "a", plen=8, budget=8))
            q.push(_req(pkg, 200 + i, "b", plen=8, budget=8))
        shares = [q.pop().rid for _ in range(30)]
        q = pkg.WeightedFairQueue(quantum=8.0)
        for i in range(50):
            q.push(_req(pkg, i, "flood", plen=16, budget=16))
        q.push(_req(pkg, 99, "victim", plen=16, budget=16))
        bound = q.starvation_bound(32.0)
        flood = _pop_all(q)
        q2 = pkg.WeightedFairQueue(quantum=1000.0)
        q2.push(_req(pkg, 0, "a"))
        q2.pop()
        q2.push(_req(pkg, 1, "a", plen=8, budget=8))
        q2.push(_req(pkg, 2, "b", plen=8, budget=8))
        forfeit = _pop_all(q2)
        return (flat, shares, bound, flood, q.max_wait_rounds,
                dict(q.wait_rounds), forfeit, q2.max_wait_rounds)

    jax_obs, torch_obs = _pure(scenario)
    assert torch_obs == jax_obs
    assert [rid for rid, _ in torch_obs[0]] == [1, 3, 0, 2]
    assert torch_obs[4] <= torch_obs[2]


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**20))
def test_drr_property_and_pop_order_match_jax(seed):
    """test_drr_never_starves_backlogged_tenant on the port's queue: random
    tenants, weights, quantum and shapes, a flood mid-drain; no backlogged
    tenant waits past the provable bound, and every pop equals the
    reference's over the same pushes."""

    def scenario(pkg, _):
        rng = np.random.default_rng(seed)
        tenants = {
            f"t{t}": pkg.TenantClass(f"t{t}", tier=int(rng.integers(0, 3)),
                                     weight=float(rng.uniform(0.5, 8.0)))
            for t in range(int(rng.integers(2, 7)))}
        q = pkg.WeightedFairQueue(quantum=float(rng.uniform(8.0, 512.0)),
                                  weight_of=lambda n: tenants[n].weight)

        def burst(rid0, names):
            reqs = []
            for name in names:
                for _ in range(int(rng.integers(1, 20))):
                    r = pkg.Request(
                        rid0 + len(reqs),
                        np.zeros(int(rng.integers(1, 64)), np.int32),
                        max_new_tokens=int(rng.integers(1, 64)),
                        tenant=name,
                        arrival_time=float(rng.uniform(0.0, 5.0)),
                        ttft_slo_s=float(rng.choice([0.0, 10.0, 30.0])))
                    q.push(r)
                    reqs.append(r)
            return reqs

        reqs = burst(0, list(tenants))
        pops = [q.pop().rid for _ in range(len(q) // 2)]
        reqs += burst(10_000, [str(rng.choice(list(tenants)))])
        max_cost = max(pkg.request_cost(r) for r in reqs)
        min_w = min(tc.weight for tc in tenants.values())
        bound = int(math.ceil(max_cost / (q.quantum * min_w))) + 1
        assert q.starvation_bound(max_cost) <= bound
        while len(q):
            pops.append(q.pop().rid)
        assert q.max_wait_rounds <= bound
        return pops, q.max_wait_rounds, dict(q.wait_rounds)

    jax_obs, torch_obs = _pure(scenario)
    assert torch_obs == jax_obs


# -- detector, breaker, wire ------------------------------------------------


def _report(pkg, met, backlog_s=0.0, ttfts=()):
    h = met.latency_histogram()
    for v in ttfts:
        h.observe(v)
    return pkg.LoadReport(
        slots=2, free_slots=0, queued_requests=0, queued_prefill_tokens=0,
        decode_tokens_remaining=0, free_pages=-1, total_pages=0,
        backlog_s=backlog_s, tick_est_s=0.01, queued_prefill_s=0.0,
        histograms=(("ttft_s", h.to_wire()),) if ttfts else ())


def test_detector_matches_jax():
    """The hysteresis ladder up and down, the accumulating tail window and
    the frontend backlog, from tests/test_overload.py."""

    def scenario(pkg, met):
        det = pkg.OverloadDetector(ttft_slo_s=1.0, backlog_high_s=2.0,
                                   period_s=1.0, patience=2,
                                   relax_patience=2)
        levels, t = [], 0.0
        for backlog in [5.0] * 9 + [0.1] * 8:
            levels.append(det.observe(t, [_report(pkg, met, backlog)]))
            t += 1.0
        ladder = (levels, list(det.transitions), det.retry_after_s(),
                  det.last_backlog_s, det.level_name)
        det = pkg.OverloadDetector(ttft_slo_s=1.0, backlog_high_s=1e9,
                                   period_s=1.0, patience=1, min_window=4)
        t, ttfts, tail = 0.0, [], [det.observe(0.0, [_report(pkg, met)])]
        for _ in range(4):
            t += 1.0
            ttfts.append(5.0)
            tail.append(det.observe(t, [_report(pkg, met, 0.0, ttfts)]))
        tail.append(det.last_p99_ttft)
        det = pkg.OverloadDetector(ttft_slo_s=1.0, backlog_high_s=2.0,
                                   period_s=1.0, patience=1)
        det.observe(0.0, [_report(pkg, met, 0.1)])
        fb = det.observe(1.0, [_report(pkg, met, 0.1)],
                         frontend_backlog_s=10.0)
        return ladder, tail, fb

    jax_obs, torch_obs = _pure(scenario)
    assert torch_obs == jax_obs
    assert max(torch_obs[0][0]) == ts.REJECT and torch_obs[1][4] == ts.SHED


def test_breaker_matches_jax():
    def scenario(pkg, _):
        br = pkg.CircuitBreaker(cooldown_s=1.0, probe_limit=1, close_after=2)
        seen = [br.allow("r", 0.0)]
        br.trip("r", 0.0)
        seen += [br.allow("r", 0.5), br.allow("r", 1.5)]
        br.note_dispatch("r", 1.5)
        seen.append(br.allow("r", 1.6))
        br.note_success("r", 2.0)
        seen.append(br.allow("r", 2.1))
        br.note_dispatch("r", 2.1)
        br.note_success("r", 2.5)
        seen.append(br.state("r", 2.6))
        br.note_failure("r", 3.0)
        seen += [br.allow("r", 3.1), br.state("r", 4.5)]
        return seen

    jax_obs, torch_obs = _pure(scenario)
    assert torch_obs == jax_obs
    assert torch_obs == [True, False, True, False, True, "closed", False,
                         "half_open"]


def test_tenant_metrics_and_load_report_wire_cross_packages():
    """A report or a tenant's metrics written by either package reads in
    the other, and the two write the same wire."""
    wires = {}
    for w, (pkg, _) in PKGS.items():
        a, b = pkg.TenantMetrics(), pkg.TenantMetrics()
        a.admitted, a.completed, a.total_tokens = 3, 2, 50
        a.ttfts.observe(0.5)
        b.admitted, b.shed, b.browned_out = 2, 1, 1
        b.ttfts.observe(1.5)
        merged = pkg.TenantMetrics().merge(a).merge(b)
        m = pkg.ServeMetrics()
        m.tenant("gold").admitted = 2
        m.tenant("gold").ttfts.observe(0.25)
        rep = pkg.LoadReport(slots=2, free_slots=2, queued_requests=0,
                             queued_prefill_tokens=0,
                             decode_tokens_remaining=0, free_pages=-1,
                             total_pages=0, backlog_s=0.0, tick_est_s=0.0,
                             queued_prefill_s=0.0, browned_out=3,
                             tenant_stats=m.tenant_wire())
        wires[w] = (merged.to_wire(), rep.to_dict(),
                    m.registry().exposition())
    assert wires["torch"] == wires["jax"]
    t_wire, t_rep, _ = wires["torch"]
    j_wire, j_rep, _ = wires["jax"]
    assert js.TenantMetrics.from_wire(t_wire).to_wire() == j_wire
    assert ts.TenantMetrics.from_wire(j_wire).to_wire() == t_wire
    assert ts.LoadReport.from_dict(j_rep).to_dict() == t_rep
    assert js.LoadReport.from_dict(t_rep).to_dict() == j_rep


# -- in the cluster -----------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    # the reference suite's config as it is (its ladder thresholds are
    # set for these cost-model seconds)
    jc = jax_config("granite-8b").reduced()
    tc = torch_config("granite-8b").reduced()
    jp = jm.init_params(jc, jax.random.key(0))
    tp = tm.params_from_jax(tc, jax.tree.map(np.asarray, jp), "cpu")
    extra = dict(device="cpu", chip=TPU, threefry_partitionable=bool(
        jax.config.jax_threefry_partitionable))
    return {"jax": (js, jc, jp, {}), "torch": (ts, tc, tp, extra)}


@pytest.fixture(scope="module")
def pools(setup):
    """Two warm replicas per package, reset before each use."""
    return {w: [pkg.ServingEngine(cfg, p, pkg.EngineConfig(**ENGINE), **x)
                for _ in range(2)]
            for w, (pkg, cfg, p, x) in setup.items()}


def _tenants(pkg):
    return {"gold": pkg.TenantClass("gold", tier=1, weight=2.0),
            "bulk": pkg.TenantClass("bulk", tier=0, weight=1.0)}


def _drive(fe, reqs, *, max_steps=600):
    pending = sorted(reqs, key=lambda r: (r.arrival_time, r.rid))
    resolved, i, now = {}, 0, 0.0
    while len(resolved) < len(pending):
        while i < len(pending) and pending[i].arrival_time <= now:
            fe.submit(pending[i], now)
            i += 1
        for r in fe.step(now):
            resolved[r.rid] = r
        now += 1.0
        assert now < max_steps
    return resolved


def _obs(resolved):
    return {rid: (r.state.value, list(map(int, r.output)), r.fail_reason,
                  r.retry_after_s, r.browned_out_tokens, r.max_new_tokens,
                  r.routed_to, r.tier)
            for rid, r in sorted(resolved.items())}


def _tenant_obs(fe):
    m = fe.merged_metrics()
    return ((m.shed, m.rejected, m.browned_out, m.completed),
            {n: tm_.to_wire()[0] for n, tm_ in sorted(m.tenants.items())},
            fe._queue.max_wait_rounds)


def _cluster(setup, pools, scenario):
    out = []
    for w in ("jax", "torch"):
        engines = pools[w]
        for e in engines:
            e.reset()
        out.append(scenario(setup[w][0], engines))
    return out


def test_ladder_shed_matches_jax(setup, pools):
    """test_cluster_ladder_sheds_low_tier_protects_top."""

    def scenario(pkg, engines):
        det = pkg.OverloadDetector(ttft_slo_s=8.0, backlog_high_s=0.002,
                                   period_s=1.0, patience=1,
                                   relax_patience=50)
        fe = pkg.ClusterFrontend(engines, tenants=_tenants(pkg),
                                 overload=det, fair_quantum=32.0)
        reqs = ([_req(pkg, i, "bulk", plen=12, budget=10) for i in range(12)]
                + [_req(pkg, 100 + i, "gold", plen=8, budget=6, arrival=4.0,
                        slo=30.0) for i in range(3)])
        resolved = _drive(fe, reqs)
        return _obs(resolved), _tenant_obs(fe), list(det.transitions)

    jax_obs, torch_obs = _cluster(setup, pools, scenario)
    assert torch_obs == jax_obs
    resolved = torch_obs[0]
    shed = [o for o in resolved.values()
            if o[2].startswith("shed: overload ladder")]
    assert shed and all(o[3] > 0 for o in shed)
    assert all(resolved[100 + i][0] == "finished" for i in range(3))


def test_ladder_brownout_matches_jax(setup, pools):
    """test_cluster_brownout_trims_and_counts_once."""

    def scenario(pkg, engines):
        det = pkg.OverloadDetector(ttft_slo_s=8.0, backlog_high_s=0.002,
                                   period_s=1.0, patience=1,
                                   relax_patience=50, max_level=pkg.BROWNOUT)
        tenants = {"gold": pkg.TenantClass("gold", tier=2),
                   "mid": pkg.TenantClass("mid", tier=1, brownout_frac=0.5),
                   "bulk": pkg.TenantClass("bulk", tier=0)}
        fe = pkg.ClusterFrontend(engines, tenants=tenants, overload=det)
        reqs = ([_req(pkg, i, "bulk", plen=12, budget=10) for i in range(10)]
                + [_req(pkg, 50 + i, "mid", plen=8, budget=8, arrival=5.0)
                   for i in range(3)])
        resolved = _drive(fe, reqs)
        return _obs(resolved), _tenant_obs(fe)

    jax_obs, torch_obs = _cluster(setup, pools, scenario)
    assert torch_obs == jax_obs
    browned = [o for o in torch_obs[0].values() if o[4]]
    assert browned and torch_obs[1][0][2] == len(browned)


def test_ladder_reject_and_rate_limit_match_jax(setup, pools):
    """test_cluster_reject_level_typed_retry_after, then a rate-limited
    bulk tenant (``bulk=0:1:<rate>:<burst>``) under its offered load:
    typed rejections with the same finite ``retry_after_s``."""

    def scenario(pkg, engines):
        det = pkg.OverloadDetector(ttft_slo_s=8.0, backlog_high_s=0.002,
                                   period_s=1.0, patience=1,
                                   relax_patience=50)
        fe = pkg.ClusterFrontend(engines, tenants=_tenants(pkg),
                                 overload=det)
        for i in range(14):
            fe.submit(_req(pkg, i, "bulk", plen=12, budget=10), 0.0)
        now, levels = 0.0, []
        while det.level < pkg.REJECT:
            now += 1.0
            fe.step(now)
            levels.append(det.level)
            assert now < 100
        late = _req(pkg, 500, "bulk", plen=8, budget=4, arrival=now)
        gold = _req(pkg, 501, "gold", plen=8, budget=4, arrival=now)
        ladder = (levels, fe.submit(late, now), late.fail_reason,
                  late.retry_after_s, fe.submit(gold, now))
        for e in engines:
            e.reset()
        tenants = {"gold": pkg.TenantClass("gold", tier=1, weight=4.0),
                   "bulk": pkg.TenantClass("bulk", tier=0, weight=1.0,
                                           rate_tokens_s=8.0,
                                           burst_tokens=40.0)}
        fe = pkg.ClusterFrontend(engines, tenants=tenants,
                                 breaker=pkg.CircuitBreaker())
        reqs = [_req(pkg, i, "gold" if i % 3 == 0 else "bulk", plen=10,
                     budget=6, arrival=0.5 * i) for i in range(15)]
        resolved = _drive(fe, reqs)
        return ladder, _obs(resolved), _tenant_obs(fe)

    jax_obs, torch_obs = _cluster(setup, pools, scenario)
    assert torch_obs == jax_obs
    ladder, resolved, (_, tenants, _) = torch_obs
    assert ladder[1] is False and ladder[4] is True
    assert ladder[2].startswith("rejected: cluster overloaded")
    rejected = [o for o in resolved.values() if o[0] == "failed"]
    assert rejected and all(0 < o[3] < math.inf for o in rejected)
    assert all(o[0] == "finished" for rid, o in resolved.items()
               if rid % 3 == 0)


def test_tenant_stats_and_single_tenant_path_match_jax(setup, pools):
    """test_cluster_tenant_stats_on_wire and
    test_cluster_single_tenant_path_unchanged."""

    def scenario(pkg, engines):
        fe = pkg.ClusterFrontend(engines, tenants=_tenants(pkg))
        resolved = _drive(fe, [_req(pkg, i, "gold", plen=8, budget=4,
                                    slo=30.0) for i in range(3)])
        wire = [e.load_report().tenant_stats for e in fe.engines]
        stats = (_obs(resolved), wire)
        for e in engines:
            e.reset()
        fe = pkg.ClusterFrontend(engines[:1])
        resolved = _drive(fe, [_req(pkg, i, plen=8, budget=6)
                               for i in range(4)])
        return stats, _obs(resolved), fe.merged_metrics().tenants

    jax_obs, torch_obs = _cluster(setup, pools, scenario)
    assert torch_obs[0] == jax_obs[0] and torch_obs[1] == jax_obs[1]
    assert torch_obs[2] == {} == jax_obs[2]


@settings(max_examples=3, deadline=None)
@given(seed=st.integers(0, 2**16))
def test_brownout_prefix_property_matches_jax(setup, pools, seed):
    """test_brownout_stream_is_bit_identical_prefix on both packages: a
    trimmed budget serves the first ``cap`` tokens of the untrimmed
    stream, and the port's streams equal the reference's."""
    rng = np.random.default_rng(seed)
    shapes = [(int(rng.integers(4, 25)), int(rng.integers(4, 13)),
               int(rng.integers(0, 2**16)))
              for _ in range(int(rng.integers(2, 5)))]
    frac = float(rng.uniform(0.25, 0.9))
    caps = [max(1, int(budget * frac)) for _, budget, _ in shapes]

    def serve(pkg, cfg, eng, shapes):
        eng.reset()
        reqs = []
        for rid, (plen, budget, pseed) in enumerate(shapes):
            prompt = np.random.default_rng(pseed).integers(
                0, cfg.vocab_size, plen).astype(np.int32)
            r = pkg.Request(rid, prompt, max_new_tokens=budget)
            eng.submit(r, 0.0)
            reqs.append(r)
        now = 0.0
        while any(r.finish_time < 0 for r in reqs):
            now += 1.0
            eng.step(now)
            assert now < 500
        return [list(map(int, r.output)) for r in reqs]

    got = {}
    for w in ("jax", "torch"):
        pkg, cfg = setup[w][:2]
        eng = pools[w][0]
        full = serve(pkg, cfg, eng, shapes)
        clamped = serve(pkg, cfg, eng, [(p, cap, s) for (p, _, s), cap
                                        in zip(shapes, caps)])
        for out, ref, cap in zip(clamped, full, caps):
            assert out == ref[:cap]
        got[w] = (full, clamped)
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("knob", ["sample_n", "ring"])
def test_trace_sampling_and_ring_match_jax(setup, knob):
    """test_trace_sampling_every_nth_rid and test_trace_ring_bounded."""
    kw = dict(trace_sample_n=3) if knob == "sample_n" else dict(trace_ring=2)
    n = 6 if knob == "sample_n" else 5
    got = {}
    for w, (pkg, cfg, p, x) in setup.items():
        eng = pkg.ServingEngine(cfg, p, pkg.EngineConfig(
            tracing=True, **ENGINE, **kw), **x)
        reqs = [_req(pkg, i, plen=8, budget=4) for i in range(n)]
        for r in reqs:
            eng.submit(r, 0.0)
        now = 0.0
        while any(r.finish_time < 0 for r in reqs):
            now += 1.0
            eng.step(now)
            assert now < 300
        ring = eng.tracer.ring
        seen = ({r.rid for r in reqs if r.trace is not None},
                eng.tracer.collected,
                None if ring is None else sorted(t.rid for t in ring))
        eng.reset()
        got[w] = seen + (None if eng.tracer.ring is None
                         else len(eng.tracer.ring),)
    assert got["torch"] == got["jax"]
    if knob == "sample_n":
        assert got["torch"][:2] == ({0, 3}, 2)
    else:
        assert got["torch"][1] == 5 and len(got["torch"][2]) == 2
    for bad in (dict(trace_sample_n=0), dict(trace_ring=-1)):
        with pytest.raises(ValueError):
            ts.EngineConfig(**bad)
