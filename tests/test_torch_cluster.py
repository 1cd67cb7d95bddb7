"""The PyTorch port's cluster frontend (``repro_torch.serving.cluster``)
against the JAX package's, over the two packages' engines on granite-8b
``reduced()`` with two kv heads, float32, the same converted weights.

Both packages' engines are priced at the reference's chip constants (the
port's ``chip=`` is the TPU v5e's), so the ``predicted`` and
``least-loaded`` policies read the same telemetry. Each test replays
sequences of the reference suite (``tests/test_cluster.py``) on a virtual
clock, on both packages, and compares what it observes: the replica each
request is routed to, streams (greedy and seeded), terminal states,
``routed`` counts, pages freed on every engine, retire and drain, the
autoscale hooks, multi-model pools, EDF dispatch order, prefix-affinity
routing and the corrector's residuals (to 1e-9: the residual is a running
mean of quotients of cost-model seconds, the same operations on both
sides). Everything else must be equal."""
import dataclasses

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
POLICIES = ("round-robin", "least-loaded", "p2c", "predicted")
PAIR = dict(slots=2, window=64, max_seq=128, sync_every=4)


class Side:
    """One package: its engines and requests."""

    def __init__(self, pkg, cfg, params, extra):
        self.pkg, self.cfg, self.params, self.extra = pkg, cfg, params, extra

    def engine(self, **kw):
        return self.pkg.ServingEngine(self.cfg, self.params,
                                      self.pkg.EngineConfig(**kw),
                                      **self.extra)

    def request(self, rid, prompt, max_new, seed=None, **kw):
        sp = (self.pkg.SamplingParams(temperature=0.9, top_k=30, top_p=0.95,
                                      seed=seed)
              if seed is not None else self.pkg.SamplingParams())
        return self.pkg.Request(rid, np.asarray(prompt, np.int32),
                                max_new_tokens=max_new, sampling=sp, **kw)


@pytest.fixture(scope="module")
def setup():
    jc = dataclasses.replace(jax_config("granite-8b").reduced(),
                             num_kv_heads=2)
    tc = dataclasses.replace(torch_config("granite-8b").reduced(),
                             num_kv_heads=2)
    jp = jm.init_params(jc, jax.random.key(0))
    tp = tm.params_from_jax(tc, jax.tree.map(np.asarray, jp), "cpu")
    return {"jax": Side(js, jc, jp, {}),
            "torch": Side(ts, tc, tp, dict(
                device="cpu", chip=TPU, threefry_partitionable=bool(
                    jax.config.jax_threefry_partitionable)))}


@pytest.fixture(scope="module")
def pairs(setup):
    """Two replicas per package, shared (and reset) across tests so their
    compiled steps stay warm."""
    return {w: [setup[w].engine(**PAIR) for _ in range(2)]
            for w in ("jax", "torch")}


def _prompt(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 500, n).astype(np.int32)


def _drive(server, reqs, *, t0=0.0, dt=1.0, max_steps=5000):
    done, t = 0, t0
    for r in reqs:
        server.submit(r, t)
    while done < len(reqs):
        t += dt
        done += len(server.step(t))
        assert t - t0 < max_steps * dt
    server.drain(t)
    return t


def _obs(reqs):
    """Per rid: replica, stream, state, first-token and finish times."""
    return {r.rid: (r.routed_to, list(map(int, r.output)), r.state.value,
                    r.prefill_done, r.finish_time, r.prefix_hit_tokens)
            for r in reqs}


def _fe_obs(fe):
    return {"routed": {i.name: i.routed for i in fe.instances},
            "util": fe.utilization(),
            "pages": [(i.engine.allocator.pages_in_use,
                       i.engine.allocator.free_pages)
                      for i in fe.instances + fe.draining + fe.retired],
            "metrics": _metrics(fe.merged_metrics())}


def _metrics(m):
    return (m.completed, m.total_tokens, m.rejected, m.retried,
            m.failed_over, m.failed, m.sampled_requests, m.slo_tracked,
            m.slo_met, m.decode_ticks, m.host_syncs, m.prefill_chunks)


def _both(setup, pairs, scenario):
    """The scenario's observations on the JAX package and on the port;
    each side's shared pair is reset first."""
    out = []
    for which in ("jax", "torch"):
        for eng in pairs[which]:
            eng.reset()
        out.append(scenario(setup[which], pairs[which]))
    return out


def _reqs(side, n, plen, budget, seeded=False, **kw):
    return [side.request(i, _prompt(plen(i), seed=i), budget,
                         seed=(40 + i if seeded and i % 2 else None), **kw)
            for i in range(n)]


@pytest.mark.parametrize("seeded", [False, True], ids=["greedy", "seeded"])
@pytest.mark.parametrize("policy", POLICIES)
def test_streams_and_routes_match_jax(setup, pairs, policy, seeded):
    """test_cluster_streams_bit_identical_to_single_engine and
    test_cluster_sampled_streams_stable_under_routing, under every policy:
    the same replica per request, the same streams, equal to one engine's
    streams, every page back on both replicas."""

    def scenario(side, engines):
        ref = _reqs(side, 6, lambda i: 10 + 7 * i, 5, seeded,
                    arrival_time=0.0, ttft_slo_s=50.0)
        _drive(engines[0], ref)
        single = {r.rid: list(map(int, r.output)) for r in ref}
        engines[0].reset()
        fe = side.pkg.ClusterFrontend(engines, policy=policy, seed=1)
        reqs = _reqs(side, 6, lambda i: 10 + 7 * i, 5, seeded,
                     arrival_time=0.0, ttft_slo_s=50.0)
        _drive(fe, reqs)
        assert {r.rid: list(map(int, r.output)) for r in reqs} == single
        assert all(e.decode_traces <= 2 for e in engines)
        return _obs(reqs), _fe_obs(fe)

    jax_obs, torch_obs = _both(setup, pairs, scenario)
    assert torch_obs == jax_obs
    assert all(p == (0, free) for p, free in zip(
        torch_obs[1]["pages"], (e.allocator.capacity
                                for e in pairs["torch"])))


@pytest.mark.parametrize("policy", ["least-loaded", "predicted"])
def test_trickled_arrivals_route_like_jax(setup, pairs, policy):
    """test_cluster_releases_pages_on_every_engine with arrivals one a
    step, so the telemetry-reading policies decide on live load."""

    def scenario(side, engines):
        fe = side.pkg.ClusterFrontend(engines, policy=policy, seed=0)
        reqs = _reqs(side, 10, lambda i: 12 + 5 * i, 4, seeded=True)
        t, done, pending = 0.0, 0, list(reqs)
        while done < len(reqs):
            if pending:
                fe.submit(pending.pop(0), t)
            t += 1.0
            done += len(fe.step(t))
            assert t < 500
        fe.drain(t)
        reports = [i.engine.load_report().to_dict() for i in fe.instances]
        return _obs(reqs), _fe_obs(fe), reports

    jax_obs, torch_obs = _both(setup, pairs, scenario)
    assert torch_obs[:2] == jax_obs[:2]
    # the wire reports, cost-model seconds included (same chip constants)
    for got, want in zip(torch_obs[2], jax_obs[2]):
        want = {k: v for k, v in want.items()
                if k not in ("moe_capacity_policy", "moe_drop_free_group")}
        got = {k: v for k, v in got.items() if k in want}
        assert got == want


def test_retire_and_drain_match_jax(setup, pairs):
    """test_cluster_retire_drains_without_new_routes and
    test_cluster_retire_requeues_unstarted_backlog."""

    def scenario(side, engines):
        fe = side.pkg.ClusterFrontend(engines, policy="round-robin", seed=0)
        first = [side.request(i, _prompt(10, seed=i), 6) for i in range(2)]
        for r in first:
            fe.submit(r, 0.0)
        fe.step(1.0)
        victim = fe.retire(first[0].routed_to)
        late = [side.request(10 + i, _prompt(9, seed=10 + i), 3)
                for i in range(3)]
        t = 1.0
        for r in late:
            fe.submit(r, t)
        while not all(r.done for r in first + late):
            t += 1.0
            fe.step(t)
        fe.drain(t)
        fe.step(t + 1.0)
        part1 = (_obs(first + late), victim.name, victim.draining,
                 len(fe.draining), victim.engine.allocator.pages_in_use)
        for eng in engines:
            eng.reset()
        fe = side.pkg.ClusterFrontend(engines[:1], policy="round-robin",
                                      seed=0)
        reqs = [side.request(i, _prompt(10 + i, seed=i), 4)
                for i in range(6)]
        for r in reqs:
            fe.submit(r, 0.0)
        fe.step(1.0)
        started = sorted(r.rid for r in reqs if r.prefill_done >= 0)
        fe.add_engine(engines[1])
        victim = fe.retire(fe.instances[0].name)
        left = (len(victim.engine.backlog),
                len(victim.engine.admission.pending))
        t = 1.0
        while not all(r.done for r in reqs):
            t += 1.0
            fe.step(t)
            assert t < 200
        fe.drain(t)
        return part1, started, left, _obs(reqs), _fe_obs(fe)

    jax_obs, torch_obs = _both(setup, pairs, scenario)
    assert torch_obs == jax_obs
    assert torch_obs[2] == (0, 0)


def test_autoscale_and_emptied_pool_match_jax(setup, pairs):
    """test_cluster_autoscale_hooks and
    test_cluster_emptied_pool_holds_queue_until_replica_returns."""

    def scenario(side, engines):
        fe = side.pkg.ClusterFrontend(engines[:1], policy="predicted",
                                      seed=0)
        reqs = [side.request(i, _prompt(16, seed=i), 12) for i in range(6)]
        for r in reqs:
            fe.submit(r, 0.0)
        fe.step(1.0)
        queue_s = fe.instances[0].queue_s
        grown = fe.autoscale(1.0, spawn=lambda: engines[1], high_s=1e-9)
        t = 1.0
        while not all(r.done for r in reqs):
            t += 1.0
            fe.step(t)
        fe.drain(t)
        shrunk = fe.autoscale(t, low_s=1.0)
        fe.step(t + 1.0)
        part1 = (queue_s, grown.name, shrunk.name, len(fe.instances),
                 len(fe.draining), _obs(reqs))
        for eng in engines:
            eng.reset()
        fe = side.pkg.ClusterFrontend(engines[:1], policy="predicted",
                                      seed=0)
        req = side.request(0, _prompt(10), 3, arrival_time=0.0)
        fe.submit(req, 0.0)
        fe.retire(fe.instances[0].name)
        fe.step(1.0)
        held = (req.routed_to, len(fe._queue))
        fe.add_engine(engines[1])
        t = 1.0
        while not req.done:
            t += 1.0
            fe.step(t)
        fe.drain(t)
        return part1, held, _obs([req])

    jax_obs, torch_obs = _both(setup, pairs, scenario)
    assert torch_obs == jax_obs
    assert torch_obs[0][0] > 0 and torch_obs[1] == ("", 1)


def test_multi_model_pools_and_edf_order_match_jax(setup, pairs):
    """test_cluster_multi_model_pools and
    test_cluster_edf_frontend_dispatch_order."""

    def scenario(side, engines):
        fe = side.pkg.ClusterFrontend({"chat": engines[:1],
                                       "code": engines[1:]},
                                      policy="predicted", seed=0)
        chat = [side.request(i, _prompt(10, seed=i), 3, model="chat")
                for i in range(2)]
        code = [side.request(10 + i, _prompt(14, seed=9 + i), 3,
                             model="code") for i in range(2)]
        _drive(fe, chat + code)
        stray = side.request(99, _prompt(8), 2, model="missing")
        accepted = fe.submit(stray, 0.0)
        surfaced = stray in fe.step(0.0)
        pools = (_obs(chat + code), accepted, stray.state.value,
                 stray.fail_reason, surfaced,
                 fe.merged_metrics().rejected)
        for eng in engines:
            eng.reset()
        fe = side.pkg.ClusterFrontend(engines[:1], policy="round-robin",
                                      seed=0)
        reqs = [side.request(rid, _prompt(8, seed=seed), 2,
                             arrival_time=0.0, ttft_slo_s=slo)
                for rid, seed, slo in ((0, 1, 90.0), (2, 3, 30.0),
                                       (1, 2, 1.0))]
        for r in reqs:
            fe.submit(r, 0.0)
        t = 0.0
        while not all(r.done for r in reqs):
            t += 1.0
            fe.step(t)
        fe.drain(t)
        return pools, _obs(reqs)

    jax_obs, torch_obs = _both(setup, pairs, scenario)
    assert torch_obs == jax_obs
    order = torch_obs[1]
    assert order[1][3] <= order[2][3] <= order[0][3]


def test_heterogeneous_pool_matches_jax(setup):
    """test_heterogeneous_pool_routes_more_to_bigger_replica: a modeled
    4-card replica beside a 1-card one (trickled arrivals)."""

    def scenario(side, _):
        engines = [side.engine(modeled_chips=c, **PAIR) for c in (1, 4)]
        fe = side.pkg.ClusterFrontend(engines, policy="predicted", seed=0)
        reqs = [side.request(i, _prompt(12 + (i % 5), seed=i), 6)
                for i in range(12)]
        t, done, pending = 0.0, 0, list(reqs)
        while done < len(reqs):
            if pending:
                fe.submit(pending.pop(0), t)
            t += 1.0
            done += len(fe.step(t))
            assert t < 5000
        fe.drain(t)
        return _obs(reqs), _fe_obs(fe), [i.device.speed
                                         for i in fe.instances]

    jax_obs, torch_obs = [scenario(setup[w], None) for w in ("jax", "torch")]
    assert torch_obs == jax_obs
    routed = torch_obs[1]["routed"]
    assert routed["pool/e1"] > routed["pool/e0"]


def test_prefix_affinity_matches_jax(setup):
    """test_prefix_affinity_routes_template_to_warm_replica: template
    traffic lands on the replica that holds its pages, and hits there."""

    def scenario(side, _):
        engines = [side.engine(prefix_cache=True, **PAIR) for _ in range(2)]
        fe = side.pkg.ClusterFrontend(engines, policy="predicted", seed=0)
        tpl = _prompt(48, seed=40)
        primer = side.request(0, tpl.copy(), 1)
        assert engines[1].try_admit(primer, 0.0)
        engines[1].drain(0.0)
        follow = [side.request(1 + i, np.concatenate(
            [tpl, _prompt(4 + i, seed=41 + i)]), 2) for i in range(4)]
        t = 1000.0
        for r in follow:
            t = _drive(fe, [r], t0=t) + 1.0
        stranger = side.request(99, _prompt(20, seed=77), 2)
        job = fe._job_for(stranger, t)
        home = fe.instances[1]
        probes = (home.prefix_hit_s(job), home.service_s(job),
                  fe.instances[0].service_s(job))
        return _obs(follow), probes, [
            (e.allocator.pages_in_use, e.prefix_index.cached_pages)
            for e in engines]

    jax_obs, torch_obs = [scenario(setup[w], None) for w in ("jax", "torch")]
    assert torch_obs[0] == jax_obs[0] and torch_obs[2] == jax_obs[2]
    assert torch_obs[1] == pytest.approx(jax_obs[1], rel=1e-12)
    assert all(o[0] == "pool/e1" and o[5] == 48
               for o in torch_obs[0].values())


def test_closed_loop_residuals_match_jax(setup, pairs):
    """test_cluster_closed_loop_observes on the cost model's tick scale:
    the same observations reach each replica's corrector, whose state
    agrees to 1e-9."""

    def scenario(side, engines):
        fe = side.pkg.ClusterFrontend(engines, policy="predicted", seed=0)
        dt = engines[0].load_report().tick_est_s
        reqs = [side.request(i, _prompt(10 + i, seed=i), 6,
                             seed=(60 + i if i % 2 else None),
                             arrival_time=0.0, ttft_slo_s=1000 * dt)
                for i in range(6)]
        _drive(fe, reqs, dt=dt)
        corr = [(i.corrector._n, i.corrector.correction,
                 i.corrector.residuals.count,
                 i.corrector.corrected_latency(dt))
                for i in fe.instances]
        return dt, _obs(reqs), _fe_obs(fe), corr

    jax_obs, torch_obs = _both(setup, pairs, scenario)
    assert torch_obs[0] == jax_obs[0]
    assert torch_obs[1:3] == jax_obs[1:3]
    assert sum(c[0] for c in torch_obs[3]) > 0
    for got, want in zip(torch_obs[3], jax_obs[3]):
        assert got[0] == want[0] and got[2] == want[2]
        assert got[1] == pytest.approx(want[1], abs=1e-9)
        assert got[3] == pytest.approx(want[3], abs=1e-9)


@pytest.mark.parametrize("weight_dtype", ["", "int8"])
def test_replicas_share_weights(setup, weight_dtype):
    """A replica built from the first engine's ``params`` holds the very
    same tensors (the bf16 head's float32 copy and int8 leaves are kept,
    not made again), and serves the streams a replica with weights of its
    own serves."""
    side = setup["torch"]
    cfg = dataclasses.replace(side.cfg, dtype="bfloat16")
    params = tm.init_params(cfg, seed=0, device="cpu")
    config = ts.EngineConfig(precision=ts.PrecisionConfig(
        weight_dtype=weight_dtype), **PAIR)
    first = ts.ServingEngine(cfg, params, config, **side.extra)
    shared = ts.ServingEngine(cfg, first.params, config, **side.extra)
    own = ts.ServingEngine(cfg, params, config, **side.extra)

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        if isinstance(tree, list):
            return [x for v in tree for x in leaves(v)]
        return [tree]

    assert "lm_head_f32" in first.params
    assert all(a is b for a, b in zip(leaves(first.params),
                                      leaves(shared.params)))
    assert shared.params["lm_head_f32"] is first.params["lm_head_f32"]
    assert own.params["lm_head_f32"] is not first.params["lm_head_f32"]
    if weight_dtype:
        w = first.params["layers"][0]["mlp"]
        assert isinstance(next(iter(w.values())), dict)
        assert all(shared.params["layers"][0]["mlp"][k] is w[k] for k in w)
    streams = []
    for eng in (shared, own):
        reqs = _reqs(side, 4, lambda i: 9 + 5 * i, 4, seeded=True)
        _drive(eng, reqs)
        streams.append([r.output for r in reqs])
    assert streams[0] == streams[1]


def test_serve_cli_cluster_tenants_trace_and_metrics(tmp_path, capsys):
    """The serve CLI's cluster path on the CPU: two replicas built from
    one set of weights, a Chrome trace that validates, the metrics
    exposition and its snapshot; then tenants with an over-rate bulk
    class under the overload ladder, whose rejections are typed with a
    finite retry horizon."""
    import json
    import math

    from repro_torch.launch import serve as tserve

    trace, prom = tmp_path / "t.json", tmp_path / "m.prom"
    reqs = tserve.main([
        "--arch", "granite-8b", "--reduced", "--device", "cpu",
        "--requests", "8", "--slots", "2", "--rate", "1000", "--max-new",
        "5", "--replicas", "2", "--route-policy", "predicted",
        "--ttft-slo-ms", "60000", "--trace-out", str(trace),
        "--metrics-out", str(prom)])
    out = capsys.readouterr().out
    assert "cluster frontend: 2 replicas, policy=predicted" in out
    assert "pool/e0: routed=" in out and "pool/e1: routed=" in out
    assert "SLO goodput=1.000" in out
    assert all(len(r.output) == 5 and r.routed_to for r in reqs)
    assert ts.validate_chrome_trace(json.loads(trace.read_text())) == []
    assert "cluster_completed_total 8" in prom.read_text()
    assert json.loads((tmp_path / "m.prom.json").read_text())[
        "cluster_completed_total"] == 8
    reqs = tserve.main([
        "--arch", "granite-8b", "--reduced", "--device", "cpu",
        "--requests", "12", "--slots", "2", "--rate", "1000", "--max-new",
        "6", "--tenants", "gold=1:4,bulk=0:1:64:128", "--overload",
        "--ttft-slo-ms", "2000", "--trace-sample-n", "2"])
    out = capsys.readouterr().out
    assert "tenant gold:" in out and "tenant bulk:" in out
    rejected = [r for r in reqs if r.state.value == "failed"]
    assert rejected and all(r.tenant == "bulk" for r in rejected)
    assert all(0 < r.retry_after_s < math.inf for r in rejected)
    assert all(r.state.value == "finished" for r in reqs
               if r.tenant == "gold")


def test_dropped_replicas_free_without_the_garbage_collector(setup):
    """Engines and a frontend that served traced traffic form no reference
    cycle: dropping them frees their device memory at once, not at the
    garbage collector's next pass (a script that drops one model's
    replicas before loading the next depends on it)."""
    import gc
    import weakref

    side = setup["torch"]
    gc.collect()
    gc.disable()
    try:
        engines = [side.engine(tracing=True, **PAIR) for _ in range(2)]
        fe = ts.ClusterFrontend(
            engines, tenants={"gold": ts.TenantClass("gold")}, tracing=True,
            breaker=ts.CircuitBreaker())
        _drive(fe, _reqs(side, 3, lambda i: 9 + i, 3, tenant="gold"))
        refs = [weakref.ref(x) for x in (*engines, fe, engines[0].graphs)]
        del engines, fe
        assert [r() is None for r in refs] == [True] * len(refs)
    finally:
        gc.enable()
