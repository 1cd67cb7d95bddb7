"""The PyTorch port's fault injection (``repro_torch.serving.faults``) and the
cluster frontend's failover against the JAX package's, on granite-8b
``reduced()`` with two kv heads, float32, the same converted weights, both
packages' engines priced at the reference's chip constants.

Each test replays a sequence of the reference suite
(``tests/test_faults.py``) on both packages on a virtual clock: the proxy's
transparency (reads and writes forward, so the frontend's
``edf_backlog`` write reaches the port's engine), the injector's schedule,
a kill mid-workload, a hang caught by the watchdog, a slow replica that is
not declared dead, an idle hung replica, an exhausted retry budget and
retry backoff. Compared: the step at which each replica is declared dead,
``failed_over``, the retries, states, fail reasons, and the streams, which
must equal the failure-free run's."""
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
ENGINE = dict(slots=2, window=64, max_seq=128, sync_every=1)


class Side:
    def __init__(self, pkg, cfg, params, extra):
        self.pkg, self.cfg, self.params, self.extra = pkg, cfg, params, extra
        self._pool = []

    def engines(self, n):
        """``n`` replicas, reused across tests (reset) to keep their
        compiled steps warm; each call hands out distinct engines."""
        while len(self._pool) < n:
            self._pool.append(self.pkg.ServingEngine(
                self.cfg, self.params, self.pkg.EngineConfig(**ENGINE),
                **self.extra))
        out = self._pool[:n]
        for e in out:
            e.reset()
            e.edf_backlog = False
        return out

    def workload(self, n, budget=5):
        """Seeded requests (stochastic streams: the strong replay claim)."""
        return [self.pkg.Request(
            i, _prompt(10 + i % 5, seed=i), max_new_tokens=budget,
            sampling=self.pkg.SamplingParams(temperature=0.7, top_k=20,
                                             top_p=0.95, seed=500 + i))
            for i in range(n)]


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


def _prompt(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 500, n).astype(np.int32)


def _drive(fe, reqs, *, fault_at=None, max_steps=500):
    """Submit everything at t=0, fire faults at virtual times, collect
    every resolved request; also the step at which each replica died."""
    resolved, t, deaths = {}, 0.0, {}
    for r in reqs:
        fe.submit(r, 0.0)
    while len(resolved) < len(reqs):
        t += 1.0
        if fault_at and t in fault_at:
            fault_at.pop(t)()
        for r in fe.step(t):
            resolved[r.rid] = r
        for inst in fe.failed:
            deaths.setdefault(inst.name, t)
        assert t < max_steps, f"{len(resolved)}/{len(reqs)} resolved"
    for r in fe.drain(t):
        resolved[r.rid] = r
    return resolved, deaths


def _obs(resolved):
    return {rid: (list(map(int, r.output)), r.state.value, r.retries,
                  r.routed_to, r.fail_reason, r.finish_time)
            for rid, r in sorted(resolved.items())}


def _cluster_obs(fe):
    m = fe.merged_metrics()
    return (m.failed_over, m.retried, m.failed, m.completed,
            [i.name for i in fe.failed], [i.name for i in fe.instances])


def _reference(side, n):
    fe = side.pkg.ClusterFrontend(side.engines(1), policy="round-robin",
                                  seed=0)
    resolved, _ = _drive(fe, side.workload(n))
    return {rid: list(map(int, r.output)) for rid, r in resolved.items()}


def _both(setup, scenario):
    return [scenario(setup[w]) for w in ("jax", "torch")]


def test_proxy_is_transparent_like_jax(setup):
    """test_faulty_engine_is_transparent: reads and writes forward (the
    frontend's ``edf_backlog`` write reaches the port's engine, whose
    backlog drain reads the attribute), kill raises, recover heals."""

    def scenario(side):
        eng = side.engines(1)[0]
        proxy = side.pkg.FaultyEngine(eng)
        seen = [proxy.slots == eng.slots, proxy.engine is eng]
        proxy.edf_backlog = True
        seen.append(eng.edf_backlog)
        req = side.pkg.Request(0, _prompt(8), max_new_tokens=2)
        seen.append(proxy.submit(req, 0.0))
        t = 0.0
        while not req.done:
            t += 1.0
            proxy.step(t)
        proxy.inject("kill")
        for call in (lambda: proxy.step(t + 1.0),
                     lambda: proxy.submit(side.pkg.Request(
                         1, _prompt(8, seed=1), 2), t + 1.0)):
            with pytest.raises(side.pkg.EngineFailure):
                call()
        proxy.inject("recover")
        proxy.step(t + 2.0)
        with pytest.raises(ValueError, match="unknown fault kind"):
            proxy.inject("meteor")
        return seen, list(map(int, req.output)), t

    jax_obs, torch_obs = _both(setup, scenario)
    assert torch_obs == jax_obs
    assert torch_obs[0] == [True, True, True, True]


def test_injector_schedule_matches_jax(setup):
    def scenario(side):
        proxy = side.pkg.FaultyEngine(side.engines(1)[0])
        inj = side.pkg.FaultInjector({"e0": proxy})
        inj.schedule(5.0, "e0", "hang")
        inj.schedule(2.0, "e0", "slow", slow_every=3)
        with pytest.raises(KeyError, match="no proxy"):
            inj.schedule(1.0, "nope", "kill")
        with pytest.raises(ValueError, match="unknown fault kind"):
            inj.schedule(1.0, "e0", "meteor")
        seen = [inj.tick(1.0), proxy.mode, inj.tick(2.0), proxy.mode,
                proxy.slow_every, inj.tick(10.0), proxy.mode, inj.pending]
        return seen, inj.fired

    jax_obs, torch_obs = _both(setup, scenario)
    assert torch_obs == jax_obs
    assert torch_obs[1] == [(2.0, "e0", "slow"), (5.0, "e0", "hang")]


@pytest.mark.parametrize("kind", ["kill", "hang", "slow"])
def test_fault_failover_matches_jax(setup, kind):
    """test_kill_fails_over_bit_identical, test_hang_detected_by_watchdog
    and test_slow_replica_is_not_declared_dead: the same death step, the
    same ledger replayed, the failure-free streams."""
    n = 8 if kind == "kill" else 6
    health = 0.0 if kind == "kill" else 4.0

    def scenario(side):
        reference = _reference(side, n)
        proxies = [side.pkg.FaultyEngine(e) for e in side.engines(2)]
        fe = side.pkg.ClusterFrontend(proxies, policy="round-robin", seed=0,
                                      health_timeout_s=health, max_retries=3)
        arm = ((lambda: proxies[0].inject("slow", slow_every=3))
               if kind == "slow" else (lambda: proxies[0].inject(kind)))
        resolved, deaths = _drive(fe, side.workload(n), fault_at={2.0: arm})
        assert {rid: list(map(int, r.output))
                for rid, r in resolved.items()} == reference
        survivor = fe.instances[0].engine
        return (_obs(resolved), deaths, _cluster_obs(fe),
                survivor.allocator.pages_in_use,
                survivor.allocator.total_refs)

    jax_obs, torch_obs = _both(setup, scenario)
    assert torch_obs == jax_obs
    _, deaths, (failed_over, *_), pages, refs = torch_obs
    if kind == "slow":
        assert deaths == {} and failed_over == 0
    else:
        assert list(deaths) == ["pool/e0"] and failed_over > 0
        assert (pages, refs) == (0, 0)


def test_idle_hung_replica_matches_jax(setup):
    """test_idle_hung_replica_stays_healthy_until_it_holds_work."""

    def scenario(side):
        e0, e1 = side.engines(2)
        proxies = [side.pkg.FaultyEngine(e0)]
        fe = side.pkg.ClusterFrontend(proxies, policy="round-robin", seed=0,
                                      health_timeout_s=3.0, max_retries=3)
        proxies[0].inject("hang")
        for t in range(1, 8):
            fe.step(float(t))
        idle = (len(fe.failed), len(fe.instances))
        req = side.pkg.Request(0, _prompt(8), max_new_tokens=2)
        fe.submit(req, 8.0)
        died = None
        for t in range(9, 20):
            fe.step(float(t))
            if fe.failed:
                died = t
                break
        retries = req.retries
        fe.add_engine(e1)
        t = 20.0
        while not req.done:
            t += 1.0
            fe.step(t)
            assert t < 100
        return idle, died, retries, _obs({0: req})

    jax_obs, torch_obs = _both(setup, scenario)
    assert torch_obs == jax_obs
    assert torch_obs[0] == (0, 1) and torch_obs[2] == 1


def test_retry_budget_and_backoff_match_jax(setup):
    """test_retry_budget_exhaustion_resolves_failed and
    test_retry_backoff_delays_resubmission."""

    def scenario(side):
        proxies = [side.pkg.FaultyEngine(side.engines(1)[0])]
        fe = side.pkg.ClusterFrontend(proxies, policy="round-robin", seed=0,
                                      max_retries=0)
        reqs = side.workload(3)
        for r in reqs:
            fe.submit(r, 0.0)
        fe.step(0.0)
        proxies[0].inject("kill")
        resolved = {}
        for t in range(1, 10):
            for r in fe.step(float(t)):
                resolved[r.rid] = r
            if len(resolved) == 3:
                break
        budget = (_obs(resolved), _cluster_obs(fe))

        proxies = [side.pkg.FaultyEngine(e) for e in side.engines(2)]
        fe = side.pkg.ClusterFrontend(proxies, policy="round-robin", seed=0,
                                      max_retries=3, retry_backoff_s=4.0)
        reqs = side.workload(4)
        for r in reqs:
            fe.submit(r, 0.0)
        fe.step(0.0)
        proxies[0].inject("kill")
        fe.step(1.0)
        held = sorted(r.rid for r in reqs if r.retries == 1 and not r.done)
        release = [t for t, _, _ in fe._held_retries]
        resolved = {}
        for t in range(2, 60):
            for r in fe.step(float(t)):
                resolved[r.rid] = r
            if len(resolved) == 4:
                break
        return budget, held, release, _obs(resolved), _cluster_obs(fe)

    jax_obs, torch_obs = _both(setup, scenario)
    assert torch_obs == jax_obs
    budget, held, release, resolved, _ = torch_obs
    assert all(o[1] == "failed" and "retry budget exhausted" in o[4]
               for o in budget[0].values())
    assert held and all(t >= 5.0 for t in release)
    assert all(resolved[rid][5] >= 5.0 for rid in held)
