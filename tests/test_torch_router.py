"""The PyTorch port's MIMD router (``repro_torch.core.mimd.router``) and the
cost-model terms the cluster frontend prices with, against the JAX
package's, operation by operation and with no engine.

The router: every policy of ``POLICIES`` over the same instances, jobs and
seed routes to the same instance names, through the sequences of the
reference suite (``tests/test_simd_mimd.py``'s router tests and
``tests/test_overload.py``'s router satellites): balance under drain,
autoscale signals, deregistration, a one-replica p2c pool, p2c under a
permanent tie, the predicted policy, chip-weighted pressure and the
eligibility filter. Both packages draw from ``random.Random(seed)``, so
p2c and least-loaded draw in the same order. The cost model:
``estimate_prefill`` with a prefix hit and a mesh, ``estimate_decode``
with a window and a mesh, ``estimate_backlog_s`` and
``suggest_health_timeout_s``, at the reference's chip constants, to
``rel=1e-12`` (the same formulas in the same order; the bound leaves room
for nothing but the last bit)."""
import dataclasses

import pytest

from repro.configs import get_config as jax_config
from repro.core import costmodel as jcm
from repro.core.hardware import TPU_V5E
from repro.core.mimd import router as jr
from repro.core.misd import scheduler as jsch
from repro_torch.configs import get_config as torch_config
from repro_torch.core import costmodel as tcm
from repro_torch.core.hardware import Chip
from repro_torch.core.mimd import router as tr
from repro_torch.core.misd import scheduler as tsch

TPU = Chip(**dataclasses.asdict(TPU_V5E))
SIDES = {"jax": (jr, jsch), "torch": (tr, tsch)}


def _router(which, policy, n=4, seed=0):
    r, sch = SIDES[which]
    router = r.ServiceRouter(policy=policy, seed=seed)
    for i in range(n):
        router.register(r.Instance(f"i{i}", "m", sch.Device(f"d{i}", 4)))
    return router


def _both(scenario):
    """The scenario's observations on the JAX package and on the port."""
    return [scenario(*SIDES[which], which) for which in ("jax", "torch")]


def test_policies_are_the_reference_policies():
    assert tr.POLICIES == jr.POLICIES


@pytest.mark.parametrize("policy", jr.POLICIES)
def test_balanced_routing_matches_jax(policy):
    """test_router_balances: 400 jobs routed and drained; every choice."""

    def scenario(r, sch, which):
        router = _router(which, policy)
        names = []
        for i in range(400):
            inst = router.route(sch.Job(i, "m", (0.5, 0.5), 0.01))
            names.append(inst.name)
            for pool in router.pools.values():
                for it in pool:
                    router.drain(it, 0.01)
        return names

    jax_names, torch_names = _both(scenario)
    assert torch_names == jax_names
    # a drained pool is an exact tie: predicted keeps registration order
    assert len(set(torch_names)) == (1 if policy == "predicted" else 4)


@pytest.mark.parametrize("policy", jr.POLICIES)
def test_uneven_service_routing_matches_jax(policy):
    """Jobs of uneven service time on replicas of uneven speed and load,
    with partial drains: the policies' scores differ per replica, so the
    routes test the scoring, not only the tie-breaks."""

    def scenario(r, sch, which):
        router = r.ServiceRouter(policy=policy, seed=11)
        for i, speed in enumerate((1.0, 2.0, 0.5, 4.0, 1.0)):
            inst = router.register(r.Instance(
                f"i{i}", "m", sch.Device(f"d{i}", 4, speed=speed)))
            inst.queue_s = 0.1 * i
        names = []
        for i in range(300):
            job = sch.Job(i, "m", (0.5, 0.5), 0.003 * (1 + i % 7))
            names.append(router.route(job).name)
            if i % 3 == 0:
                for it in router.pools["m"]:
                    router.drain(it, 0.004)
        return names, [round(i.queue_s, 12) for i in router.pools["m"]]

    jax_obs, torch_obs = _both(scenario)
    assert torch_obs == jax_obs


def test_autoscale_signals_match_jax():
    """test_router_autoscale_signals, with the pressure read each step."""

    def scenario(r, sch, which):
        router = _router(which, "least-loaded")
        seen = [router.want_scale("m")]
        for i in range(200):
            router.route(sch.Job(i, "m", (0.5, 0.5), 0.5))
            if i % 20 == 0:
                seen.append((router.want_scale("m"), router.pressure("m")))
        seen.append(router.want_scale("m"))
        seen.append(router.route(sch.Job(0, "unknown", (0.5, 0.5), 0.01)))
        return seen

    jax_obs, torch_obs = _both(scenario)
    assert torch_obs == jax_obs
    assert torch_obs[-2] == 1 and torch_obs[-1] is None


@pytest.mark.parametrize("policy", ["round-robin", "least-loaded", "p2c"])
def test_deregister_and_reregister_match_jax(policy):
    """test_router_deregister_stops_routes under every rotating policy."""

    def scenario(r, sch, which):
        router = _router(which, policy)
        gone = router.deregister("i2")
        first = [router.route(sch.Job(i, "m", (0.5, 0.5), 0.01)).name
                 for i in range(30)]
        absent = (router.deregister("i2"),
                  router.deregister("i0", model="never-registered"))
        router.register(gone)
        second = [router.route(sch.Job(i, "m", (0.5, 0.5), 0.01)).name
                  for i in range(40)]
        return gone.name, gone.draining, first, absent, second

    jax_obs, torch_obs = _both(scenario)
    assert torch_obs == jax_obs
    assert set(torch_obs[2]) == {"i0", "i1", "i3"} and "i2" in torch_obs[4]


def test_p2c_single_instance_pool_matches_jax():
    def scenario(r, sch, which):
        router = _router(which, "p2c")
        for name in ("i1", "i2", "i3"):
            router.deregister(name)
        return [router.route(sch.Job(i, "m", (0.5, 0.5), 0.01)).name
                for i in range(5)]

    jax_obs, torch_obs = _both(scenario)
    assert torch_obs == jax_obs == ["i0"] * 5


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_p2c_under_a_permanent_tie_matches_jax(seed):
    """test_router_p2c_deterministic_under_seed: the seeded sample order
    is the tie-break, so the port draws what the reference draws."""

    def scenario(r, sch, which):
        router = _router(which, "p2c", seed=seed)
        out = []
        for i in range(80):
            inst = router.route(sch.Job(i, "m", (0.5, 0.5), 0.01))
            out.append(inst.name)
            inst.queue_s = 0.0
        return out

    jax_obs, torch_obs = _both(scenario)
    assert torch_obs == jax_obs
    assert set(torch_obs) == {"i0", "i1", "i2", "i3"}


def test_predicted_policy_matches_jax():
    def scenario(r, sch, which):
        router = r.ServiceRouter(policy="predicted", seed=0)
        for i in range(4):
            inst = router.register(r.Instance(f"i{i}", "m",
                                              sch.Device(f"d{i}", 4)))
            inst.queue_s = 3.0 - 0.5 * i
        return [router.route(sch.Job(j, "m", (0.5, 0.5), 0.01 * j)).name
                for j in range(12)]

    jax_obs, torch_obs = _both(scenario)
    assert torch_obs == jax_obs
    assert torch_obs[0] == "i3"


def test_pressure_and_eligibility_match_jax():
    """test_overload.py's router satellites: pressure per chip, not per
    replica, and the eligibility filter beating the load."""

    def scenario(r, sch, which):
        big = r.ServiceRouter()
        big.register(r.Instance("tp8", "m", sch.Device("d0", speed=8.0),
                                queue_s=8.0))
        one = r.ServiceRouter()
        one.register(r.Instance("one", "m", sch.Device("d1", speed=1.0),
                                queue_s=8.0))
        el = r.ServiceRouter(policy="least-loaded")
        el.register(r.Instance("a", "m", sch.Device("da"), queue_s=0.0))
        el.register(r.Instance("b", "m", sch.Device("db"), queue_s=5.0))
        job = sch.Job(jid=0, model="m", demand=1, service_s=1.0, arrival=0.0)
        return (big.pressure("m"), big.want_scale("m", high_s=2.0),
                one.want_scale("m", high_s=2.0),
                el.route(job, eligible={"b"}).name,
                el.route(job, eligible=set()), el.route(job).name)

    jax_obs, torch_obs = _both(scenario)
    assert torch_obs == jax_obs == (1.0, 0, 1, "b", None, "a")


# -- the cost model's new terms ---------------------------------------------


@pytest.fixture(scope="module")
def configs():
    out = []
    for name, reduced in (("granite-8b", False), ("granite-8b", True),
                          ("recurrentgemma-9b", False),
                          ("recurrentgemma-9b", True)):
        jc, tc = jax_config(name), torch_config(name)
        if reduced:
            jc, tc = jc.reduced(), tc.reduced()
        assert tc.param_count() == jc.param_count()
        out.append((jc, tc))
    return out


def _close(a, b):
    return a == pytest.approx(b, rel=1e-12, abs=0.0)


MESHES = [None, (("data", 1), ("model", 1)), (("data", 2), ("model", 4)),
          (("model", 8),)]


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_prefill_with_prefix_hit_and_mesh_matches_jax(configs, mesh):
    for jc, tc in configs:
        for batch, seq, hit in ((1, 64, 0), (1, 512, 48), (4, 300, 299),
                                (2, 100, 100), (1, 2048, 1024)):
            kw = dict(prefix_hit=hit, mesh_axes=mesh)
            want = jcm.estimate_prefill(jc, batch, seq, **kw)
            got = tcm.estimate_prefill(tc, batch, seq, chip=TPU, **kw)
            for attr in ("flops", "hbm_bytes", "collective_bytes",
                         "latency_s"):
                assert _close(getattr(got, attr), getattr(want, attr)), \
                    (tc.name, batch, seq, hit, mesh, attr)
            assert got.n_chips == want.n_chips
            assert got.bottleneck == want.bottleneck
            assert got.demand == pytest.approx(want.demand, rel=1e-12)


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_decode_with_window_and_mesh_matches_jax(configs, mesh):
    for jc, tc in configs:
        for batch, ctx, window in ((1, 128, 0), (8, 1024, 0),
                                   (8, 5000, 2048), (3, 64, 256)):
            kw = dict(window=window, mesh_axes=mesh)
            want = jcm.estimate_decode(jc, batch, ctx, **kw)
            got = tcm.estimate_decode(tc, batch, ctx, chip=TPU, **kw)
            for attr in ("flops", "hbm_bytes", "collective_bytes",
                         "latency_s"):
                assert _close(getattr(got, attr), getattr(want, attr)), \
                    (tc.name, batch, ctx, window, mesh, attr)


def test_backlog_and_health_timeout_match_jax(configs):
    for jc, tc in configs:
        for q, d, slots, ctx, mesh in ((0, 0, 2, 128, None),
                                       (64, 32, 2, 128, None),
                                       (600, 320, 8, 1024, None),
                                       (600, 320, 8, 1024,
                                        (("data", 2), ("model", 2)))):
            kw = dict(queued_prefill_tokens=q, decode_tokens_remaining=d,
                      slots=slots, context=ctx, mesh_axes=mesh)
            assert _close(tcm.estimate_backlog_s(tc, chip=TPU, **kw),
                          jcm.estimate_backlog_s(jc, **kw))
        for slots, ctx, n_chips, ticks in ((2, 64, 1, 8), (8, 1024, 1, 8),
                                           (8, 1024, 4, 3), (0, 256, 1, 0)):
            kw = dict(slots=slots, context=ctx, n_chips=n_chips,
                      ticks=ticks)
            assert _close(tcm.suggest_health_timeout_s(tc, chip=TPU, **kw),
                          jcm.suggest_health_timeout_s(jc, **kw))


def test_defaults_price_the_h100_and_keep_earlier_numbers(configs):
    """With no new argument every estimate is what it was: one H100, no
    collective term, the prefill and decode bytes unchanged."""
    _, tc = configs[0]
    pre = tcm.estimate_prefill(tc, 1, 512)
    assert pre.chip.name == "h100-sxm" and pre.collective_bytes == 0.0
    wb = 2
    assert pre.hbm_bytes == tc.param_count() * wb + 12.0 * 512 * tc.d_model * wb
    assert tcm.estimate_prefill(tc, 1, 512, mesh_axes=None) == pre
    dec = tcm.estimate_decode(tc, 8, 1024)
    assert dec.collective_s == 0.0
    assert dec.latency_s == max(dec.compute_s, dec.memory_s) + 45e-6
    assert tcm.suggest_health_timeout_s(tc, slots=8, context=1024) == \
        8 * dec.latency_s
