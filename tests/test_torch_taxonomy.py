"""The port's taxonomy against the JAX package's: the paradigm classifier,
the assigned input shapes, the cost model's ``estimate`` /
``estimate_train`` / ``model_flops`` on every shape of every ported arch
(``rel=1e-12`` at the same ``Chip``), the gpulet-style
``MeshPartitioner`` (same sizes, meshlets and assignment at the same
chip, and the second plan's reconfiguration cost), the SISD baseline's
simulator results, the Fig. 4 comparison chips; and the quickstart and
multi-tenant example twins run to their end on the CPU."""
import copy
import dataclasses

import numpy as np
import pytest

from repro import configs as jcfg
from repro import core as jcore
from repro.core import hardware as jhw
from repro.core import misd as jmisd
from repro.core import sisd as jsisd
from repro_torch import configs as tcfg
from repro_torch import core as tcore
from repro_torch.core import hardware as thw
from repro_torch.core import misd as tmisd
from repro_torch.core import sisd as tsisd
from repro_torch.examples import multi_tenant_serving, quickstart

REL = 1e-12
#: the reference's constants on the port's side, and the port's H100 on
#: the reference's, so each default is checked against the other package
TPU_AS_TORCH = thw.Chip(**dataclasses.asdict(jhw.TPU_V5E))
H100_AS_JAX = jhw.Chip(**dataclasses.asdict(thw.H100_SXM))
ARCHS = [a for a in tcfg.PORTED_ARCHS if a != "dlrm"]


def _estimates_equal(got, want):
    for name in ("flops", "hbm_bytes", "collective_bytes", "compute_s",
                 "memory_s", "collective_s", "latency_s"):
        assert getattr(got, name) == pytest.approx(getattr(want, name),
                                                   rel=REL, abs=0), name
    assert got.n_chips == want.n_chips
    assert got.bottleneck == want.bottleneck
    assert got.demand == pytest.approx(want.demand, rel=REL)
    assert got.demand_at(0.6) == pytest.approx(want.demand_at(0.6), rel=REL)


@pytest.mark.parametrize("n_instances,n_devices,quadrant", [
    (1, 1, "SISD"), (4, 1, "MISD"), (1, 256, "SIMD"), (8, 256, "MIMD"),
    (0, 0, "SISD")])
def test_classify_all_four_quadrants(n_instances, n_devices, quadrant):
    p = tcore.classify(n_instances, n_devices)
    assert p.name == quadrant
    assert p.value == jcore.classify(n_instances, n_devices).value
    dep = tcore.Deployment("granite-8b", n_instances, n_devices)
    assert dep.paradigm is p
    assert tcore.executor_for(p).startswith("repro_torch.")
    assert [q.value for q in tcore.Paradigm] == \
        [q.value for q in jcore.Paradigm]


def test_input_shapes_match_jax():
    assert {k: dataclasses.asdict(v) for k, v in tcfg.INPUT_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jcfg.INPUT_SHAPES.items()}
    for name in tcfg.INPUT_SHAPES:
        assert dataclasses.asdict(tcfg.get_shape(name)) == \
            dataclasses.asdict(jcfg.get_shape(name))
    for arch in ARCHS:
        for encoder in (False, True):
            tc = dataclasses.replace(tcfg.get_config(arch),
                                     is_encoder=encoder)
            jc = dataclasses.replace(jcfg.get_config(arch),
                                     is_encoder=encoder)
            got = [s.name for s in tcfg.applicable_shapes(tc)]
            assert got == [s.name for s in jcfg.applicable_shapes(jc)]
            assert ("decode_32k" in got) is not encoder


@pytest.mark.parametrize("arch", ARCHS)
def test_estimate_on_every_shape_matches_jax(arch):
    tc, jc = tcfg.get_config(arch), jcfg.get_config(arch)
    for shape in tcfg.INPUT_SHAPES:
        ts, js_ = tcfg.get_shape(shape), jcfg.get_shape(shape)
        assert tcore.model_flops(tc, ts) == pytest.approx(
            jcore.model_flops(jc, js_), rel=REL)
        for n in (1, 4, 256):
            _estimates_equal(
                tcore.estimate(tc, ts, chip=TPU_AS_TORCH, n_chips=n),
                jcore.estimate(jc, js_, n_chips=n))
            # the port's default chip is the H100
            _estimates_equal(tcore.estimate(tc, ts, n_chips=n),
                             jcore.estimate(jc, js_, chip=H100_AS_JAX,
                                            n_chips=n))
        for n, coll in ((1, 0.0), (8, 0.0), (8, 3e9)):
            _estimates_equal(
                tcore.estimate_train(tc, 4, 512, chip=TPU_AS_TORCH,
                                     n_chips=n, collective_bytes=coll),
                jcore.estimate_train(jc, 4, 512, n_chips=n,
                                     collective_bytes=coll))


def test_hardware_constants():
    assert thw.RECONFIG_COST_S == jhw.RECONFIG_COST_S == 5.0
    assert tcore.CHIPS["h100-sxm"] is thw.H100_SXM
    assert not any("tpu" in name for name in tcore.CHIPS)
    for name, chip in tcore.CHIPS.items():
        if name != "h100-sxm":
            assert dataclasses.asdict(chip) == \
                dataclasses.asdict(jhw.CHIPS[name])


TENANTS = [("chat", "chatglm3-6b", 16, 4096, 0.05),
           ("code", "granite-8b", 8, 8192, 0.08),
           ("vision", "qwen2-vl-7b", 8, 4096, 0.10),
           ("moe", "grok-1-314b", 4, 2048, 0.5, "prefill"),
           ("big", "llama4-maverick-400b-a17b", 32, 8192, 0.02)]


def _tenants(cfgs, rows):
    out = []
    for row in rows:
        name, arch, batch, context, sla = row[:5]
        t = {"name": name, "cfg": cfgs.get_config(arch), "batch": batch,
             "context": context, "sla_s": sla}
        if len(row) > 5:
            t["kind"] = row[5]
        out.append(t)
    return out


@pytest.mark.parametrize("pod", [(16, 16), (4, 8), (2, 2)])
def test_mesh_partitioner_matches_jax(pod):
    """At the reference's chip, the same sizes, meshlets and assignment
    (on a grid the asks overflow, too: the largest ask shrinks until the
    meshlets pack), and a second plan pays the reconfiguration; more
    tenants than cards are refused."""
    for rows in (TENANTS[:3], TENANTS):
        tp = tmisd.MeshPartitioner(pod, chip=TPU_AS_TORCH)
        jp = jmisd.MeshPartitioner(pod)
        if len(rows) > pod[0] * pod[1]:
            # more tenants than cards: both refuse (the reference with a
            # math domain error once an ask shrinks to 0 cards)
            for part, cfgs in ((tp, tcfg), (jp, jcfg)):
                with pytest.raises(ValueError):
                    part.plan(_tenants(cfgs, rows))
            continue
        for t, j in zip(_tenants(tcfg, rows), _tenants(jcfg, rows)):
            kw = dict(batch=t["batch"], context=t["context"],
                      sla_s=t["sla_s"], kind=t.get("kind", "decode"))
            assert tp.size_for_sla(t["cfg"], **kw) == \
                jp.size_for_sla(j["cfg"], **kw)
        for k in range(2):
            got = tp.plan(_tenants(tcfg, rows))
            want = jp.plan(_tenants(jcfg, rows))
            assert [dataclasses.asdict(m) for m in got.meshlets] == \
                [dataclasses.asdict(m) for m in want.meshlets]
            assert got.assignment == want.assignment
            assert got.reconfig_cost_s == want.reconfig_cost_s == \
                (5.0 if k else 0.0)
        assert [(d.name, d.max_tenants, d.speed) for d in tp.devices(3)] \
            == [(d.name, d.max_tenants, d.speed) for d in jp.devices(3)]
    # the port's default chip is the H100: one card holds granite's weights
    h100 = tmisd.MeshPartitioner()
    assert h100.chip is thw.H100_SXM and h100.pod_shape == (16, 16)
    assert h100.size_for_sla(tcfg.get_config("granite-8b"), batch=8,
                             context=8192, sla_s=0.08) == 1


def _jobs(pkg_misd, cfgs, costmodel, chip):
    rng = np.random.default_rng(0)
    tenants = _tenants(cfgs, TENANTS[:3])
    jobs, t_arr = [], 0.0
    for i in range(120):
        ten = tenants[int(rng.integers(3))]
        est = costmodel.estimate_decode(ten["cfg"], 8, ten["context"],
                                        n_chips=64, chip=chip)
        t_arr += float(rng.exponential(est.latency_s / 2.5))
        jobs.append(pkg_misd.Job(i, ten["name"],
                                 est.demand_at(costmodel.stream_occupancy(8)),
                                 est.latency_s, arrival=t_arr,
                                 priority=5 if ten["name"] == "chat" else 0,
                                 sla_s=est.latency_s * 5))
    return jobs


def _results_equal(got, want):
    assert got.makespan == pytest.approx(want.makespan, rel=REL)
    assert got.qps == pytest.approx(want.qps, rel=REL)
    for name in ("mean_latency", "p99_latency", "mean_jct",
                 "sla_attainment", "mean_slowdown"):
        assert getattr(got, name)() == pytest.approx(
            getattr(want, name)(), rel=REL), name
    assert [(j.jid, j.device, j.preemptions) for j in got.completed] == \
        [(j.jid, j.device, j.preemptions) for j in want.completed]
    for a, b in zip(got.completed, want.completed):
        assert (a.start, a.finish) == pytest.approx((b.start, b.finish),
                                                    rel=REL)


def test_sisd_baseline_matches_jax():
    from repro.core import costmodel as jcm
    from repro_torch.core import costmodel as tcm

    tjobs = _jobs(tmisd, tcfg, tcm, TPU_AS_TORCH)
    jjobs = _jobs(jmisd, jcfg, jcm, jhw.TPU_V5E)
    assert tsisd.sisd_device().max_tenants == \
        jsisd.sisd_device().max_tenants == 1
    _results_equal(tsisd.run_single_tenant(copy.deepcopy(tjobs)),
                   jsisd.run_single_tenant(copy.deepcopy(jjobs)))
    for k, sched in ((2, None), (4, "sjf"), (3, "interference-aware")):
        _results_equal(
            tsisd.run_multi_tenant(
                copy.deepcopy(tjobs), k,
                tmisd.SCHEDULERS[sched]() if sched else None),
            jsisd.run_multi_tenant(
                copy.deepcopy(jjobs), k,
                jmisd.SCHEDULERS[sched]() if sched else None))


def test_quickstart_and_multi_tenant_twins_run(capsys):
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "SISD: served 3 requests, tokens=18" in out
    for quadrant in ("SISD", "MISD", "SIMD", "MIMD"):
        assert f"\n{quadrant}: I=" in out
    assert "decode_32k on 256 h100-sxm cards" in out
    multi_tenant_serving.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "meshlet plan (h100-sxm cards):" in out
    assert out.count(" qps=") == len(tmisd.SCHEDULERS)
