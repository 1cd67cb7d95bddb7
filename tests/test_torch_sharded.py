"""Tensor- and expert-parallel sharded serving of the port: one replica
over N shards (``EngineConfig(topology=DeviceTopology(tp=N))``, the
shards on ``device=["cpu"] * N``) must give the streams of the port's
one-card engine and of the JAX package's one-chip engine, token for
token, greedy and seeded: the twins of ``tests/test_sharded.py`` (whose
tp=8 engine needs 8 forced XLA devices; its contract is equality with
its tp=1 engine), plus the layouts the reference's test does not reach.
Reduced float32 configs with pinned heads as there; weights from
``repro.models.init_params`` through ``params_from_jax``; both packages
at the reference's chip constants for chunk interleave.

Cases: paged pools, the prefix cache, rolling caches and int8 KV pages
split on kv heads (8/8 heads at tp 8); chatglm3's 2 kv heads at tp 4
(pools split on head_dim, its half RoPE); 6 q heads over 3 kv heads at
tp 4 (q, k and v columns split mid-head, query heads that do not group
evenly on a shard); grok's experts split on the expert axis (tp 8) and
on ff (tp 4) under "strict"; the trace probes; preempt / restore with
every page back; ``load_report``'s axis fields; the strict default;
each shard's leaves laid out by ``serving_policy``'s specs;
``validate()`` on every serving arch over a (2, 2) grid and its refusal
of sharded int8 weights; ``--tp`` and ``--dp`` through the serve CLI;
the sharded DLRM lookup against ``repro.core.simd.dlrm_forward``. The
data axis and the sharded hybrid and SSD blocks have their own files
(``test_torch_dp.py``, ``test_torch_sharded_hybrid.py``)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import models as jm
from repro import serving as js
from repro.configs import get_config as jax_config
from repro.core.hardware import TPU_V5E
from repro.core.misd.scheduler import ChunkedPrefillPolicy as JaxPolicy
from repro.core.simd import embedding as jemb
from repro_torch import models as tm
from repro_torch import serving as ts
from repro_torch.configs import get_config as torch_config
from repro_torch.core.hardware import Chip
from repro_torch.core.misd.scheduler import ChunkedPrefillPolicy
from repro_torch.core.simd import embedding as temb
from repro_torch.core.simd import sharding as tsh
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.tree import flatten

torch.set_num_threads(2)

NDEV = 8
TPU = Chip(**dataclasses.asdict(TPU_V5E))
CHUNK = 16
PART = bool(jax.config.jax_threefry_partitionable)


def _pair(name, **kw):
    jc = dataclasses.replace(jax_config(name).reduced(), **kw)
    tc = dataclasses.replace(torch_config(name).reduced(), **kw)
    jp = jm.init_params(jc, jax.random.key(0))
    return jc, tc, jp, tm.params_from_jax(tc, jax.tree.map(np.asarray, jp),
                                          "cpu")


@pytest.fixture(scope="module")
def dense():
    """8 kv heads so the pools' kv-head axis splits 8 ways."""
    return _pair("granite-8b", num_heads=NDEV, num_kv_heads=NDEV)


@pytest.fixture(scope="module")
def moe():
    return _pair("grok-1-314b", num_heads=NDEV, num_kv_heads=NDEV,
                 num_experts=NDEV, moe_expert_parallel=True)


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, 500, n).astype(np.int32)


def _workload(pkg, n, *, max_new=6, long=False):
    """Greedy and seeded-stochastic streams interleaved; ``long``: prompt
    0 of 8 tokens, the others a shared 32-token prefix and 25-59 tokens
    of their own (57-91 in all: chunks of 16, and prefix hits once the
    first of them is cached)."""
    def prompt(i):
        if not long:
            return _prompt(8 + 2 * i, seed=i)
        own = _prompt(8 + 17 * i, seed=i)
        return own if i == 0 else np.concatenate([_prompt(32, seed=99),
                                                  own])
    return [pkg.Request(rid=i, prompt=prompt(i), max_new_tokens=max_new,
                        sampling=(pkg.SamplingParams() if i % 2 == 0 else
                                  pkg.SamplingParams(temperature=0.8,
                                                     top_k=40, seed=100 + i)))
            for i in range(n)]


def _serve(eng, reqs, t0=0.0):
    t = t0
    for r in reqs:
        eng.submit(r, t)
    while not all(r.done for r in reqs):
        t += 1.0
        eng.step(t)
    eng.drain(t + 1.0)
    return [tuple(r.output) for r in reqs]


def _engine(pkg, cfg, params, tp=1, **kw):
    if pkg is js:
        return js.ServingEngine(cfg, params, js.EngineConfig(
            slots=2, window=128, prefill_policy=JaxPolicy(chunk=CHUNK),
            **kw))
    return ts.ServingEngine(cfg, params, ts.EngineConfig(
        slots=2, window=128, topology=ts.DeviceTopology(tp=tp),
        prefill_policy=ChunkedPrefillPolicy(chunk=CHUNK, chip=TPU), **kw),
        device=["cpu"] * tp, threefry_partitionable=PART)


def _three_way(setup, tp, n=4, max_new=6, long=False, **kw):
    """Streams of the JAX engine, the port's one-card engine and its tp
    engine; returns them with the two port engines."""
    jc, tc, jp, tp_params = setup
    jkw = {k: (js.PrecisionConfig(**dataclasses.asdict(v))
               if k == "precision" else v) for k, v in kw.items()}
    want = _serve(_engine(js, jc, jp, **jkw),
                  _workload(js, n, max_new=max_new, long=long))
    base = _engine(ts, tc, tp_params, **kw)
    shard = _engine(ts, tc, tp_params, tp, **kw)
    got1 = _serve(base, _workload(ts, n, max_new=max_new, long=long))
    gotn = _serve(shard, _workload(ts, n, max_new=max_new, long=long))
    return want, got1, gotn, base, shard


# ---------------------------------------------------------------------------
# streams: the sharded-replica contract
# ---------------------------------------------------------------------------

_PATHS = {"paged": dict(paged=True), "prefix_cache": dict(prefix_cache=True),
          "rolling": dict(paged=False),
          "int8": dict(precision=ts.PrecisionConfig(kv_cache_dtype="int8"))}


@pytest.mark.parametrize("path", list(_PATHS))
def test_sharded_streams_bit_identical(dense, path):
    """tp 8 over kv-head-split pools (or rings): chunked prompts, and on
    the prefix path hits of a shared 32-token prefix."""
    want, got1, gotn, base, shard = _three_way(dense, NDEV, long=True,
                                               **_PATHS[path])
    assert shard.mesh is not None and base.mesh is None
    assert gotn == got1 == want  # not close: EQUAL, token for token
    assert shard.metrics.prefill_chunks == base.metrics.prefill_chunks > 0
    if path == "prefix_cache":
        assert shard.metrics.prefix_hits == base.metrics.prefix_hits > 0
    if path != "rolling":
        assert shard.allocator.pages_in_use == base.allocator.pages_in_use


def test_sharded_trace_parity(dense):
    """Tensor parallelism does not multiply the step keys: the sharded
    engine counts the one-card engine's prefill and decode traces."""
    _, tc, _, tp = dense
    base, shard = _engine(ts, tc, tp), _engine(ts, tc, tp, NDEV)
    _serve(base, _workload(ts, 4, long=True))
    _serve(shard, _workload(ts, 4, long=True))
    assert (shard.prefill_traces, shard.decode_traces) \
        == (base.prefill_traces, base.decode_traces)
    assert shard.compile_events == base.compile_events


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_head_dim_split_pools_chatglm3(int8):
    """chatglm3's 2 kv heads at tp 4: pools (and the chunk buffer) split on
    head_dim, each shard gathering the head_dim blocks of the kv head its
    query heads read; int8 scales stay whole."""
    setup = _pair("chatglm3-6b", num_kv_heads=2)
    kw = (dict(precision=ts.PrecisionConfig(kv_cache_dtype="int8"))
          if int8 else {})
    want, got1, gotn, _, shard = _three_way(setup, 4, long=True, **kw)
    assert gotn == got1 == want
    hd = setup[1].resolved_head_dim
    for c in shard.cache:
        assert c["layers"][0]["k"].shape[2:] == (2, hd // 4)
        if int8:
            assert c["layers"][0]["k_scale"].shape[2:] == (2, 1)


def test_columns_split_mid_head():
    """6 query heads over 3 kv heads at tp 4: wq, wk and wv split into
    blocks of 1.5 heads, so each shard gathers whole heads; shard 1's
    query heads 1 and 2 read kv heads 0 and 1 (no even grouping)."""
    setup = _pair("granite-8b", num_heads=6, num_kv_heads=3)
    want, got1, gotn, _, shard = _three_way(setup, 4, long=True)
    assert gotn == got1 == want
    hd = setup[1].resolved_head_dim
    assert shard.params[0]["layers"][0]["attn"]["wq"].shape[1] == 6 * hd // 4


# ---------------------------------------------------------------------------
# MoE: expert parallel and ff-split experts under "strict"
# ---------------------------------------------------------------------------


def test_sharded_moe_expert_parallel_bit_identical(moe):
    """Expert-parallel MoE under the strict capacity policy (the sharded
    MoE default), pinned on every engine so capacity dims match: the
    experts' outputs concatenated on the expert axis, the combine whole."""
    want, got1, gotn, _, shard = _three_way(moe, NDEV, n=3, max_new=5,
                                            moe_capacity_policy="strict")
    assert shard.moe_capacity_policy == "strict"
    assert gotn == got1 == want
    assert shard.params[0]["layers"][0]["moe"]["w_up"].shape[0] == 1


def test_sharded_moe_ff_split_bit_identical():
    """grok-like experts split on ff (no expert parallelism) at tp 4: each
    shard its block of every expert's hidden, gathered for the whole
    ``w_down``."""
    setup = _pair("grok-1-314b", num_heads=4, num_kv_heads=4)
    want, got1, gotn, _, shard = _three_way(setup, 4, n=3, max_new=5,
                                            moe_capacity_policy="strict")
    assert gotn == got1 == want
    moe_p = shard.params[1]["layers"][0]["moe"]
    ff = setup[1].d_ff
    assert moe_p["w_up"].shape[2] == ff // 4
    assert moe_p["w_down"].shape[1] == ff


def test_sharded_moe_strict_is_default(moe):
    _, tc, _, tp = moe
    eng = ts.ServingEngine(tc, tp, ts.EngineConfig(
        slots=2, window=64, topology=ts.DeviceTopology(tp=NDEV)),
        device=["cpu"] * NDEV)
    assert eng.moe_capacity_policy == "strict"


# ---------------------------------------------------------------------------
# preemption over sharded paged pools
# ---------------------------------------------------------------------------


def test_sharded_preempt_restore_exact_and_pages_drain(dense):
    """Host-side page tables are layout-identical under sharding: the
    restored stream equals an undisturbed sharded run and the one-card
    engine's, and no page leaks."""
    _, tc, _, tp = dense
    kw = dict(slots=1, window=64, max_seq=64, sync_every=1, chunk_prefill=0,
              topology=ts.DeviceTopology(tp=NDEV))
    samp = ts.SamplingParams(temperature=0.7, top_k=20, top_p=0.95, seed=77)
    grid = ["cpu"] * NDEV

    ref_eng = ts.ServingEngine(tc, tp, ts.EngineConfig(**kw), device=grid)
    ref = ts.Request(0, _prompt(20), max_new_tokens=10, sampling=samp)
    assert ref_eng.try_admit(ref, 0.0)
    _serve(ref_eng, [ref], t0=0.0)
    one = ts.ServingEngine(tc, tp, ts.EngineConfig(**dict(
        kw, topology=ts.DeviceTopology())), device="cpu")
    ref1 = ts.Request(0, _prompt(20), max_new_tokens=10, sampling=samp)
    _serve(one, [ref1])

    eng = ts.ServingEngine(tc, tp, ts.EngineConfig(**kw, preemption=True),
                           device=grid)
    victim = ts.Request(0, _prompt(20), max_new_tokens=10, sampling=samp,
                        ttft_slo_s=100.0)
    assert eng.try_admit(victim, 0.0)
    for t in (1.0, 2.0, 3.0):
        eng.step(t)
    assert len(victim.output) >= 2  # mid-decode when the preemptor lands
    hot = ts.Request(1, _prompt(10, seed=9), max_new_tokens=3, priority=1,
                     ttft_slo_s=1.0)
    eng.submit(hot, 3.0)
    t = 3.0
    while not (victim.done and hot.done):
        t += 1.0
        eng.step(t)
    eng.drain(t + 1.0)
    assert victim.preemptions >= 1
    assert list(victim.output) == list(ref.output) == list(ref1.output)
    assert eng.allocator.pages_in_use == 0
    assert eng.allocator.total_refs == 0
    assert all(int(c["page_table"].abs().sum()) == 0 for c in eng.cache)


# ---------------------------------------------------------------------------
# telemetry, layout, refusals
# ---------------------------------------------------------------------------


def test_sharded_load_report_axis_fields(dense):
    _, tc, _, tp = dense
    shard = _engine(ts, tc, tp, NDEV)
    rep = shard.load_report()
    assert rep.n_chips == NDEV
    assert dict(rep.mesh_axes) == {"data": 1, "model": NDEV}
    cs = dict(rep.axis_collective_s)
    assert cs["model"] > 0.0 and cs["data"] == 0.0
    util = dict(rep.axis_util)
    assert 0.0 < util["model"] < 1.0
    assert ts.LoadReport.from_dict(rep.to_dict()) == rep
    one = _engine(ts, tc, tp).load_report()
    assert one.n_chips == 1 and dict(one.axis_collective_s) == {}


def _split(shape, spec, n):
    return tuple(s // n if e == "model" else s for s, e in zip(shape, spec))


def _flat_specs(specs, prefix=""):
    """{path: Spec} of a spec tree (a ``Spec`` is a tuple, which
    ``flatten`` would walk into)."""
    if isinstance(specs, tsh.Spec):
        return {prefix: specs}
    items = specs.items() if isinstance(specs, dict) else enumerate(specs)
    out = {}
    for k, v in items:
        out.update(_flat_specs(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


@pytest.mark.parametrize("name,tp,kw", [
    ("granite-8b", 4, dict(num_heads=8, num_kv_heads=8)),
    ("chatglm3-6b", 4, dict(num_kv_heads=2)),
    ("llama4-maverick-400b-a17b", 4, dict(num_experts=4)),
], ids=["granite", "chatglm3", "llama4"])
def test_each_shards_leaves_follow_serving_policy(name, tp, kw):
    """Every shard's param and cache leaf has the shape its spec gives
    (split dims divided by tp, the rest whole) and lies on its device;
    only _COL outputs, the vocab and MoE expert or ff dims split, and no
    _ROW weight does."""
    tc = dataclasses.replace(torch_config(name).reduced(), **kw)
    params = tm.init_params(tc, 0, "cpu")
    for paged in (True, False):
        eng = ts.ServingEngine(tc, params, ts.EngineConfig(
            slots=2, window=64, paged=paged,
            topology=ts.DeviceTopology(tp=tp)), device=["cpu"] * tp)
        mesh, pol = eng.mesh, tsh.serving_policy(tc, eng.mesh)
        pspecs = _flat_specs(tsh.param_pspecs(tc, params, pol))
        meta = (tm.init_paged_cache(tc, eng.slots, eng.pool_pages,
                                    eng.page_size, eng.max_pages,
                                    device="meta") if paged
                else tm.init_cache(tc, eng.slots, 64, device="meta"))
        cspecs = _flat_specs((tsh.paged_cache_pspecs if paged
                              else tsh.cache_pspecs)(tc, meta, pol, mesh))
        for j in range(tp):
            for tree, full, specs in ((eng.params[j], params, pspecs),
                                      (eng.cache[j], meta, cspecs)):
                got = dict(flatten(tree))
                for path, leaf in flatten(full):
                    assert tuple(got[path].shape) == _split(
                        leaf.shape, specs[path], tp), path
                    assert got[path].device == mesh.flat[j]
        assert sorted(p for p, s in pspecs.items() if "model" in s) == \
            sorted(p for p in pspecs if p.rsplit("/", 1)[-1] in (
                "wq", "wk", "wv", "w_gate", "w_up", "embed", "lm_head")
                or (p.endswith("moe/w_down") and tc.moe_expert_parallel))


def test_validate_refuses_what_the_slice_does_not_serve():
    """Given a grid, every serving arch validates at tp 4 and at dp 2 x
    tp 2, each on its default cache (rolling for recurrentgemma and
    mamba2) and on rolling caches (a data axis, and sharded hybrids and
    SSMs, are served since the data-axis slice), and sharded int8 weights
    are refused with the reference's own message."""
    dense_cfg = torch_config("granite-8b").reduced()
    grid = ["cpu"] * 4
    w8 = ts.PrecisionConfig(weight_dtype="int8")
    with pytest.raises(ValueError, match="is not supported on sharded "
                                         "replicas yet"):
        ts.EngineConfig(topology=ts.DeviceTopology(tp=2),
                        precision=w8).validate(dense_cfg, devices=grid[:2])
    with pytest.raises(ValueError, match="is not supported on sharded "
                                         "replicas yet"):
        ts.EngineConfig(topology=ts.DeviceTopology(dp=2),
                        precision=w8).validate(dense_cfg, devices=grid[:2])
    for name in ("granite-8b", "grok-1-314b", "qwen2-vl-7b", "chatglm3-6b",
                 "phi3-medium-14b", "starcoder2-15b",
                 "llama4-maverick-400b-a17b", "recurrentgemma-9b",
                 "mamba2-1.3b"):
        for paged in (None, False):
            for topo in (ts.DeviceTopology(tp=4),
                         ts.DeviceTopology(dp=2, tp=2)):
                ts.EngineConfig(paged=paged, topology=topo).validate(
                    torch_config(name), devices=grid)


def test_topology_beyond_the_host_is_refused_before_placement(dense):
    """No grid and more cards asked for than the host has: ``validate()``
    refuses, naming ``devices=``, as the engine does on the CPU without a
    grid; with the grid the same config validates."""
    _, tc, _, tp = dense
    need = torch.cuda.device_count() + 2
    config = ts.EngineConfig(topology=ts.DeviceTopology(tp=need))
    with pytest.raises(ValueError, match="devices="):
        config.validate(tc)
    with pytest.raises(ValueError, match="devices="):
        ts.ServingEngine(tc, tp, config)
    config.validate(tc, devices=["cpu"] * need)
    with pytest.raises(ValueError, match="device grid"):
        ts.ServingEngine(tc, tp, config, device="cpu")


def test_serve_cli_tp(capsys):
    """``--tp 4 --devices cpu,cpu,cpu,cpu`` serves one sharded replica
    whose streams equal ``--tp 1``'s; the banner prints the grid; ``--dp
    2 --devices cpu,cpu`` (a data axis) serves the same streams too."""
    common = ["--arch", "granite-8b", "--reduced", "--device", "cpu",
              "--requests", "3", "--slots", "2", "--rate", "1000",
              "--max-new", "4", "--temperature", "0.8", "--top-k", "20"]
    one = tserve.main(common)
    capsys.readouterr()
    four = tserve.main(common + ["--tp", "4", "--devices",
                                 "cpu,cpu,cpu,cpu"])
    out = capsys.readouterr().out
    assert "sharded replica: mesh {'data': 1, 'model': 4} over [cpu, cpu, " \
        "cpu, cpu]" in out
    assert [r.output for r in four] == [r.output for r in one]
    two = tserve.main(common + ["--dp", "2", "--devices", "cpu,cpu"])
    out = capsys.readouterr().out
    assert "sharded replica: mesh {'data': 2, 'model': 1}" in out
    assert [r.output for r in two] == [r.output for r in one]


def test_sharded_dlrm_lookup_matches_the_reference():
    """Tables row-split over 2 and 3 shards: the pooled partial sums added
    in shard order against the reference's ``dlrm_forward`` (one pooled
    sum per bag) within float32 rounding: 1e-5 relative to the logits'
    scale (their summands are the same rows, added in another order)."""
    cfg = dataclasses.replace(torch_config("dlrm"), num_tables=6,
                              rows_per_table=300, embed_dim=16,
                              bottom_mlp=(32, 16), top_mlp=(64, 32, 1),
                              multi_hot=3)
    jcfg = dataclasses.replace(jax_config("dlrm"), **{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    jp = jemb.init_dlrm(jcfg, jax.random.key(0))
    tp = tm.dlrm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(5)
    batch = {"dense": rng.standard_normal((32, 13)).astype(np.float32),
             "sparse": rng.integers(0, 300, (32, 6, 3)).astype(np.int32)}
    want = np.asarray(jemb.dlrm_forward(jcfg, jp, batch))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for n in (2, 3):
        mesh = make_local_mesh(model=n, devices=["cpu"] * n)
        shards = tsh.Shards(tsh.place(tp, temb.shard_specs(cfg), mesh), mesh)
        assert [tuple(s["tables"].shape) for s in shards] == [(6, 300 // n,
                                                               16)] * n
        got = temb.dlrm_forward(cfg, shards, tb).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        emb = temb.sharded_lookup([s["tables"] for s in shards],
                                  tb["sparse"])
        np.testing.assert_allclose(emb.numpy(), temb.lookup(
            tp["tables"], tb["sparse"]).numpy(), rtol=0, atol=1e-7)
