"""Tensor-parallel recurrentgemma-9b and mamba2-1.3b: the sharded
``rglru``, ``ssd`` and ``local_attn`` blocks under the reference's
bit-exact serving layout (``serving_policy``: the _COL projections
``w_gate_branch``, ``w_lin_branch``, ``w_a``, ``w_x`` and ``in_proj``
split by output column; ``w_out``, ``out_proj``, the conv windows and
the recurrent states whole on every shard; recurrentgemma's single kv
head leaves its rings whole). Each block over 2 and 4 shards on the CPU
must equal the one-card block bit for bit (only concatenation crosses
shards), and the engines' streams at tp 2 and 4 must equal the port's
one-device engine's and the JAX package's one-chip engine's, token for
token. Reduced float32 configs, weights from the reference's
``init_params`` through ``params_from_jax``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import models as jm
from repro import serving as js
from repro.configs import get_config as jax_config
from repro_torch import models as tm
from repro_torch import serving as ts
from repro_torch.configs import get_config as torch_config
from repro_torch.core.simd import sharding as tsh
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import layers as L
from repro_torch.models.blocks import apply_block, apply_block_sharded
from repro_torch.models.rglru import (
    apply_rglru_block,
    apply_rglru_block_sharded,
)
from repro_torch.models.ssm import apply_ssd, apply_ssd_sharded

torch.set_num_threads(2)

PART = bool(jax.config.jax_threefry_partitionable)


def _pair(name, **kw):
    jc = dataclasses.replace(jax_config(name).reduced(), **kw)
    tc = dataclasses.replace(torch_config(name).reduced(), **kw)
    jp = jm.init_params(jc, jax.random.key(0))
    return jc, tc, jp, tm.params_from_jax(tc, jax.tree.map(np.asarray, jp),
                                          "cpu")


@pytest.fixture(scope="module")
def hybrid():
    """5 layers: rglru, rglru, local_attn, then two rglru; 4 query heads
    over 1 kv head of 32, local window 64, RG-LRU width 256."""
    return _pair("recurrentgemma-9b", num_layers=5)


@pytest.fixture(scope="module")
def mamba():
    return _pair("mamba2-1.3b")


def _shards(cfg, params, tp):
    mesh = make_local_mesh(model=tp, devices=["cpu"] * tp)
    return tm.shard_params(cfg, params, mesh), mesh


def _x(cfg, b, s, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32))


def _cache_pair(cfg, bt, b, mesh):
    """A one-card block cache and the same cache laid out over ``mesh``
    by ``cache_pspecs``, both zeros."""
    one = tm.init_cache(cfg, b, 64, device="cpu")
    shards = tm.shard_cache(cfg, tm.init_cache(cfg, b, 64, device="meta"),
                            mesh, paged=False)
    i = tm.layer_types(cfg).index(bt)
    return one, [c["layers"][i] for c in shards], i


@pytest.mark.parametrize("tp", [2, 4])
def test_rglru_block_bit_equal(hybrid, tp):
    """A 40-token prefill into the conv window and state, then 3 decode
    steps: every shard's output, conv window and state equal the one-card
    block's, bit for bit."""
    _, tc, _, tparams = hybrid
    shards, mesh = _shards(tc, tparams, tp)
    one, caches, i = _cache_pair(tc, "rglru", 2, mesh)
    c1 = one["layers"][i]
    p1 = tparams["layers"][i]["mixer"]
    ps = [p["layers"][i]["mixer"] for p in shards]
    assert ps[0]["w_a"].shape[1] == tc.resolved_lru_width // tp
    assert ps[0]["w_out"].shape[0] == tc.resolved_lru_width
    for step, s in enumerate((40, 1, 1, 1)):
        x = _x(tc, 2, s, step)
        want = apply_rglru_block(tc, p1, x, cache=c1)
        got = apply_rglru_block_sharded(tc, ps, [x] * tp, caches=caches)
        for g, c in zip(got, caches):
            assert torch.equal(g, want)
            assert torch.equal(c["state"], c1["state"])
            assert torch.equal(c["conv"], c1["conv"])


@pytest.mark.parametrize("tp", [2, 4])
def test_ssd_mixer_bit_equal(mamba, tp):
    """in_proj's 1088 outputs split 2 and 4 ways (blocks that span the z
    / xBC / dt boundaries): a 40-token prefill, then 3 steps, equal the
    one-card mixer bit for bit on every shard."""
    _, tc, _, tparams = mamba
    shards, mesh = _shards(tc, tparams, tp)
    one, caches, i = _cache_pair(tc, "ssd", 2, mesh)
    p1 = tparams["layers"][i]["mixer"]
    ps = [p["layers"][i]["mixer"] for p in shards]
    in_dim = p1["in_proj"].shape[1]
    assert ps[0]["in_proj"].shape[1] == in_dim // tp
    assert ps[0]["out_proj"].shape == p1["out_proj"].shape
    for step, s in enumerate((40, 1, 1, 1)):
        x = _x(tc, 2, s, 10 + step)
        want = apply_ssd(tc, p1, x, cache=one["layers"][i])
        got = apply_ssd_sharded(tc, ps, [x] * tp, caches=caches)
        for g, c in zip(got, caches):
            assert torch.equal(g, want)
            assert torch.equal(c["state"], one["layers"][i]["state"])


@pytest.mark.parametrize("bt", ["rglru", "ssd"])
def test_shards_sharing_one_cache_step_once(hybrid, mamba, bt):
    """``shard_cache`` of a cache already on the grid's device gives the
    shards views of one conv window and state: every shard must read them
    before any shard writes, or the second shard steps the state twice.
    A prefill and 3 decode steps equal the one-card block's outputs and
    cache."""
    _, tc, _, tparams = hybrid if bt == "rglru" else mamba
    tp = 2
    shards, mesh = _shards(tc, tparams, tp)
    one = tm.init_cache(tc, 2, 64, device="cpu")
    shared = tm.shard_cache(tc, tm.init_cache(tc, 2, 64, device="cpu"),
                            mesh, paged=False)
    i = tm.layer_types(tc).index(bt)
    caches = [c["layers"][i] for c in shared]
    assert (caches[0]["state"].data_ptr()
            == caches[1]["state"].data_ptr())  # the hazard is there
    c1 = one["layers"][i]
    p1 = tparams["layers"][i]["mixer"]
    ps = [p["layers"][i]["mixer"] for p in shards]
    one_card, sharded = ((apply_rglru_block, apply_rglru_block_sharded)
                         if bt == "rglru" else (apply_ssd, apply_ssd_sharded))
    for step, s in enumerate((40, 1, 1, 1)):
        x = _x(tc, 2, s, 30 + step)
        want = one_card(tc, p1, x, cache=c1)
        got = sharded(tc, ps, [x] * tp, caches=caches)
        assert all(torch.equal(g, want) for g in got)
        assert torch.equal(caches[0]["state"], c1["state"])
        assert torch.equal(caches[0]["conv"], c1["conv"])


def test_local_attn_block_bit_equal(hybrid):
    """The local-attention block at tp 2 (2 query heads a shard, wk / wv
    split on head_dim, the whole kv head gathered before RoPE, the ring
    whole on every shard): a 100-token prefill over the 64-token window,
    then a decode step, equal the one-card block bit for bit."""
    _, tc, _, tparams = hybrid
    tp = 2
    shards, mesh = _shards(tc, tparams, tp)
    one, caches, i = _cache_pair(tc, "local_attn", 2, mesh)
    assert tm.layer_types(tc)[i] == "local_attn"
    assert caches[0]["k"].shape == one["layers"][i]["k"].shape
    p1 = tparams["layers"][i]
    ps = [p["layers"][i] for p in shards]
    x = _x(tc, 2, 100, 20)
    rope = L.rope_table(tc, torch.arange(100)[None].expand(2, 100))
    want, _, _ = apply_block(tc, "local_attn", p1, x, rope, mode="prefill",
                             cache=one["layers"][i])
    got, _ = apply_block_sharded(tc, "local_attn", ps, [x] * tp,
                                 [rope] * tp, mode="prefill",
                                 caches=caches)
    assert all(torch.equal(g, want) for g in got)
    pos = torch.full((2,), 100, dtype=torch.int32)
    x = _x(tc, 2, 1, 21)
    rope = L.rope_table(tc, pos.to(torch.int64)[:, None])
    want, _, _ = apply_block(tc, "local_attn", p1, x, rope, mode="decode",
                             cache=one["layers"][i], pos=pos)
    got, _ = apply_block_sharded(
        tc, "local_attn", ps, [x] * tp, [rope] * tp, mode="decode",
        caches=caches, poss=[pos] * tp, pagess=[None] * tp,
        write_ats=[None] * tp, n_valids=[(pos + 1).to(torch.int32)] * tp)
    assert all(torch.equal(g, want) for g in got)
    for c in caches:
        assert torch.equal(c["k"], one["layers"][i]["k"])


def _workload(pkg, n=4, max_new=8):
    rng = np.random.default_rng(5)
    return [pkg.Request(rid=i, prompt=rng.integers(0, 500, 10 + 11 * i)
                        .astype(np.int32), max_new_tokens=max_new,
                        sampling=(pkg.SamplingParams() if i % 2 == 0 else
                                  pkg.SamplingParams(temperature=0.8,
                                                     top_k=40, seed=50 + i)))
            for i in range(n)]


def _serve(eng, reqs):
    t = 0.0
    for r in reqs:
        eng.submit(r, t)
    while not all(r.done for r in reqs):
        t += 1.0
        eng.step(t)
    eng.drain(t + 1.0)
    return [tuple(r.output) for r in reqs]


@pytest.mark.parametrize("arch", ["recurrentgemma", "mamba2"])
def test_sharded_streams_equal_one_device_and_jax(hybrid, mamba, arch):
    """tp 2 and 4 on 2 slots, prompts of 10-43 tokens within the local
    window: greedy and seeded streams equal the port's one-device engine's
    and the JAX engine's; the trace probes too."""
    jc, tc, jp, tparams = hybrid if arch == "recurrentgemma" else mamba
    want = _serve(js.ServingEngine(jc, jp, js.EngineConfig(
        slots=2, window=128)), _workload(js))
    base = ts.ServingEngine(tc, tparams, ts.EngineConfig(
        slots=2, window=128), device="cpu", threefry_partitionable=PART)
    assert _serve(base, _workload(ts)) == want
    for tp in (2, 4):
        eng = ts.ServingEngine(tc, tparams, ts.EngineConfig(
            slots=2, window=128, topology=ts.DeviceTopology(tp=tp)),
            device=["cpu"] * tp, threefry_partitionable=PART)
        assert _serve(eng, _workload(ts)) == want  # EQUAL
        assert (eng.prefill_traces, eng.decode_traces) == (
            base.prefill_traces, base.decode_traces)


def test_each_shards_leaves_follow_serving_policy(hybrid, mamba):
    """Every shard's leaf has its spec's shape: the _COL weights split by
    output column, every other leaf (the _ROW weights, the conv weights,
    the gates' vectors, the states and conv windows) whole."""
    for _, tc, _, tparams in (hybrid, mamba):
        eng = ts.ServingEngine(tc, tparams, ts.EngineConfig(
            slots=2, window=64, topology=ts.DeviceTopology(tp=2)),
            device=["cpu"] * 2)
        pol = tsh.serving_policy(tc, eng.mesh)
        specs = tsh.param_pspecs(tc, tparams, pol)
        meta = tm.init_cache(tc, 2, 64, device="meta")
        for i, bt in enumerate(tm.layer_types(tc)):
            mixer = specs["layers"][i].get("mixer", {})
            for name, spec in mixer.items():
                split = "model" in spec
                assert split == (name in ("w_gate_branch", "w_lin_branch",
                                          "w_a", "w_x", "in_proj")), name
                got = eng.params[1]["layers"][i]["mixer"][name].shape
                want = tparams["layers"][i]["mixer"][name].shape
                assert got[-1] == (want[-1] // 2 if split else want[-1])
            for name, leaf in eng.cache[1]["layers"][i].items():
                assert leaf.shape == meta["layers"][i][name].shape, name
