"""The PyTorch port's MoE block family against the JAX package's:
grok-1-314b (8 experts, top-2, GeGLU) and llama4-maverick-400b-a17b (128
experts, top-1, a shared expert, MoE every other layer), each
``reduced()`` (4 experts), float32, on the same converted weights.

Compared: the configs and their parameter counts; ``apply_moe`` (outputs
and the aux loss within 2e-5, the reference suite's float32 tolerance;
the routed choices kept, token by token, identical) at capacity factors
8.0 (never binding) and 1.0 (binding: tokens drop), top-2 and top-1, with
and without the shared expert, at full capacity, over one group and
several; ``_capacity``, ``drop_free_group`` and ``resolved_moe_policy``;
the cost model's MoE terms (``rel=1e-12``); and the reference's engine
checks of the capacity policies (``tests/test_engine_config.py``):
backpressure clamps the slots and rejects with "drop-free", strict serves
the same prompt, a dense arch ignores the policy, the ``load_report``
fields. The JAX side's kept choices are read by a probe on
``jax.nn.one_hot`` (the reference builds each round's slot one-hot from
the slots it assigns), with nothing in the JAX package changed."""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro import serving as js
from repro.configs import get_config as jax_config
from repro.core import costmodel as jcm
from repro.core.hardware import TPU_V5E
from repro.launch import serve as jserve
from repro.models import moe as jmoe
from repro.serving import config as jsc
from repro_torch import models as tm
from repro_torch import serving as ts
from repro_torch.configs import get_config as torch_config
from repro_torch.configs import reference_view
from repro_torch.core import costmodel as tcm
from repro_torch.core.hardware import Chip
from repro_torch.launch import serve as tserve
from repro_torch.models import moe as tmoe

torch.set_num_threads(2)
TOL = 2e-5
TPU = Chip(**dataclasses.asdict(TPU_V5E))
MOE_ARCHS = ("grok-1-314b", "llama4-maverick-400b-a17b")
NEW_ARCHS = MOE_ARCHS + ("qwen2-vl-7b",)


def _np(t):
    return t.detach().numpy()


@pytest.fixture(scope="module", params=MOE_ARCHS)
def arch(request):
    name = request.param
    jc, tc = jax_config(name).reduced(), torch_config(name).reduced()
    jp = jm.init_params(jc, jax.random.key(0))
    tp = tm.params_from_jax(tc, jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


def test_configs_equal_the_references_and_hubert_stays_refused():
    for name in NEW_ARCHS:
        tc, jc = torch_config(name), jax_config(name)
        assert reference_view(tc) == dataclasses.asdict(jc)
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
        # the MoE and mrope changes of reduced(): 4 experts, k <= 2, a
        # non-binding capacity factor 8.0, mrope sections over D/2 = 16
        assert reference_view(tc.reduced()) == \
            dataclasses.asdict(jc.reduced())
        ts.EngineConfig().validate(tc)
        ts.EngineConfig().validate(tc.reduced())
    assert torch_config("llama4-maverick-400b-a17b").reduced().num_experts \
        == 4
    assert torch_config("qwen2-vl-7b").reduced().mrope_sections == (4, 6, 6)
    with pytest.raises(ValueError, match="encoder-only arch: no "
                       "autoregressive serving"):
        ts.EngineConfig().validate(torch_config("hubert-xlarge"))


def test_int8_weights_are_refused_on_moe_as_in_the_reference():
    """int8 weights: the reference's ``WEIGHT_QUANT_BLOCKS`` rule and
    message; int8 KV pages stay allowed (MoE blocks page)."""
    for name in MOE_ARCHS:
        tc, jc = torch_config(name).reduced(), jax_config(name).reduced()
        msgs = []
        for pkg, cfg in ((ts, tc), (js, jc)):
            with pytest.raises(ValueError, match="weight_dtype") as e:
                pkg.EngineConfig(precision=pkg.PrecisionConfig(
                    weight_dtype="int8")).validate(cfg)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1] and "'moe'" in msgs[0]
        ts.EngineConfig(precision=ts.PrecisionConfig(
            kv_cache_dtype="int8")).validate(tc)


def test_block_program_and_converted_weights(arch):
    """llama4 alternates a dense layer (``dense_d_ff`` wide) and an MoE
    one; the moe leaves cross over as they are (router float32)."""
    jc, tc, jp, tp = arch
    want = (["dense", "moe"] if tc.moe_layer_period == 2
            else ["moe", "moe"])
    assert tm.layer_types(tc) == want and tm.paged_ok(tc)
    pattern, _, _ = tm.block_program(tc)
    for r in range(len(tp["layers"]) // len(pattern)):
        for j, bt in enumerate(pattern):
            layer = tp["layers"][r * len(pattern) + j]
            jl = jax.tree.map(lambda a, r=r: np.asarray(a)[r],
                              jp["body"][j])
            flat_t = jax.tree_util.tree_leaves_with_path(layer)
            flat_j = jax.tree_util.tree_leaves_with_path(jl)
            assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
            for (_, a), (_, b) in zip(flat_t, flat_j):
                np.testing.assert_array_equal(_np(a), b)
            if bt == "moe":
                m = layer["moe"]
                e, d, ff = tc.num_experts, tc.d_model, tc.d_ff
                assert m["router"].dtype == torch.float32
                assert tuple(m["router"].shape) == (d, e)
                assert tuple(m["w_up"].shape) == (e, d, ff)
                assert tuple(m["w_down"].shape) == (e, ff, d)
                assert ("shared" in m) == tc.moe_shared_expert
            else:
                assert layer["mlp"]["w_up"].shape[1] == tc.dense_d_ff


def test_init_params_draws_the_expert_stacks_in_the_model_dtype():
    cfg = dataclasses.replace(
        torch_config("llama4-maverick-400b-a17b").reduced(),
        dtype="bfloat16")
    p = tm.init_params(cfg, seed=0, device="cpu")
    m = p["layers"][1]["moe"]
    assert m["w_gate"].dtype == torch.bfloat16
    assert m["router"].dtype == torch.float32
    # each expert drawn on its own, at the reference's scale d^-1/2
    std = m["w_gate"].float().std(dim=(1, 2))
    np.testing.assert_allclose(_np(std), cfg.d_model ** -0.5, rtol=0.05)
    assert not torch.equal(m["w_gate"][0], m["w_gate"][1])
    assert set(m["shared"]) == {"w_gate", "w_up", "w_down"}


def _jax_keep(monkeypatch, fn, k):
    """Run ``fn`` eagerly with ``jax.nn.one_hot`` probed: each routing
    round one-hots the argmax (E classes) and then each token's slot (C
    classes); returns (fn's result, the (t, k) mask of kept choices)."""
    calls = []
    orig = jax.nn.one_hot

    def probe(x, n, *a, **kw):
        calls.append((np.asarray(x), n))
        return orig(x, n, *a, **kw)

    monkeypatch.setattr(jax.nn, "one_hot", probe)
    out = fn()
    monkeypatch.setattr(jax.nn, "one_hot", orig)
    slots = calls[1::2]  # (slot (N, g), C) of each round
    assert len(slots) == k
    keep = np.stack([pos.reshape(-1) < c for pos, c in slots], axis=-1)
    return out, keep


def _torch_keep(monkeypatch, fn):
    """Run ``fn`` with ``moe.route`` probed: returns (fn's result, the
    (t, k) mask of kept choices)."""
    keeps = []
    orig = tmoe.route

    def probe(cfg, probs, c):
        out = orig(cfg, probs, c)
        keeps.append(out[1])
        return out

    monkeypatch.setattr(tmoe, "route", probe)
    out = fn()
    monkeypatch.setattr(tmoe, "route", orig)
    (keep,) = keeps
    return out, keep.reshape(-1, keep.shape[-1])


CASES = [  # (capacity factor, full capacity, shared expert, group size)
    (8.0, False, True, 2048), (1.0, False, True, 2048),
    (1.0, False, False, 2048), (1.0, False, True, 16),
    (1.0, True, True, 2048)]


@pytest.mark.parametrize("cf,full,shared,group", CASES)
def test_apply_moe_matches_jax(arch, monkeypatch, cf, full, shared, group):
    """48 tokens (2 x 24): one group of 48, or three of 16. Factor 1.0
    drops tokens (capacity 25 or 9 for top-2 over 4 experts, 13 or 5
    for top-1), identically in both packages; full capacity drops none."""
    jc, tc, jp, tp = arch
    jc = dataclasses.replace(jc, moe_capacity_factor=cf)
    tc = dataclasses.replace(tc, moe_capacity_factor=cf)
    j = len(tm.block_program(tc)[0]) - 1  # the first MoE layer
    jm_p = jax.tree.map(lambda a: a[0], jp["body"][j]["moe"])
    tm_p = dict(tp["layers"][j]["moe"])
    if not shared:
        jc = dataclasses.replace(jc, moe_shared_expert=False)
        tc = dataclasses.replace(tc, moe_shared_expert=False)
        jm_p = {k: v for k, v in jm_p.items() if k != "shared"}
        tm_p.pop("shared", None)
    x = np.random.default_rng(int(cf * 10) + group).standard_normal(
        (2, 24, tc.d_model)).astype(np.float32)

    def run_jax():
        if full:
            from repro.util import sharding_hints

            with sharding_hints(opts=frozenset({"moe_full_cap"})):
                return jmoe.apply_moe(jc, jm_p, jnp.asarray(x),
                                      group_size=group)
        return jmoe.apply_moe(jc, jm_p, jnp.asarray(x), group_size=group)

    k = tc.experts_per_token
    (want, want_aux), want_keep = _jax_keep(monkeypatch, run_jax, k)
    (got, aux), keep = _torch_keep(monkeypatch, lambda: tmoe.apply_moe(
        tc, tm_p, torch.from_numpy(x), group_size=group,
        dispatch="full" if full else "factor"))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=TOL,
                               rtol=0)
    np.testing.assert_array_equal(_np(keep), want_keep)
    dropped = int((~want_keep).sum())
    assert (dropped > 0) == (cf == 1.0 and not full)


def test_capacity_and_drop_free_group_match_jax():
    for name in MOE_ARCHS:
        for cfg_of in (lambda n: n, lambda n: n.reduced()):
            for cf in (0.5, 1.0, 1.25, 1.99, 3.5, 8.0):
                jc = dataclasses.replace(cfg_of(jax_config(name)),
                                         moe_capacity_factor=cf)
                tc = dataclasses.replace(cfg_of(torch_config(name)),
                                         moe_capacity_factor=cf)
                assert tmoe.drop_free_group(tc) == jmoe.drop_free_group(jc)
                for g in (1, 2, 7, 8, 64, 1000, 2048):
                    for full in (False, True):
                        assert tmoe._capacity(tc, g, full=full) == \
                            jmoe._capacity(jc, g, full=full)
    assert tmoe.drop_free_group(torch_config("granite-8b")) == 1 << 20
    for t in (1, 8, 48, 64, 96, 1024, 3000, 4096):
        n, g = tmoe.group_shape(t)
        assert n * g == t and g <= 2048


def test_resolved_moe_policy_matches_jax():
    for name in ("grok-1-314b", "granite-8b"):
        tc, jc = torch_config(name), jax_config(name)
        for policy in (None, "strict", "backpressure", "drop"):
            for tp_ in (1, 2):
                t = ts.EngineConfig(moe_capacity_policy=policy,
                                    topology=ts.DeviceTopology(tp=tp_))
                j = jsc.EngineConfig(moe_capacity_policy=policy,
                                     topology=jsc.DeviceTopology(tp=tp_))
                assert t.resolved_moe_policy(tc) == \
                    j.resolved_moe_policy(jc)
    assert ts.EngineConfig().resolved_moe_policy(
        torch_config("grok-1-314b")) == "drop"


@pytest.mark.parametrize("flag", ["", "strict", "backpressure", "drop"])
def test_moe_capacity_flag_gives_the_references_policy(flag):
    argv = ["--arch", "grok-1-314b", "--moe-capacity", flag]
    args = tserve.build_parser().parse_args(argv)
    want = jserve._engine_config(argparse.Namespace(**vars(args)))
    got = tserve.engine_config(args)
    assert got.moe_capacity_policy == want.moe_capacity_policy
    assert got.resolved_moe_policy(torch_config("grok-1-314b")) == \
        want.resolved_moe_policy(jax_config("grok-1-314b"))


def test_cost_model_moe_terms_match_jax():
    """Active parameters, decode and prefill estimates and the expert
    dispatch and combine traffic at the same chip, to ``rel=1e-12``."""
    mesh = (("data", 1), ("model", 8))
    for name in MOE_ARCHS:
        tc, jc = torch_config(name), jax_config(name)
        assert tc.active_param_count() == jc.active_param_count()
        for b, ctx in ((1, 512), (8, 1024), (64, 4096)):
            t = tcm.estimate_decode(tc, b, ctx, chip=TPU)
            j = jcm.estimate_decode(jc, b, ctx, chip=TPU_V5E)
            assert t.latency_s == pytest.approx(j.latency_s, rel=1e-12)
            assert t.flops == pytest.approx(j.flops, rel=1e-12)
            t = tcm.estimate_prefill(tc, b, ctx, chip=TPU)
            j = jcm.estimate_prefill(jc, b, ctx, chip=TPU_V5E)
            assert t.latency_s == pytest.approx(j.latency_s, rel=1e-12)
        for tokens in (8, 64, 2048):
            t = tcm.collective_bytes_per_axis(tc, tokens, mesh_axes=mesh)
            j = jcm.collective_bytes_per_axis(jc, tokens, mesh_axes=mesh)
            assert t.keys() == j.keys()
            for axis in t:
                assert t[axis] == pytest.approx(j[axis], rel=1e-12)


# ---------------------------------------------------------------------------
# the reference's capacity-policy checks (tests/test_engine_config.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tight_moe():
    """A capacity factor low enough that only tiny token groups are
    provably drop-free (k * factor < E), as the reference's fixture."""
    jc = dataclasses.replace(jax_config("grok-1-314b").reduced(),
                             moe_capacity_factor=1.0)
    tc = dataclasses.replace(torch_config("grok-1-314b").reduced(),
                             moe_capacity_factor=1.0)
    jp = jm.init_params(jc, jax.random.key(1))
    return tc, tm.params_from_jax(tc, jax.tree.map(np.asarray, jp), "cpu"), \
        jc, jp


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, 500, n).astype(np.int32)


def _engine(pkg, cfg, params, **kw):
    extra = {} if pkg is js else dict(device="cpu")
    return pkg.ServingEngine(cfg, params, pkg.EngineConfig(**kw), **extra)


def test_backpressure_clamps_slots_and_rejects_typed(tight_moe):
    tc, tp, jc, jp = tight_moe
    gmax = tmoe.drop_free_group(tc)
    assert gmax < 16  # the fixture really is tight
    kw = dict(slots=8, window=64, chunk_prefill=0,
              moe_capacity_policy="backpressure")
    msgs = []
    for pkg, cfg, params in ((ts, tc, tp), (js, jc, jp)):
        eng = _engine(pkg, cfg, params, **kw)
        assert eng.slots <= gmax  # decode group provably drop-free
        big = pkg.Request(rid=0, prompt=_prompt(32), max_new_tokens=2)
        with pytest.raises(pkg.RequestRejected, match="drop-free") as e:
            eng.try_admit(big, 0.0)
        msgs.append(str(e.value))
        # submit() surfaces the same thing as a typed FAILED outcome
        big2 = pkg.Request(rid=1, prompt=_prompt(32), max_new_tokens=2)
        assert eng.submit(big2, 0.0) is False
        assert "drop-free" in big2.fail_reason
        assert eng.metrics.rejected == 1
        rep = eng.load_report()
        assert rep.moe_capacity_policy == "backpressure"
        assert rep.moe_drop_free_group == gmax
    assert msgs[0] == msgs[1]
    assert eng.slots == _engine(ts, tc, tp, **kw).slots


def test_strict_policy_serves_any_prompt(tight_moe):
    """strict sizes capacity to the group: the prompt backpressure
    rejects decodes fine, to the JAX engine's stream."""
    tc, tp, jc, jp = tight_moe
    outs = []
    for pkg, cfg, params in ((ts, tc, tp), (js, jc, jp)):
        eng = _engine(pkg, cfg, params, slots=2, window=64,
                      chunk_prefill=0, moe_capacity_policy="strict")
        req = pkg.Request(rid=0, prompt=_prompt(32), max_new_tokens=4)
        assert eng.try_admit(req, 0.0)
        t = 0.0
        while not req.done:
            t += 1.0
            eng.step(t)
        assert len(req.output) == 4
        assert eng.load_report().moe_capacity_policy == "strict"
        outs.append(req.output)
    assert outs[0] == outs[1]


def test_dense_arch_ignores_capacity_policy():
    cfg = torch_config("granite-8b").reduced()
    params = tm.init_params(cfg, seed=0, device="cpu")
    eng = _engine(ts, cfg, params, slots=2, window=64,
                  moe_capacity_policy="backpressure")
    assert eng.moe_capacity_policy == ""  # dense: no MoE capacity to police
    rep = eng.load_report()
    assert rep.moe_drop_free_group == 0 and rep.moe_capacity_policy == ""


def test_reset_gives_a_fresh_engines_streams_when_tokens_drop(tight_moe):
    """Idle decode lanes route too (and take capacity beside live
    tokens), and they write and attend the trash page: reset() leaves it
    as a fresh engine has it, zero, so a rerun's lanes start where the
    first run's did, and the streams repeat under a binding factor."""
    tc, tp, _, _ = tight_moe
    prompts = [_prompt(n, seed=n) for n in (5, 23, 40, 12)]

    def run(eng):
        reqs = [ts.Request(rid=i, prompt=p, max_new_tokens=12)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r, 0.0)
        t = 0.0
        while not all(r.done for r in reqs):
            t += 1.0
            eng.step(t)
        eng.drain(t)
        return [r.output for r in reqs]

    eng = _engine(ts, tc, tp, slots=3, max_seq=128)
    first = run(eng)
    for _ in range(2):
        eng.reset()
        assert run(eng) == first
    trash = [leaf[0] for layer in eng.cache["layers"]
             for leaf in layer.values()]
    assert any(bool(t.any()) for t in trash)  # written by idle lanes
    eng.reset()
    assert not any(bool(t.any()) for t in trash)


def test_rolling_cache_streams_match_the_jax_engine_when_tokens_drop(
        tight_moe):
    """``paged=False`` under a binding factor: a released rolling slot
    keeps its position, as the reference's does, and its idle lane routes
    beside the live tokens from there (zeroing it, as on dense archs,
    makes the streams of the requests admitted into freed slots
    diverge)."""
    tc, tp, jc, jp = tight_moe
    prompts = [_prompt(n, seed=n) for n in (9, 30, 50, 12, 20)]
    outs = []
    for pkg, cfg, params in ((ts, tc, tp), (js, jc, jp)):
        eng = _engine(pkg, cfg, params, slots=3, window=128, paged=False,
                      chunk_prefill=0)
        reqs = [pkg.Request(rid=i, prompt=p, max_new_tokens=6 + 4 * i)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r, 0.0)
        t = 0.0
        while not all(r.done for r in reqs) and t < 500:
            t += 1.0
            eng.step(t)
        eng.drain(t)
        assert not eng.paged
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]
