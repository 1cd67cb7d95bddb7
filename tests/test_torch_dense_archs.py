"""The PyTorch port's dense families beyond granite against the JAX
package's: phi3-medium-14b, starcoder2-15b (LayerNorm, GELU MLP) and
chatglm3-6b (the "half" RoPE), each ``reduced()`` at its full width's GQA
group (phi3 8/2 heads: G 4; starcoder2 12/1: G 12; chatglm3 16/1: G 16),
float32, on the same converted weights; the serve CLI's ``--sla-ms``.

Compared: the configs and their parameter counts; the half RoPE at head
dims 32 and 128 (2e-5 absolute in float32, as the reference suite's
kernels); prefill and paged decode logits (1e-4 absolute, as
``tests/test_torch_model.py``: float32 on both sides, sums in another
order through 2 blocks); engine streams, greedy and seeded, single-shot
and chunked, token-identical to the JAX engine; ``validate()``'s
refusals of what stays unported (the encoder block); ``--sla-ms``
against the reference CLI's ``sla_s`` and admission plan."""
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
from repro.core.hardware import TPU_V5E
from repro.core.misd.batching import plan_admission as jax_plan
from repro.core.misd.scheduler import ChunkedPrefillPolicy as JaxPolicy
from repro.launch import serve as jserve
from repro.models import layers as JL
from repro.serving import engine as je
from repro_torch import models as tm
from repro_torch import serving as ts
from repro_torch.configs import get_config as torch_config
from repro_torch.configs import reference_view
from repro_torch.core.hardware import H100_SXM, Chip
from repro_torch.core.misd.batching import plan_admission
from repro_torch.core.misd.scheduler import ChunkedPrefillPolicy
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.serving import engine as te

torch.set_num_threads(2)
TOL = 1e-4
ROPE_TOL = 2e-5
TPU = Chip(**dataclasses.asdict(TPU_V5E))
NEW_ARCHS = ("phi3-medium-14b", "starcoder2-15b", "chatglm3-6b",
             "mamba2-1.3b")
#: reduced configs at each arch's full-width GQA group
GROUPS = {"phi3-medium-14b": dict(num_heads=8, num_kv_heads=2),
          "starcoder2-15b": dict(num_heads=12, num_kv_heads=1),
          "chatglm3-6b": dict(num_heads=16, num_kv_heads=1)}


def _np(t):
    return t.detach().numpy()


@pytest.fixture(scope="module", params=sorted(GROUPS))
def arch(request):
    name = request.param
    jc = dataclasses.replace(jax_config(name).reduced(), **GROUPS[name])
    tc = dataclasses.replace(torch_config(name).reduced(), **GROUPS[name])
    jp = jm.init_params(jc, jax.random.key(0))
    tp = tm.params_from_jax(tc, jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


def test_configs_equal_the_references_and_the_rest_stay_refused():
    for name in NEW_ARCHS:
        tc, jc = torch_config(name), jax_config(name)
        assert reference_view(tc) == dataclasses.asdict(jc)
        assert tc.param_count() == jc.param_count()
        assert reference_view(tc.reduced()) == \
            dataclasses.asdict(jc.reduced())
        ts.EngineConfig().validate(tc)
    counts = [torch_config(n).param_count() / 1e9 for n in NEW_ARCHS[:3]]
    assert [round(c, 2) for c in counts] == [14.66, 15.96, 6.24]
    with pytest.raises(ValueError, match="encoder-only arch"):
        ts.EngineConfig().validate(torch_config("hubert-xlarge"))
    # DLRM, the survey's SIMD workload, is carried field for field
    dlrm, jdlrm = torch_config("dlrm"), jax_config("dlrm")
    assert dataclasses.asdict(dlrm) == dataclasses.asdict(jdlrm)
    assert dlrm.param_count() == jdlrm.param_count()
    # an encoder arch (hubert's blocks) is refused before any work: it
    # has no autoregressive serving, as in the reference's serve CLI
    encoder = dataclasses.replace(torch_config("granite-8b").reduced(),
                                  arch_type="audio")
    with pytest.raises(ValueError, match="encoder-only arch"):
        ts.EngineConfig().validate(encoder)


@pytest.mark.parametrize("d", [32, 128])
def test_half_rope_matches_jax(d):
    jc = dataclasses.replace(jax_config("chatglm3-6b").reduced(), head_dim=d)
    tc = dataclasses.replace(torch_config("chatglm3-6b").reduced(),
                             head_dim=d)
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 9, 3, d)).astype(np.float32)
    pos = rng.integers(0, 2048, (2, 9)).astype(np.int32)
    want = np.asarray(JL.apply_rope(jc, jnp.asarray(x), jnp.asarray(pos)))
    got = TL.apply_rope(tc, torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(_np(got), want, atol=ROPE_TOL, rtol=0)
    # the second half of each head passes through untouched; the table
    # covers the first half only (angles of width D/4)
    np.testing.assert_array_equal(_np(got)[..., d // 2:], x[..., d // 2:])
    cos2, sin2 = TL.rope_table(tc, torch.from_numpy(pos))
    assert cos2.shape[-1] == sin2.shape[-1] == d // 2
    # a whole-head roll by the table's half width would pair the wrong
    # lanes: it differs from the reference
    xf = torch.from_numpy(x)
    rolled = torch.roll(xf, d // 4, dims=-1)
    wrong = xf[..., :d // 2] * cos2 + rolled[..., :d // 2] * sin2
    assert np.abs(_np(wrong) - want[..., :d // 2]).max() > 1e-2


def test_converted_weights(arch):
    jc, tc, jp, tp = arch
    assert tm.layer_types(tc) == ["dense", "dense"] and tm.paged_ok(tc)
    for r, layer in enumerate(tp["layers"]):
        jl = jax.tree.map(lambda a, r=r: np.asarray(a)[r], jp["body"][0])
        assert layer.keys() == jl.keys()
        for sub in layer:
            assert layer[sub].keys() == jl[sub].keys()
            for name, w in layer[sub].items():
                np.testing.assert_array_equal(_np(w), jl[sub][name])
    if tc.norm == "layernorm":  # starcoder2: scale and bias, GELU MLP
        assert set(tp["final_norm"]) == {"scale", "bias"}
        assert set(tp["layers"][0]["mlp"]) == {"w_up", "w_down"}


def test_prefill_and_paged_decode_logits_match_jax(arch):
    """A 21-token prompt padded to 32, scattered into pages 3 and 5 of
    slot 0 (slot 1 released, on trash page 0), then 3 decode ticks."""
    jc, tc, jp, tp = arch
    ps, n_pool, max_pages, plen = 16, 8, 4, 21
    rng = np.random.default_rng(11)
    prompt = np.zeros((1, 32), np.int32)
    prompt[0, :plen] = rng.integers(0, jc.vocab_size, plen)
    want, _, _ = jm.forward(jc, jp, {"tokens": jnp.asarray(prompt)},
                            mode="prefill")
    got, _ = tm.forward(tc, tp, torch.from_numpy(prompt))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL, rtol=0)
    pages = np.array([3, 5], np.int32)
    _, _, lin = je.paged_prefill_step(jc, jp,
                                      {"tokens": jnp.asarray(prompt)}, plen)
    jcache = jm.init_paged_cache(jc, 2, n_pool, ps, max_pages)
    jcache = je.pages_insert(jcache, lin, jnp.asarray(pages), 0, plen)
    jcache = je.page_table_append(jcache, 0, 2, 6)
    _, _, kv = te.paged_prefill_step(tc, tp, torch.from_numpy(prompt), plen)
    tcache = tm.init_paged_cache(tc, 2, n_pool, ps, max_pages, device="cpu")
    te.pages_insert(tcache, kv, torch.from_numpy(pages).long(), 0, plen)
    te.page_table_append(tcache, 0, 2, 6)
    for _ in range(3):
        toks = rng.integers(0, jc.vocab_size, (2, 1)).astype(np.int32)
        want, jcache = jm.decode_step(jc, jp, jcache,
                                      {"tokens": jnp.asarray(toks)})
        got = tm.decode_step(tc, tp, tcache, torch.from_numpy(toks))
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL,
                                   rtol=0)
    for r, layer in enumerate(tcache["layers"]):
        np.testing.assert_allclose(_np(layer["k"]),
                                   np.asarray(jcache["body"][0]["k"][r]),
                                   atol=TOL, rtol=0)


def _serve(pkg, cfg, params, prompts, chunk):
    extra = ({} if pkg is js else dict(
        device="cpu", threefry_partitionable=bool(
            jax.config.jax_threefry_partitionable)))
    policy = None
    if chunk:
        policy = (JaxPolicy(chunk=chunk) if pkg is js
                  else ChunkedPrefillPolicy(chunk=chunk, chip=TPU))
    eng = pkg.ServingEngine(cfg, params, pkg.EngineConfig(
        slots=3, max_seq=128, chunk_prefill=chunk, prefill_policy=policy),
        **extra)
    reqs = [pkg.Request(rid=i, prompt=p, max_new_tokens=10,
                        sampling=(pkg.SamplingParams(
                            temperature=0.8, top_k=20, top_p=0.9,
                            seed=1000 + i)
                            if i % 2 else pkg.SamplingParams()))
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r, 0.0)
    t = 0.0
    while not all(r.done for r in reqs) and t < 500:
        t += 1.0
        eng.step(t)
    eng.drain(t)
    return reqs, eng


@pytest.mark.parametrize("chunk", [0, 16])
def test_streams_match_the_jax_engine(arch, chunk):
    """Paged KV, single-shot (buckets) or chunked (chunk 16, both engines
    pricing chunks at the reference's chip); half the requests seeded."""
    jc, tc, jp, tp = arch
    rng = np.random.default_rng(chunk + 2)
    prompts = [rng.integers(0, jc.vocab_size, n).astype(np.int32)
               for n in (5, 23, 40, 17)]
    want, jeng = _serve(js, jc, jp, prompts, chunk)
    got, teng = _serve(ts, tc, tp, prompts, chunk)
    assert teng.paged and jeng.paged
    assert [r.output for r in got] == [r.output for r in want]
    assert all(len(r.output) == 10 and r.state.value == "finished"
               for r in got)
    assert teng.metrics.prefill_chunks == jeng.metrics.prefill_chunks
    assert bool(teng.metrics.prefill_chunks) == bool(chunk)
    assert teng.allocator.pages_in_use == 0


def _cli_args(argv):
    """The port's parsed flags, and the same as the reference's
    ``_engine_config`` reads them."""
    args = tserve.build_parser().parse_args(argv)
    return args, argparse.Namespace(**vars(args))


def test_sla_ms_gives_the_references_sla_and_admission_plan():
    argv = ["--arch", "granite-8b", "--sla-ms", "20", "--slots", "0"]
    args, jargs = _cli_args(argv)
    config = tserve.engine_config(args)
    want = jserve._engine_config(jargs)
    assert config.sla_s == want.sla_s == 0.02
    default = tserve.engine_config(_cli_args(argv[:2])[0])
    assert default.sla_s == 0.05
    for name in ("granite-8b", "phi3-medium-14b", "chatglm3-6b"):
        tc, jc = torch_config(name), jax_config(name)
        kw = dict(context=config.window, sla_s=config.sla_s,
                  mean_context=config.window)
        # each package's default chip: the reference prices a TPU v5e,
        # the port an H100; the port at the TPU's constants plans as the
        # reference does
        assert dataclasses.astuple(plan_admission(tc, **kw, chip=TPU)) \
            == dataclasses.astuple(jax_plan(jc, **kw))
        assert plan_admission(tc, **kw) == plan_admission(tc, **kw,
                                                          chip=H100_SXM)
    # the engine plans from the flag: --slots 0 takes the plan's slots
    tc = torch_config("granite-8b").reduced()
    jc = jax_config("granite-8b").reduced()
    jp = jm.init_params(jc, jax.random.key(0))
    tp = tm.params_from_jax(tc, jax.tree.map(np.asarray, jp), "cpu")
    teng = ts.ServingEngine(tc, tp, config, device="cpu", chip=TPU)
    jeng = js.ServingEngine(jc, jp, want)
    assert teng.slots == jeng.slots
    assert teng.plan.flush_deadline_s == jeng.plan.flush_deadline_s
    h100 = ts.ServingEngine(tc, tp, config, device="cpu")
    assert h100.plan == plan_admission(
        tc, context=config.window, sla_s=0.02, mean_context=None,
        chip=H100_SXM)


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_serve_cli_serves_the_dense_archs(capsys, name):
    reqs = tserve.main(["--arch", name, "--reduced", "--device", "cpu",
                        "--requests", "2", "--slots", "2", "--rate", "1000",
                        "--max-new", "4", "--sla-ms", "20"])
    out = capsys.readouterr().out
    assert f"arch={name}" in out and "paged KV" in out
    assert all(len(r.output) == 4 for r in reqs)


def test_bf16_decode_attention_rounds_alike_in_any_key_order():
    """The plain bf16 decode attention (the paged kernels' twin) sums the
    softmax and P V in float64 over exact terms, so a cache whose rows
    come in another order gives the same bits: what lets the split-context
    kernel (``twin_kernel``) match it exactly at G 16 and S 4, where two
    float32 orders left an output a bf16 step (2^-9 at |o| >= 0.25) apart,
    past the int8 kernel's 1e-3 gate."""
    from repro_torch.kernels import plain

    rng = np.random.default_rng(16)
    b, w, kvh, g, s, d = 2, 96, 2, 16, 4, 128
    q = torch.from_numpy(rng.standard_normal((b, s, kvh * g, d)).astype(
        np.float32)).to(torch.bfloat16)
    k, v = (torch.from_numpy(rng.standard_normal((b, w, kvh, d)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    # past the window, every query sees every row
    pos = torch.tensor([w + s - 1] * b, dtype=torch.int32)
    want = plain.decode_attention(q, k, v, pos)
    perm = torch.from_numpy(rng.permutation(w))
    got = plain.decode_attention(q, k[:, perm], v[:, perm], pos)
    assert torch.equal(got, want)
