"""The PyTorch port's Mamba-2 SSD family against the JAX package's:
``ssd_chunked`` (chunks 16, 40 and 64 over 70 steps: whole chunks, the
padding path and a single chunk), the SSD mixer (a prefill, then single
steps from its cache), mamba2-1.3b ``reduced()`` end to end (converted
weights with their float32 leaves, prefill and decode logits and caches,
engine streams from rolling caches, greedy and seeded), and the
reference's refusals on an attention-free arch (int8 KV, int8 weights, a
prefix cache, preemption), with its messages.

Tolerances: the SSD pieces 2e-5 absolute and relative in float32, as the
reference suite's kernels (``tests/test_kernels.py``); whole-model logits
and cache leaves 1e-4 absolute, as ``tests/test_torch_model.py`` (float32
on both sides, sums in another order, carried through 2 blocks)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro import serving as js
from repro.configs import get_config as jax_config
from repro.models import ssm as jssm
from repro_torch import models as tm
from repro_torch import serving as ts
from repro_torch.configs import get_config as torch_config
from repro_torch.launch import serve as tserve
from repro_torch.models import ssm as tssm

torch.set_num_threads(2)
SSD_TOL = 2e-5
TOL = 1e-4
WINDOW = 512  # the engine's default; mamba2 holds no KV ring


def _np(t):
    return t.detach().numpy()


@pytest.fixture(scope="module")
def mamba():
    jc, tc = (jax_config("mamba2-1.3b").reduced(),
              torch_config("mamba2-1.3b").reduced())
    jp = jm.init_params(jc, jax.random.key(0))
    tp = tm.params_from_jax(tc, jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


@pytest.fixture(scope="module")
def jax_decode(mamba):
    jc = mamba[0]
    step = jax.jit(lambda p, c, t: jm.decode_step(jc, p, c, {"tokens": t}))
    return lambda p, c, t: step(p, c, jnp.asarray(t))


def _ssd_inputs(b, s, h, p, n, seed):
    """The reference suite's distributions (``test_sequence_blocks.py``)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((b, s, h, p)).astype(f)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0.0).astype(f)
    A = -np.exp(0.5 * rng.standard_normal(h)).astype(f)
    B = (0.5 * rng.standard_normal((b, s, n))).astype(f)
    C = (0.5 * rng.standard_normal((b, s, n))).astype(f)
    D = rng.standard_normal(h).astype(f)
    return x, dt, A, B, C, D


@pytest.mark.parametrize("chunk", [16, 40, 64])
def test_ssd_chunked_matches_jax(chunk):
    args = _ssd_inputs(2, 70, 4, 8, 16, chunk)
    yj, hj = jssm.ssd_chunked(*map(jnp.asarray, args), chunk)
    yt, ht = tssm.ssd_chunked(*map(torch.from_numpy, args), chunk)
    assert yt.dtype == torch.float32 and tuple(ht.shape) == (2, 4, 8, 16)
    np.testing.assert_allclose(_np(yt), np.asarray(yj), atol=SSD_TOL,
                               rtol=SSD_TOL)
    np.testing.assert_allclose(_np(ht), np.asarray(hj), atol=SSD_TOL,
                               rtol=SSD_TOL)


def test_apply_ssd_prefill_then_steps_match_jax(mamba):
    """A 37-token prefill from nothing (two chunks of 32, the second
    padded), then 4 single steps from its cache, updated in place."""
    jc, tc = mamba[:2]
    jp = jssm.init_ssd(jc, jax.random.key(3), jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    for name in ("A_log", "D", "dt_bias"):
        assert tp[name].dtype == torch.float32
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 41, jc.d_model)).astype(np.float32)
    want, jcache = jssm.apply_ssd(jc, jp, jnp.asarray(x[:, :37]))
    tcache = tssm.init_ssd_cache(tc, 2, torch.float32, "cpu")
    conv, state = tcache["conv"], tcache["state"]
    got = tssm.apply_ssd(tc, tp, torch.from_numpy(x[:, :37]), cache=tcache)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=SSD_TOL,
                               rtol=SSD_TOL)
    for t in range(37, 41):
        want, jcache = jssm.apply_ssd(jc, jp, jnp.asarray(x[:, t:t + 1]),
                                      cache=jcache)
        got = tssm.apply_ssd(tc, tp, torch.from_numpy(x[:, t:t + 1]),
                             cache=tcache)
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   atol=SSD_TOL, rtol=SSD_TOL)
        for name in ("conv", "state"):
            np.testing.assert_allclose(_np(tcache[name]),
                                       np.asarray(jcache[name]),
                                       atol=SSD_TOL, rtol=SSD_TOL)
    # the leaves the engine's graphs captured are the ones written
    assert tcache["conv"] is conv and tcache["state"] is state


def test_converted_weights_keep_the_float32_leaves(mamba):
    jc, tc, jp, tp = mamba
    assert tm.layer_types(tc) == ["ssd", "ssd"]
    assert tm.ported(tc) and not tm.paged_ok(tc)
    for r, layer in enumerate(tp["layers"]):
        assert set(layer) == {"norm1", "mixer"}
        for name in ("A_log", "D", "dt_bias"):
            assert layer["mixer"][name].dtype == torch.float32
        np.testing.assert_array_equal(
            _np(layer["mixer"]["in_proj"]),
            np.asarray(jp["body"][0]["mixer"]["in_proj"][r]))
    assert "lm_head" not in tp  # tied embeddings: the head is embed.T
    bf = tm.init_params(dataclasses.replace(tc, dtype="bfloat16"), seed=0,
                        device="cpu")
    mixer = bf["layers"][0]["mixer"]
    assert mixer["in_proj"].dtype == torch.bfloat16
    assert all(mixer[n].dtype == torch.float32
               for n in ("A_log", "D", "dt_bias"))
    assert tm.quantize_weights(tc, tp)["layers"][0]["mixer"] is \
        tp["layers"][0]["mixer"]


@pytest.mark.parametrize("s", [1, 45])
def test_prefill_and_decode_match_jax(mamba, jax_decode, s):
    jc, tc, jp, tp = mamba
    rng = np.random.default_rng(s)
    toks = rng.integers(0, jc.vocab_size, (2, s)).astype(np.int32)
    jcache = jm.init_cache(jc, 2, WINDOW)
    want, _, jcache = jm.forward(jc, jp, {"tokens": jnp.asarray(toks)},
                                 mode="prefill", cache=jcache)
    tcache = tm.init_cache(tc, 2, WINDOW, device="cpu")
    got, _ = tm.forward(tc, tp, torch.from_numpy(toks), cache=tcache)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL,
                               rtol=0)
    ref = tm.cache_from_jax(tc, jax.tree.map(np.asarray, jcache), "cpu")
    for a, b in zip(tcache["layers"], ref["layers"]):
        assert a.keys() == b.keys() == {"conv", "state"}
        assert a["state"].dtype == b["state"].dtype == torch.float32
        for name in a:
            np.testing.assert_allclose(_np(a[name]), _np(b[name]),
                                       atol=TOL, rtol=0)
    nxt = np.argmax(np.asarray(want)[:, -1], axis=-1).astype(np.int32)
    for _ in range(6):
        want, jcache = jax_decode(jp, jcache, nxt[:, None])
        got = tm.decode_step(tc, tp, tcache, torch.from_numpy(nxt[:, None]))
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL,
                                   rtol=0)
        nxt = np.argmax(np.asarray(want)[:, -1], axis=-1).astype(np.int32)
    assert tcache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()


def _serve(pkg, cfg, params, prompts, **kw):
    extra = ({} if pkg is js else dict(
        device="cpu", threefry_partitionable=bool(
            jax.config.jax_threefry_partitionable)))
    eng = pkg.ServingEngine(cfg, params, pkg.EngineConfig(
        slots=3, chunk_prefill=0, **kw), **extra)
    reqs = [pkg.Request(rid=i, prompt=p, max_new_tokens=12,
                        sampling=(pkg.SamplingParams(
                            temperature=0.8, top_k=20, top_p=0.9,
                            seed=1000 + i)
                            if i % 2 else pkg.SamplingParams()))
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r, 0.0)
    t, done = 0.0, 0
    while done < len(reqs) and t < 500:
        t += 1.0
        done += len(eng.step(t))
    eng.drain(t)
    return reqs, eng


def test_streams_match_the_jax_engine(mamba):
    """Rolling caches and exact-length prefill (one eager key per prompt
    length, the reference's ``prefill/exact{L}``); a 1-token prompt takes
    the step branch, a 70-token one the padded chunks; half seeded."""
    jc, tc, jp, tp = mamba
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jc.vocab_size, n).astype(np.int32)
               for n in (1, 23, 70, 40)]
    want, jeng = _serve(js, jc, jp, prompts)
    got, teng = _serve(ts, tc, tp, prompts)
    assert not jeng.paged and not teng.paged and teng.chunk == 0
    assert [r.output for r in got] == [r.output for r in want]
    assert all(len(r.output) == 12 and r.state.value == "finished"
               for r in got)
    assert teng.metrics.sampled_requests == jeng.metrics.sampled_requests
    assert teng.prefill_traces == jeng.prefill_traces == 4
    assert teng.compile_events == dict(jeng.compile_events)


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("option", ["kv_int8", "weights_int8",
                                    "prefix_cache", "preemption"])
def test_refusals_match_the_reference(mamba, option):
    jc, tc, jp, tp = mamba
    if option in ("kv_int8", "weights_int8"):
        precision = ({"kv_cache_dtype": "int8"} if option == "kv_int8"
                     else {"weight_dtype": "int8"})
        got = _message(lambda: ts.EngineConfig(
            precision=ts.PrecisionConfig(**precision)).validate(tc))
        want = _message(lambda: js.EngineConfig(
            precision=js.PrecisionConfig(**precision)).validate(jc))
    else:
        kw = {option: True}
        got = _message(lambda: ts.ServingEngine(
            tc, tp, ts.EngineConfig(slots=2, **kw), device="cpu"))
        want = _message(lambda: js.ServingEngine(
            jc, jp, js.EngineConfig(slots=2, **kw)))
    assert got == want and "mamba2" in got


def test_serve_cli_serves_mamba2_and_refuses_int8_kv_first(capsys):
    reqs = tserve.main(["--arch", "mamba2-1.3b", "--reduced", "--device",
                        "cpu", "--requests", "3", "--slots", "2", "--rate",
                        "1000", "--max-new", "5"])
    out = capsys.readouterr().out
    assert "rolling caches: window=256 KV rings of [] tokens, 2 " \
        "recurrent states" in out
    assert "served 3 requests" in out
    assert all(len(r.output) == 5 for r in reqs)
    with pytest.raises(ValueError, match="kv_cache_dtype='int8'"):
        tserve.main(["--arch", "mamba2-1.3b", "--reduced", "--device", "cpu",
                     "--kv-dtype", "int8"])
    assert "device:" not in capsys.readouterr().out  # before any work
