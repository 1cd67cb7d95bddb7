"""The PyTorch port's Mamba-2 SSD family against the JAX package's:
``ssd_chunked`` (chunks 16, 40 and 64 over 70 steps: whole chunks, the
padding path and a single chunk), the decode step's plain version
(``plain.ssd_step``, the kernel's twin) against the reference's step, the
SSD mixer (a prefill, then single steps from its cache; the step through
``ops.ssd_step`` keeps the bits of the mixer's inline arithmetic),
mamba2-1.3b ``reduced()`` end to end (converted
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
import torch.nn.functional as F

from repro import models as jm
from repro import serving as js
from repro.configs import get_config as jax_config
from repro.models import ssm as jssm
from repro_torch import models as tm
from repro_torch import serving as ts
from repro_torch.configs import get_config as torch_config
from repro_torch.kernels import ops, plain
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
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


def _step_lanes(tc, p, x, conv):
    """The step's inputs as the mixer cuts them: (z, x (b, H, P), B, C,
    raw dt (b, H)) from the in-projection of x (b, 1, d) after the conv
    over the cached window."""
    di, ns = tc.d_inner, tc.ssm_state_dim
    b = x.shape[0]
    z, xbc, dt = tssm._split_proj(tc, torch.matmul(x, p["in_proj"]))
    xbc, _ = tssm.causal_conv(xbc, p["conv_w"], conv, activation=F.silu)
    xs = xbc[:, 0, :di].reshape(b, tc.ssm_num_heads, tc.ssm_head_dim)
    return z, xs, xbc[:, 0, di:di + ns], xbc[:, 0, di + ns:], dt[:, 0]


def test_plain_ssd_step_matches_the_jax_step(mamba):
    """Layer 0's mixer of mamba2 ``reduced()`` with converted weights,
    after a 37-token prefill by the reference: the plain step's new state
    against the reference's cache, and its y, through the mixer's gated
    norm and out-projection, against the reference's output; in place and
    fresh alike, bit for bit."""
    jc, tc, jp, tp = mamba
    jpm = {k: v[0] for k, v in jp["body"][0]["mixer"].items()}
    p = tp["layers"][0]["mixer"]
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 38, jc.d_model)).astype(np.float32)
    _, jcache = jssm.apply_ssd(jc, jpm, jnp.asarray(x[:, :37]))
    want, jnew = jssm.apply_ssd(jc, jpm, jnp.asarray(x[:, 37:]),
                                cache=jcache)
    state = torch.from_numpy(np.array(jcache["state"]))
    z, xs, B, C, dt = _step_lanes(tc, p, torch.from_numpy(x[:, 37:]),
                                  torch.from_numpy(np.array(jcache["conv"])))
    w = (p["dt_bias"], p["A_log"], p["D"])
    y, new = plain.ssd_step(state, xs, B, C, dt, *w, in_place=False)
    assert new is not state and y.shape == xs.shape
    np.testing.assert_allclose(_np(new), np.asarray(jnew["state"]),
                               atol=SSD_TOL, rtol=SSD_TOL)
    out = TL.rmsnorm(y.reshape(3, 1, tc.d_inner) * F.silu(z),
                     p["norm_scale"]) @ p["out_proj"]
    np.testing.assert_allclose(_np(out), np.asarray(want), atol=SSD_TOL,
                               rtol=SSD_TOL)
    y2, same = plain.ssd_step(state, xs, B, C, dt, *w, in_place=True)
    assert same is state and torch.equal(state, new) and torch.equal(y2, y)


def _mixer_step_inline(tc, p, x, cache):
    """The mixer's decode step with its arithmetic written out inline:
    (out, new conv window, new state), the cache untouched."""
    di, ns = tc.d_inner, tc.ssm_state_dim
    b = x.shape[0]
    z, xbc, dt = tssm._split_proj(tc, torch.matmul(x, p["in_proj"]))
    xbc, new_conv = tssm.causal_conv(xbc, p["conv_w"], cache["conv"],
                                     activation=F.silu)
    xs = xbc[..., :di].reshape(b, 1, tc.ssm_num_heads, tc.ssm_head_dim)
    B, C = xbc[..., di:di + ns], xbc[..., di + ns:]
    dt = TL.softplus(dt.to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt[:, 0] * A)
    x0 = xs[:, 0].to(torch.float32)
    xin = x0 * dt[:, 0, :, None]
    state = (cache["state"] * dA[..., None, None]
             + xin[..., None] * B[:, 0].to(torch.float32)[:, None, None, :])
    y = torch.matmul(state, C[:, 0].to(torch.float32)[:, None, :, None])
    y = (y[..., 0] + p["D"][:, None] * x0).reshape(b, 1, di)
    y = TL.rmsnorm(y.to(x.dtype) * F.silu(z), p["norm_scale"])
    return torch.matmul(y, p["out_proj"]), new_conv, state


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_ssd_steps_through_ops_keep_the_bits(mamba, dtype):
    """A 37-token prefill, then 4 steps through ``apply_ssd`` (the step
    in ``ops.ssd_step``, in place) against the inline arithmetic from the
    same cache: outputs and both cache leaves bit for bit, the leaves
    still the tensors the cache was made with, and no kernel launched on
    the CPU. bf16 also takes y's rounding to the model dtype."""
    jc, tc = mamba[:2]
    tc = dataclasses.replace(tc, dtype="bfloat16" if dtype ==
                             torch.bfloat16 else "float32")
    gen = torch.Generator().manual_seed(4)
    p = tssm.init_ssd(tc, gen, dtype, "cpu")
    p["A_log"] = torch.randn(tc.ssm_num_heads, generator=gen) * 0.5
    p["dt_bias"] = torch.randn(tc.ssm_num_heads, generator=gen) * 0.5
    x = torch.randn((2, 41, tc.d_model), generator=gen).to(dtype)
    cache = tssm.init_ssd_cache(tc, 2, dtype, "cpu")
    leaves = dict(cache)
    tssm.apply_ssd(tc, p, x[:, :37], cache=cache)
    before = dict(ops.LAUNCHES)
    for t in range(37, 41):
        want, conv, state = _mixer_step_inline(tc, p, x[:, t:t + 1], cache)
        got = tssm.apply_ssd(tc, p, x[:, t:t + 1], cache=cache)
        assert torch.equal(got, want)
        assert torch.equal(cache["conv"], conv)
        assert torch.equal(cache["state"], state)
    assert all(cache[k] is leaves[k] for k in leaves)
    assert ops.LAUNCHES == before


def test_ssd_step_route_on_cpu_and_meta_and_refusals():
    """A CPU tensor takes the plain version, a meta tensor its shapes (the
    dry run); shapes that do not match the state are refused."""
    b, h, p, n = 2, 3, 4, 8
    gen = torch.Generator().manual_seed(0)
    args = [torch.randn(s, generator=gen) for s in
            ((b, h, p, n), (b, h, p), (b, n), (b, n), (b, h), (h,), (h,),
             (h,))]
    before = dict(ops.LAUNCHES)
    y, new = ops.ssd_step(*args, in_place=False)
    want_y, want = plain.ssd_step(*args, in_place=False)
    assert torch.equal(y, want_y) and torch.equal(new, want)
    assert ops.LAUNCHES == before
    meta = [a.to("meta") for a in args]
    y, new = ops.ssd_step(*meta, in_place=True)
    assert new is meta[0] and y.shape == (b, h, p) and y.device.type == \
        "meta"
    with pytest.raises(ValueError, match="do not match"):
        ops.ssd_step(args[0], args[1][:, :2], *args[2:], in_place=False)
    with pytest.raises(ValueError, match="want state"):
        ops.ssd_step(args[0][0], *args[1:], in_place=False)


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
