"""The PyTorch port's hybrid model and its rolling-cache engine against the
JAX package's, on recurrentgemma-9b ``reduced()`` cut to 5 layers (body
rglru, rglru, local_attn; tail rglru, rglru; local window 64) and on
granite-8b ``reduced()`` with ``paged=False``, on the same converted
weights.

Compared: prefill logits and the filled rolling caches, then 8 decode
ticks, against the reference's ``decode_step`` for prompts of 40 and 64
tokens; for a prompt of 100 tokens (longer than the window and not a
multiple of it) against the reference's full-sequence ``forward``,
because the reference's own decode misplaces the ring there (ROADMAP.md
queue 3: the test below shows that gap too). Engine streams, greedy and
seeded, token-identical to the JAX engine; ``validate()``'s refusals with
the reference's messages; the serve CLI on the CPU.

Tolerance for logits and cache leaves: 1e-4 absolute, as
``tests/test_torch_model.py`` (float32 on both sides, sums in another
order, carried through 5 blocks)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro import serving as js
from repro.configs import get_config as jax_config
from repro_torch import models as tm
from repro_torch import serving as ts
from repro_torch.configs import get_config as torch_config
from repro_torch.launch import serve as tserve

torch.set_num_threads(2)
TOL = 1e-4
WINDOW = 512  # the engine's default; local-attention rings are 64 rows


def _configs(arch, **kw):
    return (dataclasses.replace(jax_config(arch).reduced(), **kw),
            dataclasses.replace(torch_config(arch).reduced(), **kw))


@pytest.fixture(scope="module")
def hybrid():
    jc, tc = _configs("recurrentgemma-9b", num_layers=5)
    jp = jm.init_params(jc, jax.random.key(0))
    tp = tm.params_from_jax(tc, jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


@pytest.fixture(scope="module")
def jax_decode(hybrid):
    """The reference's decode step, traced once per shape (eagerly, its
    scan over layers would trace again on every call)."""
    jc = hybrid[0]
    step = jax.jit(lambda p, c, t: jm.decode_step(jc, p, c, {"tokens": t}))
    return lambda p, c, t: step(p, c, jnp.asarray(t))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=tol, rtol=0)


def test_layer_program_and_converted_mixer(hybrid):
    jc, tc, jp, tp = hybrid
    assert tm.layer_types(tc) == ["rglru", "rglru", "local_attn", "rglru",
                                  "rglru"]
    mixer = tp["layers"][3]["mixer"]  # the tail's first rglru block
    for name in ("Lambda", "b_a", "b_x"):
        assert mixer[name].dtype == torch.float32
    np.testing.assert_array_equal(mixer["Lambda"].numpy(),
                                  np.asarray(jp["tail"][0]["mixer"]["Lambda"]))
    np.testing.assert_array_equal(
        tp["layers"][1]["mixer"]["w_a"].numpy(),
        np.asarray(jp["body"][1]["mixer"]["w_a"][0]))
    assert "lm_head" not in tp  # tied embeddings


@pytest.mark.parametrize("s", [40, 64])
def test_prefill_and_decode_match_jax_decode(hybrid, jax_decode, s):
    jc, tc, jp, tp = hybrid
    rng = np.random.default_rng(s)
    toks = rng.integers(0, jc.vocab_size, (2, s)).astype(np.int32)
    jcache = jm.init_cache(jc, 2, WINDOW)
    want, _, jcache = jm.forward(jc, jp, {"tokens": jnp.asarray(toks)},
                                 mode="prefill", cache=jcache)
    tcache = tm.init_cache(tc, 2, WINDOW, device="cpu")
    got, _ = tm.forward(tc, tp, torch.from_numpy(toks), cache=tcache)
    _close(got, want)
    ref_cache = tm.cache_from_jax(tc, jax.tree.map(np.asarray, jcache),
                                  "cpu")
    assert tcache["pos"].tolist() == ref_cache["pos"].tolist() == [s, s]
    for a, b in zip(tcache["layers"], ref_cache["layers"]):
        assert a.keys() == b.keys()
        for name in a:
            _close(a[name], b[name].numpy())
    nxt = np.argmax(np.asarray(want)[:, -1], axis=-1).astype(np.int32)
    for _ in range(8):
        want, jcache = jax_decode(jp, jcache, nxt[:, None])
        got = tm.decode_step(tc, tp, tcache, torch.from_numpy(nxt[:, None]))
        _close(got, want)
        nxt = np.argmax(np.asarray(want)[:, -1], axis=-1).astype(np.int32)
    assert tcache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()


def test_decode_after_a_prompt_longer_than_the_window(hybrid, jax_decode):
    """S = 100 > W = 64, 100 % 64 != 0: the port's 8 decode ticks agree
    with the reference's full-sequence forward over the same tokens; the
    reference's own decode does not (its ring fault)."""
    jc, tc, jp, tp = hybrid
    rng = np.random.default_rng(100)
    seq = rng.integers(0, jc.vocab_size, (1, 108)).astype(np.int32)
    full, _, _ = jm.forward(jc, jp, {"tokens": jnp.asarray(seq)},
                            mode="prefill")
    full = np.asarray(full)
    tcache = tm.init_cache(tc, 1, WINDOW, device="cpu")
    got, _ = tm.forward(tc, tp, torch.from_numpy(seq[:, :100]), cache=tcache)
    _close(got, full[:, :100])
    jcache = jm.init_cache(jc, 1, WINDOW)
    _, _, jcache = jm.forward(jc, jp, {"tokens": jnp.asarray(seq[:, :100])},
                              mode="prefill", cache=jcache)
    ref_gap = 0.0
    for t in range(100, 108):
        tok = seq[:, t:t + 1]  # token t, at position t
        got = tm.decode_step(tc, tp, tcache, torch.from_numpy(tok))
        _close(got[:, 0], full[:, t])
        jlog, jcache = jax_decode(jp, jcache, tok)
        ref_gap = max(ref_gap, float(np.abs(np.asarray(jlog)[:, 0]
                                            - full[:, t]).max()))
    assert ref_gap > 1e-2  # the reference's decode misreads its ring


def _serve(pkg, cfg, params, prompts, **kw):
    device = kw.pop("device", None)
    eng = pkg.ServingEngine(cfg, params, pkg.EngineConfig(
        slots=3, chunk_prefill=0, **kw),
        **({} if device is None else dict(
            device=device, threefry_partitionable=bool(
                jax.config.jax_threefry_partitionable))))
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


def test_hybrid_streams_match_the_jax_engine(hybrid):
    """Exact-length prefill (recurrent state), rings of 64 that wrap
    during decode; half the requests greedy, half seeded."""
    jc, tc, jp, tp = hybrid
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jc.vocab_size, n).astype(np.int32)
               for n in (5, 23, 64, 40)]
    want, jeng = _serve(js, jc, jp, prompts)
    got, teng = _serve(ts, tc, tp, prompts, device="cpu")
    assert not jeng.paged and not teng.paged
    assert [r.output for r in got] == [r.output for r in want]
    assert all(len(r.output) == 12 and r.state.value == "finished"
               for r in got)
    assert teng.metrics.sampled_requests == jeng.metrics.sampled_requests == 2
    assert teng.prefill_calls == 4


def test_dense_rolling_streams_match_the_jax_engine():
    """granite with paged=False: bucketed prefill into rings of 32 (the
    engine's window), pos clamped to the true length, rings that wrap."""
    jc, tc = _configs("granite-8b", num_kv_heads=2)
    jp = jm.init_params(jc, jax.random.key(0))
    tp = tm.params_from_jax(tc, jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jc.vocab_size, n).astype(np.int32)
               for n in (5, 23, 32, 17)]
    kw = dict(paged=False, window=32)
    want, _ = _serve(js, jc, jp, prompts, **kw)
    got, teng = _serve(ts, tc, tp, prompts, device="cpu", **kw)
    assert not teng.paged and teng.allocator is None
    assert [r.output for r in got] == [r.output for r in want]
    assert all(len(r.output) == 12 for r in got)


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_validate_keeps_the_reference_refusals_on_rolling_caches(hybrid):
    jc, tc, jp, tp = hybrid
    # paged=True on an arch that cannot page: the reference's message
    got = _message(lambda: ts.EngineConfig(paged=True).validate(tc))
    want = _message(lambda: js.ServingEngine(jc, jp,
                                             js.EngineConfig(paged=True)))
    assert got == want and "non-pageable" in got
    for precision in (dict(kv_cache_dtype="int8"),
                      dict(weight_dtype="int8")):
        got = _message(lambda: ts.EngineConfig(
            precision=ts.PrecisionConfig(**precision)).validate(tc))
        want = _message(lambda: js.EngineConfig(
            precision=js.PrecisionConfig(**precision)).validate(jc))
        assert got == want
    granite = torch_config("granite-8b").reduced()
    jgranite = jax_config("granite-8b").reduced()
    got = _message(lambda: ts.EngineConfig(
        paged=False, precision=ts.PrecisionConfig(kv_cache_dtype="int8"))
        .validate(granite))
    want = _message(lambda: js.EngineConfig(
        paged=False, precision=js.PrecisionConfig(kv_cache_dtype="int8"))
        .validate(jgranite))
    assert got == want
    # served now: rolling caches on both archs, int8 weights on rolling
    # dense, chunked prefill on rolling caches (recurrentgemma never
    # chunks: its recurrent state forbids end padding, as in the
    # reference), tracing; still refused: a sharded replica, naming its
    # ROADMAP.md item
    ts.EngineConfig(paged=False).validate(granite)
    ts.EngineConfig().validate(tc)
    ts.EngineConfig(paged=False, precision=ts.PrecisionConfig(
        weight_dtype="int8")).validate(granite)
    ts.EngineConfig(paged=False, chunk_prefill=32).validate(granite)
    config = ts.EngineConfig(slots=1, chunk_prefill=32)
    assert ts.ServingEngine(tc, tp, config.validate(tc),
                            device="cpu").chunk == 0
    assert js.ServingEngine(jc, jp, js.EngineConfig(
        slots=1, chunk_prefill=32)).chunk == 0
    ts.EngineConfig(paged=False, tracing=True).validate(tc)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        ts.EngineConfig(paged=False, topology=ts.DeviceTopology(
            tp=2)).validate(tc)


def test_serve_cli_serves_recurrentgemma_from_rolling_caches(capsys):
    reqs = tserve.main(["--arch", "recurrentgemma-9b", "--reduced",
                        "--device", "cpu", "--requests", "4", "--slots", "2",
                        "--rate", "1000", "--max-new", "8"])
    out = capsys.readouterr().out
    assert "rolling caches" in out and "paged KV" not in out
    assert "served 4 requests" in out
    assert all(len(r.output) == 8 for r in reqs)
    tserve.main(["--arch", "granite-8b", "--reduced", "--device", "cpu",
                 "--requests", "2", "--slots", "2", "--rate", "1000",
                 "--max-new", "4", "--no-paged"])
    assert "rolling caches: window=256 KV rings of [256]" in \
        capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.main(["--arch", "recurrentgemma-9b", "--reduced",
                         "--requests", "1"])
