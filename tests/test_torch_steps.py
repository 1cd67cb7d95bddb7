"""The port's module-level engine steps (``prefill_step``,
``bucketed_prefill_step``, ``serve_step``, ``generate``) against the JAX
package's on granite-8b ``reduced()`` with two kv heads, in float32, on
the same converted weights: logits to 2e-5, tokens and caches equal,
``generate``'s greedy and seeded streams token-identical; and the port's
``timeit`` (its CUDA path is in ``tests/test_torch_gpu.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro import serving as js
from repro.configs import get_config as jax_config
from repro.serving import engine as je
from repro_torch import models as tm
from repro_torch import serving as ts
from repro_torch import util
from repro_torch.configs import get_config as torch_config

torch.set_num_threads(2)

TOL = 2e-5
W = 64


@pytest.fixture(scope="module")
def setup():
    jc = dataclasses.replace(jax_config("granite-8b").reduced(),
                             num_kv_heads=2)
    tc = dataclasses.replace(torch_config("granite-8b").reduced(),
                             num_kv_heads=2)
    jp = jm.init_params(jc, jax.random.key(0))
    tp = tm.params_from_jax(tc, jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, 500, n).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def _caches_equal(tc, got, want):
    ref = tm.cache_from_jax(tc, jax.tree.map(np.asarray, want), "cpu")
    np.testing.assert_array_equal(got["pos"].numpy(), ref["pos"].numpy())
    for a, b in zip(got["layers"], ref["layers"]):
        assert a.keys() == b.keys()
        for name in a:
            if a[name].dtype == torch.int8:
                # int8 codes: a float32 product one ulp apart may round
                # to the next code
                diff = (a[name].to(torch.int32) - b[name].to(torch.int32))
                assert int(diff.abs().max()) <= 1
                assert float((diff != 0).float().mean()) < 1e-3
            else:
                _close(a[name], b[name].numpy())


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_prefill_step_matches_jax(setup, kv_dtype):
    jc, tc, jp, tp = setup
    prompts = np.stack([_prompt(23, seed=1), _prompt(23, seed=2)])
    want_logits, want_cache = je.prefill_step(
        jc, jp, {"tokens": jnp.asarray(prompts)}, window=W,
        kv_dtype=kv_dtype)
    logits, cache = ts.prefill_step(tc, tp, torch.from_numpy(prompts),
                                    window=W, kv_dtype=kv_dtype)
    assert logits.shape == (2, tc.vocab_size) and logits.dtype == torch.float32
    _close(logits, want_logits)
    _caches_equal(tc, cache, want_cache)


@pytest.mark.parametrize("plen", [11, 16])
def test_bucketed_prefill_step_matches_jax_and_unpadded(setup, plen):
    """The reference's invariant (end padding to a bucket changes neither
    the last true token's logits nor its argmax; ``pos`` is the true
    length), and the port's outputs against the reference's."""
    jc, tc, jp, tp = setup
    prompt = _prompt(plen)
    bucket = ts.prompt_bucket(plen)
    assert bucket == 16
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :plen] = prompt
    exact, _ = ts.prefill_step(tc, tp, torch.from_numpy(prompt[None]),
                               window=W)
    tok, last, cache = ts.bucketed_prefill_step(
        tc, tp, torch.from_numpy(padded), plen, window=W)
    np.testing.assert_allclose(last.numpy(), exact.numpy(), atol=1e-5,
                               rtol=1e-5)
    assert int(tok[0]) == int(torch.argmax(exact[0]))
    assert int(cache["pos"][0]) == plen
    want_tok, want_last, want_cache = je.bucketed_prefill_step(
        jc, jp, {"tokens": jnp.asarray(padded)}, np.int32(plen), window=W)
    assert tok.tolist() == np.asarray(want_tok).tolist()
    _close(last, want_last)
    _caches_equal(tc, cache, want_cache)


def test_serve_step_matches_jax(setup):
    """Two prompts of different lengths, each prefilled and inserted into
    its slot of a batched rolling cache, then 6 greedy serve steps: the
    tokens, logits and caches of every step equal the reference's."""
    jc, tc, jp, tp = setup
    prompts = [_prompt(9, seed=3), _prompt(30, seed=4)]
    jcache = jm.init_cache(jc, 2, W)
    tcache = tm.init_cache(tc, 2, W, device="cpu")
    jtok, ttok = [], []
    for slot, p in enumerate(prompts):
        jl, js1 = je.prefill_step(jc, jp, {"tokens": jnp.asarray(p[None])},
                                  window=W)
        jcache = je.cache_insert(jcache, js1, slot, 2)
        jtok.append(int(jnp.argmax(jl[0])))
        tl, ts1 = ts.prefill_step(tc, tp, torch.from_numpy(p[None]),
                                  window=W)
        ts.cache_insert(tcache, ts1, slot)
        ttok.append(int(torch.argmax(tl[0])))
    assert ttok == jtok
    jt = jnp.asarray(jtok, jnp.int32)[:, None]
    tt = torch.tensor(ttok, dtype=torch.int32)[:, None]
    for _ in range(6):
        jn, jl, jcache = je.serve_step(jc, jp, jcache, {"tokens": jt})
        tn, tl, out = ts.serve_step(tc, tp, tcache, tt)
        assert out is tcache
        assert tn.dtype == torch.int32
        assert tn.tolist() == np.asarray(jn).tolist()
        _close(tl, jl)
        jt, tt = jn[:, None], tn[:, None]
    _caches_equal(tc, tcache, jcache)


@pytest.mark.parametrize("plen,sampling", [
    (11, None),
    (70, None),
    (11, dict(temperature=0.8, top_k=20, top_p=0.9, seed=7)),
])
def test_generate_matches_jax(setup, plen, sampling):
    """Greedy and seeded streams of ``generate`` equal the reference's
    (70 tokens: chunked prefill, chunks of 64, on both engines)."""
    jc, tc, jp, tp = setup
    prompt = _prompt(plen, seed=plen)
    want = js.generate(jc, jp, prompt, 8, window=128,
                       sampling=js.SamplingParams(**sampling)
                       if sampling else None)
    got = ts.generate(tc, tp, prompt, 8, window=128,
                      sampling=ts.SamplingParams(**sampling)
                      if sampling else None, device="cpu")
    assert len(got) == 8
    assert got == want


def test_timeit_returns_timed_samples():
    calls = []
    t = util.timeit(lambda x: calls.append(x), 3, iters=5, warmup=2,
                    device="cpu")
    assert isinstance(t, float) and isinstance(t, util.TimedSamples)
    assert calls == [3] * 7
    assert len(t.samples) == 5 and all(s >= 0 for s in t.samples)
    assert float(t) == pytest.approx(sum(t.samples) / 5)
    assert min(t.samples) <= t.median <= max(t.samples)
    assert util.TimedSamples(2.0, [1.0, 4.0, 2.0, 3.0]).median == 2.5
    assert util.TimedSamples(2.0, []).median == 2.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            util.timeit(lambda: None, device="cuda")
