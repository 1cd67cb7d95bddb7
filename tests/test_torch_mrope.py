"""qwen2-vl-7b's M-RoPE in the PyTorch port against the JAX package:
three position streams (temporal, height, width), each over its section
of the head's D/2 frequencies (16, 24, 24 at full width; 4, 6, 6 in
``reduced()``), ``reduced()`` in float32 on the same converted weights.

Compared: the rotation of q/k by distinct streams against the reference's
``apply_rope`` (2e-5, the reference suite's float32 tolerance) at the
reduced and the full head width; equal streams give the standard
variant's table bit for bit (built from the three streams all the same);
prefill logits with an early-fusion ``patches`` prefix and distinct
streams, and paged decode logits with explicit (3, B, S) positions (also
2e-5); engine streams, greedy and seeded, single-shot and
chunked, token-identical to the JAX engine; and the reference's check
that decode builds the positions on the device (few host syncs)."""
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
from repro.core.misd.scheduler import ChunkedPrefillPolicy as JaxPolicy
from repro.models import layers as JL
from repro.serving import engine as je
from repro_torch import models as tm
from repro_torch import serving as ts
from repro_torch.configs import get_config as torch_config
from repro_torch.core.hardware import Chip
from repro_torch.core.misd.scheduler import ChunkedPrefillPolicy
from repro_torch.models import layers as TL
from repro_torch.serving import engine as te

torch.set_num_threads(2)
TOL = 2e-5
TPU = Chip(**dataclasses.asdict(TPU_V5E))
NAME = "qwen2-vl-7b"


def _np(t):
    return t.detach().numpy()


@pytest.fixture(scope="module")
def qwen():
    jc, tc = jax_config(NAME).reduced(), torch_config(NAME).reduced()
    jp = jm.init_params(jc, jax.random.key(0))
    tp = tm.params_from_jax(tc, jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


def _streams(rng, b, s, hi=4096):
    """Three distinct position streams below ``hi``, as a vision frontend
    gives them: temporal steps, and height/width grids."""
    return np.stack([rng.integers(0, hi, (b, s)) for _ in range(3)]
                    ).astype(np.int32)


@pytest.mark.parametrize("full", [False, True])
def test_mrope_matches_jax_on_distinct_streams(full):
    """At full width the streams stay below 128: at D 128, XLA's and
    torch's float32 ``exp`` give two of the 64 frequencies one ulp apart
    (the arguments are equal), and an angle carries that as p * ulp(f),
    1.3e-4 at p ~ 2000, as the standard variant's does (ROADMAP.md queue
    3, documented tolerances); below 128 it stays under 1e-5."""
    jc, tc = jax_config(NAME), torch_config(NAME)
    if not full:
        jc, tc = jc.reduced(), tc.reduced()
    d = tc.resolved_head_dim
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 9, 3, d)).astype(np.float32)
    pos = _streams(rng, 2, 9, hi=128 if full else 4096)
    want = np.asarray(JL.apply_rope(jc, jnp.asarray(x), jnp.asarray(pos)))
    got = TL.apply_rope(tc, torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(_np(got), want, atol=TOL, rtol=0)
    # each stream moves only its own section of the frequencies
    sec = tc.mrope_sections
    cos_a, _ = TL.rope_table(tc, torch.from_numpy(pos))
    pos_b = pos.copy()
    pos_b[1] += 7  # the height stream only
    cos_b, _ = TL.rope_table(tc, torch.from_numpy(pos_b))
    moved = (cos_a != cos_b)[0, 0, 0, :d // 2]
    assert not moved[:sec[0]].any() and not moved[sec[0] + sec[1]:].any()
    assert moved[sec[0]:sec[0] + sec[1]].all()
    with pytest.raises(ValueError, match=r"\(3, B, S\)"):
        TL.rope_table(tc, torch.from_numpy(pos[0]))


@pytest.mark.parametrize("full", [False, True])
def test_mrope_on_equal_streams_is_the_standard_table_bit_for_bit(full):
    tc = torch_config(NAME)
    if not full:
        tc = tc.reduced()
    std = dataclasses.replace(tc, rope_variant="standard")
    pos = torch.from_numpy(
        np.random.default_rng(1).integers(0, 1 << 16, (2, 33)))
    got = TL.rope_table(tc, pos[None].expand(3, 2, 33))
    want = TL.rope_table(std, pos)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_forward_with_patches_matches_jax(qwen):
    """Early fusion: 5 patch embeddings ahead of 11 text tokens, under
    three distinct streams over all 16 positions."""
    jc, tc, jp, tp = qwen
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jc.vocab_size, (2, 11)).astype(np.int32)
    patches = rng.standard_normal((2, 5, jc.d_model)).astype(np.float32)
    pos = _streams(rng, 2, 16)
    want, _, _ = jm.forward(jc, jp, {"tokens": jnp.asarray(tokens),
                                     "patches": jnp.asarray(patches),
                                     "positions": jnp.asarray(pos)},
                            mode="prefill")
    got, _ = tm.forward(tc, tp, torch.from_numpy(tokens),
                        patches=torch.from_numpy(patches),
                        positions=torch.from_numpy(pos))
    assert got.shape == (2, 16, jc.vocab_size)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL, rtol=0)
    with pytest.raises(ValueError, match="mrope needs"):
        tm.forward(tc, tp, torch.from_numpy(tokens))


def test_paged_decode_with_explicit_positions_matches_jax(qwen):
    """A 21-token prompt in pages 3 and 5 of slot 0 (slot 1 released),
    then 3 decode steps at three distinct streams."""
    jc, tc, jp, tp = qwen
    ps, n_pool, max_pages, plen = 16, 8, 4, 21
    rng = np.random.default_rng(11)
    prompt = np.zeros((1, 32), np.int32)
    prompt[0, :plen] = rng.integers(0, jc.vocab_size, plen)
    pos32 = np.broadcast_to(np.arange(32, dtype=np.int32), (3, 1, 32))
    _, _, lin = je.paged_prefill_step(
        jc, jp, {"tokens": jnp.asarray(prompt),
                 "positions": jnp.asarray(pos32)}, plen)
    pages = np.array([3, 5], np.int32)
    jcache = jm.init_paged_cache(jc, 2, n_pool, ps, max_pages)
    jcache = je.pages_insert(jcache, lin, jnp.asarray(pages), 0, plen)
    jcache = je.page_table_append(jcache, 0, 2, 6)
    _, _, kv = te.paged_prefill_step(tc, tp, torch.from_numpy(prompt), plen)
    tcache = tm.init_paged_cache(tc, 2, n_pool, ps, max_pages, device="cpu")
    te.pages_insert(tcache, kv, torch.from_numpy(pages).long(), 0, plen)
    te.page_table_append(tcache, 0, 2, 6)
    for _ in range(3):
        toks = rng.integers(0, jc.vocab_size, (2, 1)).astype(np.int32)
        pos = _streams(rng, 2, 1)
        want, jcache = jm.decode_step(jc, jp, jcache,
                                      {"tokens": jnp.asarray(toks),
                                       "positions": jnp.asarray(pos)})
        got = tm.decode_step(tc, tp, tcache, torch.from_numpy(toks),
                             positions=torch.from_numpy(pos))
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL,
                                   rtol=0)


def _serve(pkg, cfg, params, prompts, chunk):
    extra = ({} if pkg is js else dict(
        device="cpu", threefry_partitionable=bool(
            jax.config.jax_threefry_partitionable)))
    policy = None
    if chunk:
        policy = (JaxPolicy(chunk=chunk) if pkg is js
                  else ChunkedPrefillPolicy(chunk=chunk, chip=TPU))
    eng = pkg.ServingEngine(cfg, params, pkg.EngineConfig(
        slots=3, max_seq=256, chunk_prefill=chunk, prefill_policy=policy),
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


@pytest.mark.parametrize("chunk", [0, 64])
def test_streams_match_the_jax_engine(qwen, chunk):
    """Paged KV, single-shot (buckets) or the reference's default chunk
    64 (a 100- and a 150-token prompt chunked, the others bucketed)."""
    jc, tc, jp, tp = qwen
    rng = np.random.default_rng(chunk + 2)
    prompts = [rng.integers(0, jc.vocab_size, n).astype(np.int32)
               for n in (5, 23, 100, 150)]
    want, jeng = _serve(js, jc, jp, prompts, chunk)
    got, teng = _serve(ts, tc, tp, prompts, chunk)
    assert [r.output for r in got] == [r.output for r in want]
    assert all(len(r.output) == 10 for r in got)
    assert teng.metrics.prefill_chunks == jeng.metrics.prefill_chunks
    assert bool(teng.metrics.prefill_chunks) == bool(chunk)


def test_mrope_decode_on_device(qwen):
    """The reference's check: the decode path builds the positions from
    the cache's ``pos`` on the device (no per-tick host round trip) and
    still decodes: fused windows of 4, at most one host sync per two
    ticks."""
    _, tc, _, tp = qwen
    req = ts.Request(rid=0, prompt=np.random.default_rng(0).integers(
        0, 500, 10).astype(np.int32), max_new_tokens=8)
    eng = ts.ServingEngine(tc, tp, ts.EngineConfig(
        slots=2, window=64, sync_every=4), device="cpu")
    assert eng.try_admit(req, 0.0)
    t = 0.0
    while not req.done:
        t += 1.0
        eng.step(t)
    assert len(req.output) == 8
    assert eng.metrics.host_syncs <= eng.metrics.decode_ticks / 2
    pos = te.mrope_positions(tc, eng.cache["pos"], 1)
    assert pos.shape == (3, 2, 1) and pos.device == eng.cache["pos"].device
