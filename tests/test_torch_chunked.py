"""Chunked prefill of the PyTorch port against the JAX package's, on
granite-8b ``reduced()`` with two kv heads, float32, the same converted
weights; prompts from numpy seeds.

- ``prefill_chunk_step``: chunk by chunk, the port builds the JAX step's
  B=1 linear cache (within 2e-5; under int8 KV its codes may take the
  neighbouring code where the packages' float32 K/V straddle a rounding
  boundary, as ``tests/test_torch_quant.py`` documents), its position and
  its first token.
- Engine streams with chunk 16, greedy and seeded: paged, ``paged=False``
  (chunks over the window's ring) and int8 KV pages, token-identical to
  the JAX engine, with the same chunk count, page accounting and probes.
  Both engines take the reference's chip constants for
  ``ChunkedPrefillPolicy``, so both interleave chunks alike.
- ``ChunkedPrefillPolicy.chunks_this_tick`` and ``estimate_backlog_s``
  equal the reference's at the same chip constants.
- The default chunk size is the reference's 64, in ``EngineConfig`` and
  in the serve CLI (on the parent tree it was 0 and the CLI had no
  flag)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro import serving as js
from repro.configs import get_config as jax_config
from repro.core.costmodel import estimate_backlog_s as jax_backlog_s
from repro.core.hardware import TPU_V5E
from repro.core.misd.scheduler import ChunkedPrefillPolicy as JaxPolicy
from repro.serving import engine as je
from repro_torch import models as tm
from repro_torch import serving as ts
from repro_torch.configs import get_config as torch_config
from repro_torch.core.costmodel import estimate_backlog_s
from repro_torch.core.hardware import Chip
from repro_torch.core.misd.scheduler import ChunkedPrefillPolicy
from repro_torch.launch import serve as tserve
from repro_torch.serving import engine as te

torch.set_num_threads(2)

#: the reference's chip constants, in the port's Chip type
TPU = Chip(**dataclasses.asdict(TPU_V5E))
CHUNK = 16
LENS = [5, 23, 40, 70, 100, 33]


@pytest.fixture(scope="module")
def setup():
    jc = dataclasses.replace(jax_config("granite-8b").reduced(),
                             num_kv_heads=2)
    tc = dataclasses.replace(torch_config("granite-8b").reduced(),
                             num_kv_heads=2)
    jp = jm.init_params(jc, jax.random.key(0))
    tp = tm.params_from_jax(tc, jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jc.vocab_size, n).astype(np.int32)
               for n in LENS]
    return jc, tc, jp, tp, prompts


def _code_flips(t_codes, j_codes):
    diff = np.abs(t_codes.numpy().astype(np.int32)
                  - np.asarray(j_codes).astype(np.int32))
    assert diff.max(initial=0) <= 1
    return int((diff > 0).sum())


def test_default_chunk_size_is_the_references(capsys):
    """``EngineConfig()`` chunks like the reference's, and the serve CLI's
    ``--chunk-prefill`` defaults to 64 ("0 = single-shot")."""
    assert ts.EngineConfig().chunk_prefill == 64
    assert ts.EngineConfig().chunk_prefill == js.EngineConfig().chunk_prefill
    common = ["--arch", "granite-8b", "--reduced", "--device", "cpu",
              "--requests", "2", "--slots", "2", "--rate", "1000",
              "--prompt-len", "80", "--max-new", "3", "--max-seq", "256"]
    tserve.main(common)
    out = capsys.readouterr().out
    assert "prefill_chunks=4" in out  # 80 tokens -> 2 chunks of 64 each
    tserve.main(common + ["--chunk-prefill", "0"])
    assert "prefill_chunks=0" in capsys.readouterr().out


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_chunk_steps_build_the_jax_linear_cache(setup, kv_dtype):
    """A 40-token prompt in chunks of 16 (the last one padded) over a
    (1, 64) linear buffer: the K/V rows, the position and the first
    token's logits of the JAX ``prefill_chunk_step``."""
    jc, tc, jp, tp, _ = setup
    rng = np.random.default_rng(11)
    padded = np.zeros((1, 48), np.int32)
    padded[0, :40] = rng.integers(0, jc.vocab_size, 40)
    jcache = jm.init_cache(jc, 1, 64, kv_dtype)
    tcache = tm.init_cache(tc, 1, 64, device="cpu", kv_dtype=kv_dtype)
    for off in range(0, 48, CHUNK):
        chunk = padded[:, off:off + CHUNK]
        jtok, jlast, jcache = je.prefill_chunk_step(
            jc, jp, jcache, jnp.asarray(chunk), np.int32(40))
        ttok, tlast = te.prefill_chunk_step(
            tc, tp, tcache, torch.from_numpy(chunk), 40)
        if off <= 39 < off + CHUNK:
            np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast),
                                       atol=2e-5 if not kv_dtype else 5e-3)
            assert ttok.tolist() == np.asarray(jtok).tolist()
    ref = tm.cache_from_jax(tc, jax.tree.map(np.asarray, jcache), "cpu")
    assert tcache["pos"].tolist() == ref["pos"].tolist() == [40]
    flips = 0
    for got, want in zip(tcache["layers"], ref["layers"]):
        assert set(got) == set(want)
        for name in ("k", "v"):
            if kv_dtype:
                flips += _code_flips(got[name], want[name])
                np.testing.assert_allclose(got[name + "_scale"].numpy(),
                                           want[name + "_scale"].numpy(),
                                           rtol=2e-5)
            else:
                np.testing.assert_allclose(got[name].numpy(),
                                           want[name].numpy(), atol=2e-5)
    assert flips <= 4


def _policy(pkg):
    if pkg is js:
        return JaxPolicy(chunk=CHUNK)
    return ChunkedPrefillPolicy(chunk=CHUNK, chip=TPU)


def _serve(pkg, cfg, params, prompts, seeded, config, **kw):
    eng = pkg.ServingEngine(cfg, params, pkg.EngineConfig(
        slots=3, max_seq=128, window=128, sync_every=4,
        prefill_policy=_policy(pkg), **config), **kw)
    reqs = [pkg.Request(rid=i, prompt=p, max_new_tokens=10,
                        sampling=(pkg.SamplingParams(
                            temperature=0.8, top_k=20, top_p=0.9,
                            seed=500 + i)
                            if seeded(i) else pkg.SamplingParams()))
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r, 0.0)
    t = 0.0
    while not all(r.done for r in reqs) and t < 500:
        t += 1.0
        eng.step(t)
    eng.drain(t)
    return reqs, eng


@pytest.mark.parametrize("mode", ["greedy", "mixed"])
@pytest.mark.parametrize("path", ["paged", "rolling", "int8"])
def test_chunked_streams_match_the_jax_engine(setup, path, mode):
    """Six prompts of 5-100 tokens on 3 slots with chunk 16: the three
    long ones prefill in chunks between decode ticks."""
    jc, tc, jp, tp, prompts = setup
    config = {"paged": dict(), "rolling": dict(paged=False),
              "int8": {}}[path]
    seeded = (lambda i: False) if mode == "greedy" else (lambda i: i % 2)
    jconf, tconf = dict(config), dict(config)
    if path == "int8":
        jconf["precision"] = js.PrecisionConfig(kv_cache_dtype="int8")
        tconf["precision"] = ts.PrecisionConfig(kv_cache_dtype="int8")
    want, jeng = _serve(js, jc, jp, prompts, seeded, jconf)
    got, teng = _serve(ts, tc, tp, prompts, seeded, tconf, device="cpu",
                       threefry_partitionable=bool(
                           jax.config.jax_threefry_partitionable))
    assert [r.output for r in got] == [r.output for r in want]
    assert all(r.state.value == "finished" and len(r.output) == 10
               for r in got)
    assert teng.metrics.prefill_chunks == jeng.metrics.prefill_chunks > 0
    assert teng.metrics.decode_ticks == jeng.metrics.decode_ticks
    assert teng.prefill_traces == jeng.prefill_traces
    assert teng.decode_traces == jeng.decode_traces
    assert teng.compile_events["prefill/chunk16"] == 1
    assert jeng.compile_events["prefill/chunk16"] >= 1
    assert teng.idle and teng.n_prefilling == 0
    if path != "rolling":
        assert teng.allocator.pages_in_use == 0
        assert int(teng.cache["page_table"].abs().sum()) == 0


def test_chunked_prefill_policy_and_backlog_match_the_reference(setup):
    """``chunks_this_tick`` over decode loads, pending chunks and
    contexts, and ``estimate_backlog_s``, at the reference's constants;
    the port's default card is the H100."""
    jc, tc, *_ = setup
    full_j, full_t = jax_config("granite-8b"), torch_config("granite-8b")
    for (cj, ct) in ((jc, tc), (full_j, full_t)):
        for chunk in (16, 64):
            jpol, tpol = JaxPolicy(chunk=chunk), ChunkedPrefillPolicy(
                chunk=chunk, chip=TPU)
            for n_dec in (0, 1, 3, 8):
                for pending in (0, 1, 5, 40):
                    for ctx in (64, 1024):
                        kw = dict(n_decoding=n_dec, pending_chunks=pending,
                                  context=ctx)
                        assert (tpol.chunks_this_tick(ct, **kw)
                                == jpol.chunks_this_tick(cj, **kw))
            for q_pref, dec in ((0, 0), (100, 0), (0, 50), (700, 300)):
                kw = dict(queued_prefill_tokens=q_pref,
                          decode_tokens_remaining=dec, slots=8, context=512)
                assert estimate_backlog_s(ct, chip=TPU, **kw) == \
                    pytest.approx(jax_backlog_s(cj, **kw), rel=1e-12)
    assert ChunkedPrefillPolicy().chip.name == "h100-sxm"
