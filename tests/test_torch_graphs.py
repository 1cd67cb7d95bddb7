"""The port's compiled-step layer (``repro_torch.serving.graphs``) on the
CPU, against the JAX engine's jit caches, on granite-8b ``reduced()`` with
two kv heads and the same converted weights.

On the CPU every step runs eagerly, but the probes count the same keys as
on the card: ``prefill_traces`` and ``decode_traces`` must equal the JAX
engine's on the reference suite's probe sequences (``tests/test_paging.py``
``test_paged_single_trace_probes``, ``tests/test_serving_engine.py``
``test_bucketed_prefill_single_trace``, ``tests/test_sampling.py``
``test_mixed_batch_single_decode_trace``). ``reset()`` keeps the probes
and the cache tensors and gives the same streams again; streams stay
token-identical to the JAX engine at ``sync_every`` 1, 3 and 8 with
staggered arrivals, which mix single ticks with fused windows."""
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
from repro_torch.serving.graphs import StepGraphs

torch.set_num_threads(2)

SP = dict(temperature=0.8, top_k=20, top_p=0.95, seed=7)


@pytest.fixture(scope="module")
def setup():
    jc = dataclasses.replace(jax_config("granite-8b").reduced(),
                             num_kv_heads=2)
    tc = dataclasses.replace(torch_config("granite-8b").reduced(),
                             num_kv_heads=2)
    jp = jm.init_params(jc, jax.random.key(0))
    tp = tm.params_from_jax(tc, jax.tree.map(np.asarray, jp), "cpu")
    return {"jax": (js, jc, jp, {}),
            "torch": (ts, tc, tp, dict(
                device="cpu", threefry_partitionable=bool(
                    jax.config.jax_threefry_partitionable)))}


def _prompt(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 500, n).astype(np.int32)


def _engine(setup, which, **kw):
    pkg, cfg, params, extra = setup[which]
    kw.setdefault("chunk_prefill", 0)
    return pkg.ServingEngine(cfg, params, pkg.EngineConfig(**kw), **extra)


def _request(which, rid, prompt, max_new, sampling=None):
    pkg = js if which == "jax" else ts
    sp = pkg.SamplingParams(**sampling) if sampling else pkg.SamplingParams()
    return pkg.Request(rid=rid, prompt=prompt, max_new_tokens=max_new,
                       sampling=sp)


def _until_done(eng, reqs, t=0.0):
    while not all(r.done for r in reqs):
        t += 1.0
        eng.step(t)
    eng.drain(t)
    return t


@pytest.mark.parametrize("paged", [True, False])
def test_one_trace_per_bucket_and_two_decode_traces(setup, paged):
    """tests/test_paging.py::test_paged_single_trace_probes, through both
    engines (rolling caches too): prompts of 9-16 tokens share one bucket,
    decode takes one tick and one window, and a 17-token prompt costs
    exactly one more prefill trace."""
    probes = {}
    for which in ("jax", "torch"):
        eng = _engine(setup, which, slots=4, window=128, sync_every=4,
                      paged=paged)
        reqs = [_request(which, i, _prompt(p, seed=i), 12)
                for i, p in enumerate((9, 12, 15, 16))]
        for r in reqs:
            assert eng.try_admit(r, 0.0)
        seen = [eng.prefill_traces]
        t = _until_done(eng, reqs)
        seen.append(eng.decode_traces)
        assert eng.try_admit(_request(which, 9, _prompt(17, seed=9), 4), t)
        seen.append(eng.prefill_traces)
        probes[which] = seen
    assert probes["torch"] == probes["jax"]
    assert probes["torch"] == [1, 2, 2]


def test_bucketed_prefill_single_trace(setup):
    """tests/test_serving_engine.py::test_bucketed_prefill_single_trace:
    every prompt length inside one bucket shares one trace, and a new
    bucket costs exactly one more."""
    got = {}
    for which in ("jax", "torch"):
        eng = _engine(setup, which, slots=4, window=128)
        for i, plen in enumerate((9, 12, 15, 16)):
            assert eng.try_admit(_request(which, i, _prompt(plen, seed=i), 4),
                                 0.0)
        eng2 = _engine(setup, which, slots=4, window=128)
        for i, plen in enumerate((9, 17)):
            assert eng2.try_admit(
                _request(which, i, _prompt(plen, seed=i), 4), 0.0)
        got[which] = (eng.prefill_traces, eng2.prefill_traces)
    assert got["torch"] == got["jax"] == (1, 2)


def _mixed_round(setup, which, eng, sampling):
    reqs = [_request(which, rid, _prompt(10 + rid % 3, seed=rid), 8,
                     sampling(rid))
            for rid in range(4)]
    for r in reqs:
        eng.submit(r, 0.0)
    _until_done(eng, reqs)
    return [r.output for r in reqs]


def test_mixed_batch_single_decode_trace(setup):
    """tests/test_sampling.py::test_mixed_batch_single_decode_trace: greedy
    and seeded slots share one tick and one window; admitting more seeded
    traffic onto the warm engine (after ``reset``) adds no decode trace."""
    got = {}
    for which in ("jax", "torch"):
        eng = _engine(setup, which, slots=4, window=64, sync_every=4)
        outs = _mixed_round(setup, which, eng,
                            lambda rid: SP if rid % 2 else None)
        probes = [eng.decode_traces, eng.prefill_traces,
                  eng.metrics.sampled_requests]
        eng.reset()
        outs2 = _mixed_round(setup, which, eng, lambda rid: SP)
        probes += [eng.decode_traces, eng.prefill_traces]
        got[which] = (outs, outs2, probes)
    assert got["torch"] == got["jax"]
    assert got["torch"][2] == [2, 1, 2, 2, 1]


@pytest.mark.parametrize("paged", [True, False])
def test_reset_keeps_steps_and_gives_the_same_streams(setup, paged):
    """``reset()`` after a round: the same requests give token-identical
    streams, the probes do not move, the cache tensors keep their storage
    (the graphs hold their addresses), and the pool's free count is a
    fresh engine's."""
    lens = (5, 23, 40, 17, 9)

    def round_(eng):
        reqs = [_request("torch", i, _prompt(n, seed=i), 10,
                         SP if i % 2 else None)
                for i, n in enumerate(lens)]
        for r in reqs:
            eng.submit(r, 0.0)
        _until_done(eng, reqs)
        return [r.output for r in reqs]

    kw = dict(slots=3, window=64, max_seq=128, sync_every=4, paged=paged)
    eng = _engine(setup, "torch", **kw)
    fresh = _engine(setup, "torch", **kw)
    free0 = fresh.allocator.free_pages if paged else None
    leaves = [t.data_ptr() for c in eng.cache["layers"] for t in c.values()]
    leaves += [eng.cache["pos"].data_ptr(), eng._tokens.data_ptr(),
               eng._hist.data_ptr()]
    first = round_(eng)
    probes = (eng.prefill_traces, eng.decode_traces)
    assert eng.metrics.completed == len(lens)
    eng.reset()
    assert eng.idle and eng.metrics.completed == 0
    assert int(eng.cache["pos"].abs().sum()) == 0
    if paged:
        assert eng.allocator.free_pages == free0
        assert int(eng.cache["page_table"].abs().sum()) == 0
    second = round_(eng)
    assert second == first == round_(fresh)
    assert (eng.prefill_traces, eng.decode_traces) == probes
    after = [t.data_ptr() for c in eng.cache["layers"] for t in c.values()]
    after += [eng.cache["pos"].data_ptr(), eng._tokens.data_ptr(),
              eng._hist.data_ptr()]
    assert after == leaves
    if paged:
        assert eng.allocator.free_pages == fresh.allocator.free_pages \
            == free0


# arrival tick, prompt length, new tokens
STAGGER = [(0, 5, 14), (0, 23, 9), (2, 40, 12), (5, 17, 10), (9, 9, 11)]


@pytest.mark.parametrize("mode", ["greedy", "mixed"])
@pytest.mark.parametrize("sync_every", [1, 3, 8])
def test_streams_match_the_jax_engine_under_staggered_arrivals(
        setup, sync_every, mode):
    """Arrivals between windows force single ticks (and flushes) between
    fused windows: the carry, the position and the deferred-token buffer
    must go on exactly as the reference's."""
    outs = {}
    for which in ("jax", "torch"):
        eng = _engine(setup, which, slots=3, max_seq=128,
                      sync_every=sync_every)
        reqs = [_request(which, i, _prompt(n, seed=10 + i), new,
                         dict(SP, seed=100 + i)
                         if mode == "mixed" and i % 2 else None)
                for i, (_, n, new) in enumerate(STAGGER)]
        t, pending = 0.0, list(zip(STAGGER, reqs))
        while pending or not all(r.done for r in reqs):
            while pending and pending[0][0][0] <= t:
                eng.submit(pending.pop(0)[1], t)
            eng.step(t)
            t += 1.0
            assert t < 500
        eng.drain(t)
        outs[which] = [r.output for r in reqs]
        if which == "torch":
            assert eng.decode_traces <= 2 and eng.metrics.decode_ticks > 0
            assert all(len(r.output) == new
                       for r, (_, _, new) in zip(reqs, STAGGER))
    assert outs["torch"] == outs["jax"]


def test_step_cache_on_the_cpu_counts_keys_and_runs_eagerly():
    """On the CPU a step runs at every call; its key counts once into its
    probe; an unknown kind is refused."""
    g = StepGraphs("cpu")
    calls = []
    for n in (16, 16, 32, 16):
        assert g.run("prefill", "paged", n, lambda: calls.append(n) or n) \
            == n
    for _ in range(3):
        g.run("decode", "tick", 1, lambda: calls.append("t"))
    assert len(calls) == 7
    assert (g.prefill_traces, g.decode_traces, g.captures) == (2, 1, 0)
    assert g.keys == [("prefill", "paged", 16), ("prefill", "paged", 32),
                      ("decode", "tick", 1)]
    with pytest.raises(ValueError, match="kind"):
        g.run("train", "x", 1, lambda: None)
