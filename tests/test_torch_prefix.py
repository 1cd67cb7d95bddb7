"""The PyTorch port's shared-prefix KV cache (``prefix_cache=True``)
against the JAX package's, on granite-8b ``reduced()`` with two kv heads,
float32, the same converted weights.

Each test replays one sequence of the reference suite
(``tests/test_prefix_cache.py``: a synchronous suffix, a chunked suffix,
a copy-on-write tail shared three ways, suffix steps that share a width,
eviction under pool pressure, a churned workload, the load report and
``reset()``) on both engines, greedy and seeded, and compares what it
observes: streams, prefix-hit tokens, page refcounts and pool accounting,
probes, and the ``LoadReport`` wire dicts (less the cost model's seconds,
which price each package's own card). Streams must be token-identical."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import models as jm
from repro import serving as js
from repro.configs import get_config as jax_config
from repro.core.hardware import TPU_V5E
from repro.core.misd.scheduler import ChunkedPrefillPolicy as JaxPolicy
from repro.serving.telemetry import LoadReport as JaxLoadReport
from repro_torch import models as tm
from repro_torch import serving as ts
from repro_torch.configs import get_config as torch_config
from repro_torch.core.hardware import Chip
from repro_torch.core.misd.scheduler import ChunkedPrefillPolicy

torch.set_num_threads(2)

TPU = Chip(**dataclasses.asdict(TPU_V5E))
#: LoadReport fields priced by each package's own card
COST_FIELDS = ("backlog_s", "tick_est_s", "queued_prefill_s")


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


class _Run:
    """One package's engine and request factory for a scenario."""

    def __init__(self, setup, which, seeded, **kw):
        pkg, cfg, params, extra = setup[which]
        self.pkg = pkg
        if kw.get("chunk_prefill"):
            kw["prefill_policy"] = (
                JaxPolicy(chunk=kw["chunk_prefill"]) if pkg is js
                else ChunkedPrefillPolicy(chunk=kw["chunk_prefill"],
                                          chip=TPU))
        self.eng = pkg.ServingEngine(cfg, params, pkg.EngineConfig(**kw),
                                     **extra)
        self.seeded = seeded

    def request(self, rid, prompt, max_new, sampling_rid=None):
        pkg = self.pkg
        sp = (pkg.SamplingParams(temperature=0.8, top_k=20, top_p=0.9,
                                 seed=100 + (rid if sampling_rid is None
                                             else sampling_rid))
              if self.seeded else pkg.SamplingParams())
        return pkg.Request(rid, np.asarray(prompt, np.int32),
                           max_new_tokens=max_new, sampling=sp)

    def drive(self, reqs, t=0.0):
        for r in reqs:
            assert self.eng.try_admit(r, t)
        while not all(r.done for r in reqs):
            t += 1.0
            self.eng.step(t)
        self.eng.drain(t)
        return t

    def serve_each(self, prompts, budget=4, t=0.0):
        out = []
        for i, p in enumerate(prompts):
            r = self.request(1000 + i, p, budget)
            t = self.drive([r], t) + 1.0
            out.append(r)
        return out

    def report(self):
        d = self.eng.load_report().to_dict()
        return {k: v for k, v in d.items()
                if k not in COST_FIELDS + ("compile_events",)}


def _both(setup, seeded, scenario, **kw):
    """The scenario's observations on the JAX engine and on the port's."""
    return [scenario(_Run(setup, which, seeded, **kw))
            for which in ("jax", "torch")]


SEEDED = pytest.mark.parametrize("seeded", [False, True],
                                 ids=["greedy", "seeded"])


@SEEDED
def test_sync_suffix_hits_match_the_jax_engine(setup, seeded):
    """A 48-token template, then the template with 5, 9 and 17 more
    tokens: three hits of 48 tokens, each suffix in one step."""
    tpl = _prompt(48, seed=3)
    prompts = [tpl] + [np.concatenate([tpl, _prompt(n, seed=10 + n)])
                       for n in (5, 9, 17)]

    def scenario(run):
        reqs = run.serve_each(prompts)
        m = run.eng.metrics
        return ([r.output for r in reqs], [r.prefix_hit_tokens for r in reqs],
                m.prefix_hits, m.prefix_hit_tokens, run.eng.prefill_traces,
                run.eng.allocator.pages_in_use, run.report())

    want, got = _both(setup, seeded, scenario, slots=1, window=64,
                      max_seq=128, chunk_prefill=0, sync_every=2,
                      prefix_cache=True)
    assert got == want
    assert got[1] == [0, 48, 48, 48] and got[2] == 3


@SEEDED
def test_chunked_suffix_hit_matches_the_jax_engine(setup, seeded):
    """A 64-token template, then it with 40 more tokens: the suffix (past
    the 16-token chunk) rides the chunk path from offset 64."""
    tpl = _prompt(64, seed=4)
    long = np.concatenate([tpl, _prompt(40, seed=5)])

    def scenario(run):
        reqs = run.serve_each([tpl, long])
        return ([r.output for r in reqs], reqs[1].prefix_hit_tokens,
                run.eng.metrics.prefill_chunks, run.report())

    want, got = _both(setup, seeded, scenario, slots=2, window=64,
                      max_seq=256, chunk_prefill=16, prefix_cache=True)
    assert got == want and got[1] == 64


def test_cow_tail_shared_three_ways_matches_the_jax_engine(setup):
    """Three concurrent duplicates of a 2-page prompt alias its first page
    and each take a private copy of its tail: refcounts, streams, and the
    pool after the drain, as the reference's."""
    p = _prompt(32, seed=6)

    def scenario(run):
        eng = run.eng
        primer = run.request(9, p, 1)
        assert eng.try_admit(primer, 0.0)
        hit = eng.prefix_index.lookup(p)
        reqs = [run.request(i, p, 6) for i in range(3)]
        for r in reqs:
            assert eng.try_admit(r, 0.0)
        first = hit.full_pages[0]
        refs = (eng.allocator.refcount(first),
                eng.allocator.refcount(hit.tail_page))
        t = run.drive([], 0.0)
        while not all(r.done for r in reqs):
            t += 1.0
            eng.step(t)
        eng.drain(t)
        return (refs, [r.output for r in reqs],
                [r.prefix_hit_tokens for r in reqs],
                eng.allocator.refcount(first),
                eng.allocator.pages_in_use == eng.prefix_index.cached_pages)

    want, got = _both(setup, False, scenario, slots=3, window=64,
                      chunk_prefill=0, sync_every=2, prefix_cache=True)
    assert got == want
    assert got[0] == (4, 1) and got[2] == [31, 31, 31] and got[4]


def test_suffix_steps_share_their_width_like_the_jax_engine(setup):
    """Hits of different lengths inside one suffix width add no prefill
    trace (one captured step per width)."""
    base = _prompt(48, seed=7)

    def scenario(run):
        run.serve_each([base], budget=2)
        run.serve_each([np.concatenate([base, _prompt(3, seed=70)])],
                       budget=2)
        flat = run.eng.prefill_traces
        hits = [np.concatenate([base, _prompt(n, seed=71 + n)])
                for n in (5, 9, 11, 14)]
        reqs = run.serve_each(hits, budget=2)
        return (flat, run.eng.prefill_traces,
                [r.prefix_hit_tokens for r in reqs],
                [r.output for r in reqs])

    want, got = _both(setup, False, scenario, slots=1, window=64,
                      max_seq=128, chunk_prefill=0, prefix_cache=True)
    assert got == want and got[0] == got[1]


def test_eviction_and_churn_match_the_jax_engine(setup):
    """A pool filled with a cached prefix evicts it to admit fresh work;
    then waves of mixed cold, hit and evicting traffic conserve pages,
    and a cache clear returns every reference (the reference's eviction
    and zero-leak sequences)."""

    def evict(run):
        a = _prompt(30, seed=8)
        run.serve_each([a], budget=2)
        cached = run.eng.prefix_index.cached_pages
        b = run.request(50, _prompt(40, seed=9), 20)
        run.drive([b])
        return (cached, b.output, run.eng.metrics.prefix_hits,
                run.eng.allocator.pages_in_use
                == run.eng.prefix_index.cached_pages)

    want, got = _both(setup, False, evict, slots=1, window=64, pool_pages=7,
                      chunk_prefill=0, prefix_cache=True)
    assert got == want and got[0] == 1 and got[3]

    def churn(run):
        eng = run.eng
        tpls = [_prompt(32, seed=s) for s in (20, 21)]
        rng = np.random.default_rng(0)
        t, outs, held = 0.0, [], []
        for wave in range(4):
            reqs = []
            for i in range(3):
                tpl = tpls[int(rng.integers(0, 2))]
                sfx = rng.integers(0, 500, int(rng.integers(0, 9)))
                p = np.concatenate([tpl, sfx]).astype(np.int32)
                reqs.append(run.request(100 * wave + i, p,
                                        int(rng.integers(1, 5))))
            for r in reqs:
                eng.submit(r, t)
            while not all(r.done for r in reqs):
                t += 1.0
                eng.step(t)
            eng.drain(t)
            outs.append([r.output for r in reqs])
            held.append((eng.allocator.pages_in_use,
                         eng.prefix_index.cached_pages))
        hits = eng.metrics.prefix_hits
        eng.clear_prefix_cache()
        return (outs, held, hits, eng.allocator.pages_in_use,
                eng.allocator.total_refs, eng.allocator.free_pages)

    want, got = _both(setup, True, churn, slots=2, window=64, max_seq=64,
                      pool_pages=17, chunk_prefill=0, sync_every=2,
                      prefix_cache=True)
    assert got == want
    assert all(a == b for a, b in got[1]) and got[2] > 0
    assert got[3:] == (0, 0, 16)


def test_prefix_cache_requires_pages_as_in_the_reference():
    """recurrentgemma cannot page: both engines refuse a prefix cache with
    the reference's message."""
    msgs = []
    for pkg, get in ((js, jax_config), (ts, torch_config)):
        cfg = get("recurrentgemma-9b").reduced()
        init = jm.init_params if pkg is js else tm.init_params
        params = (init(cfg, jax.random.key(0)) if pkg is js
                  else init(cfg, seed=0, device="cpu"))
        kw = {} if pkg is js else dict(device="cpu")
        with pytest.raises(ValueError, match="prefix_cache") as e:
            pkg.ServingEngine(cfg, params, pkg.EngineConfig(
                slots=1, prefix_cache=True), **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_load_report_and_reset_match_the_jax_engine(setup):
    """A hit's counters in the load report, its wire dict (read back by
    the reference's ``LoadReport.from_dict``), ``prefix_match_len``, and
    ``reset()`` clearing the index and every reference."""

    def scenario(run):
        eng = run.eng
        p = _prompt(32, seed=11)
        run.serve_each([p, p], budget=2)
        rep = run.report()
        match = eng.prefix_match_len(p)
        eng.reset()
        return (rep, match, eng.allocator.pages_in_use,
                eng.allocator.total_refs, run.report())

    want, got = _both(setup, False, scenario, slots=1, window=64,
                      chunk_prefill=0, prefix_cache=True)
    assert got == want
    rep = got[0]
    assert rep["prefix_hits"] == 1 and rep["prefix_hit_tokens"] == 31
    assert rep["prefix_cached_tokens"] == rep["prefix_cached_pages"] * 16
    assert got[1] == 31 and got[2:4] == (0, 0)
    assert got[4]["prefix_cached_pages"] == 0 and got[4]["prefix_hits"] == 0
    back = JaxLoadReport.from_dict(dict(rep, backlog_s=0.0, tick_est_s=0.0,
                                        queued_prefill_s=0.0))
    assert back.prefix_hits == 1
