"""The PyTorch port's ServingEngine (repro_torch.serving) against the JAX
package's (repro.serving) on granite-8b ``reduced()`` with two kv heads,
on the same converted weights: 4 requests of mixed prompt length on 3
slots, single-shot prefill (``chunk_prefill=0``), paged KV. Streams must
be token-identical, greedy and seeded; seeded streams use the port's
threefry in the installed jax's ``jax_threefry_partitionable`` mode.

Also: ``EngineConfig.validate`` refuses every option the port does not
serve yet, naming its ROADMAP.md item, accepts those it serves (keeping
the reference's own refusals), and the CPU run of the serve CLI."""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import models as jm
from repro import serving as js
from repro.configs import get_config as jax_config
from repro.serving import engine as je
from repro_torch import models as tm
from repro_torch import serving as ts
from repro_torch.configs import get_config as torch_config
from repro_torch.launch import serve as tserve
from repro_torch.serving import engine as te

torch.set_num_threads(2)

LENS = [5, 23, 40, 17]


@pytest.fixture(scope="module")
def setup():
    jc = dataclasses.replace(jax_config("granite-8b").reduced(),
                             num_kv_heads=2)
    tc = dataclasses.replace(torch_config("granite-8b").reduced(),
                             num_kv_heads=2)
    jp = jm.init_params(jc, jax.random.key(0))
    tp = tm.params_from_jax(tc, jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jc.vocab_size, n).astype(np.int32)
               for n in LENS]
    return jc, tc, jp, tp, prompts


def _serve(pkg, cfg, params, prompts, seeded, **kw):
    eng = pkg.ServingEngine(cfg, params,
                            pkg.EngineConfig(slots=3, chunk_prefill=0,
                                             max_seq=128), **kw)
    reqs = [pkg.Request(rid=i, prompt=p, max_new_tokens=12,
                        sampling=(pkg.SamplingParams(
                            temperature=0.8, top_k=20, top_p=0.9,
                            seed=1000 + i)
                            if seeded(i) else pkg.SamplingParams()))
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r, 0.0)
    t, done = 0.0, 0
    while done < len(reqs) and t < 500:
        t += 1.0
        done += len(eng.step(t))
    eng.drain(t)
    return reqs, eng


@pytest.mark.parametrize("mode", ["greedy", "seeded", "mixed"])
def test_streams_match_the_jax_engine(setup, mode):
    jc, tc, jp, tp, prompts = setup
    seeded = {"greedy": lambda i: False, "seeded": lambda i: True,
              "mixed": lambda i: i % 2 == 1}[mode]
    want, jeng = _serve(js, jc, jp, prompts, seeded)
    got, teng = _serve(ts, tc, tp, prompts, seeded, device="cpu",
                       threefry_partitionable=bool(
                           jax.config.jax_threefry_partitionable))
    assert [r.output for r in got] == [r.output for r in want]
    assert all(len(r.output) == 12 and r.state.value == "finished"
               for r in got)
    assert teng.metrics.completed == jeng.metrics.completed == 4
    assert (teng.metrics.sampled_requests
            == jeng.metrics.sampled_requests)
    # every page went back to the pool, every row to the trash page
    assert teng.allocator.pages_in_use == 0
    assert int(teng.cache["page_table"].abs().sum()) == 0


def test_decode_scan_is_n_ticks(setup):
    """The fused window (one host sync) gives the ticks' tokens, and
    leaves the cache where n single ticks leave it."""
    _, tc, _, tp, prompts = setup
    eng = ts.ServingEngine(tc, tp, ts.EngineConfig(slots=2, max_seq=64),
                           device="cpu")
    for i in range(2):
        eng.submit(ts.Request(rid=i, prompt=prompts[i], max_new_tokens=30,
                              sampling=ts.SamplingParams(
                                  temperature=0.9, top_k=8, seed=7 + i)),
                   0.0)
    eng._ensure_headroom(4)
    cache, samp, toks = eng.cache, eng._samp, eng._tokens
    c1 = copy.deepcopy(cache)
    t1 = toks
    singles = []
    for _ in range(4):
        t1 = te.decode_tick(tc, tp, c1, t1, samp)
        singles.append(t1)
    c2 = copy.deepcopy(cache)
    t2, hist = te.decode_scan_step(tc, tp, c2, toks, samp, n=4)
    np.testing.assert_array_equal(hist.numpy(), torch.stack(singles).numpy())
    np.testing.assert_array_equal(c1["pos"].numpy(), c2["pos"].numpy())
    for a, b in zip(c1["layers"], c2["layers"]):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])


def test_prompt_bucket_and_table_helpers_match_jax():
    for n in (1, 5, 16, 17, 100, 513, 1024):
        for mb in (16, 32):
            assert te.prompt_bucket(n, min_bucket=mb) == je.prompt_bucket(
                n, min_bucket=mb)
    cfg = torch_config("granite-8b").reduced()
    cache = tm.init_paged_cache(cfg, 2, 6, 16, 3, device="cpu")
    te.page_table_append(cache, 1, 2, 5)
    cache["pos"][1] = 40
    assert cache["page_table"].tolist() == [[0, 0, 0], [0, 0, 5]]
    te.slot_release(cache, 1)
    assert cache["page_table"].tolist() == [[0, 0, 0], [0, 0, 0]]
    assert cache["pos"].tolist() == [0, 0]


_NOT_PORTED = {
    "sharded": (dict(topology=ts.DeviceTopology(tp=2)), "Multi-GPU"),
    "data-parallel": (dict(topology=ts.DeviceTopology(dp=2)), "Multi-GPU"),
}


@pytest.mark.parametrize("option", sorted(_NOT_PORTED))
def test_validate_refuses_what_is_not_ported(option):
    kw, item = _NOT_PORTED[option]
    with pytest.raises(ValueError, match="ROADMAP.md") as e:
        ts.EngineConfig(**kw).validate()
    assert item in str(e.value)


#: options that the port serves since its remaining admission paths came
#: (chunked prefill, on pages and on rolling caches; the prefix cache;
#: preemption) and its span tracing and profiler hook, each with the
#: reference's own refusal where it has one
_NOW_SERVED = {
    "tracing": (dict(tracing=True, trace_sample_n=2), None),
    "profile_dir": (dict(profile_dir="profile"), None),
    "chunk_prefill": (dict(chunk_prefill=32), None),
    "rolling": (dict(paged=False, chunk_prefill=32), None),
    "prefix_cache": (dict(prefix_cache=True), "prefix_cache requires"),
    "preemption": (dict(preemption=True, shed_overdue=True),
                   "preemption requires"),
}


@pytest.mark.parametrize("option", sorted(_NOW_SERVED))
def test_remaining_paths_are_accepted(setup, option):
    """``validate()`` and the engine accept each option; a prefix cache or
    preemption over rolling caches (``paged=False``) raises the JAX
    engine's own message."""
    jc, tc, jp, tp, _ = setup
    kw, refusal = _NOW_SERVED[option]
    config = ts.EngineConfig(slots=2, max_seq=64, **kw)
    assert config.validate(tc) is config
    eng = ts.ServingEngine(tc, tp, config, device="cpu")
    assert eng.chunk == kw.get("chunk_prefill", 64)
    assert eng.paged == kw.get("paged", True)
    if refusal is None:
        return
    msgs = []
    for pkg, cfg, params, extra in ((js, jc, jp, {}),
                                    (ts, tc, tp, dict(device="cpu"))):
        with pytest.raises(ValueError, match=refusal) as e:
            pkg.ServingEngine(cfg, params, pkg.EngineConfig(
                slots=2, paged=False, **kw), **extra)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_validate_refuses_non_dense_archs_and_other_configs():
    cfg = torch_config("granite-8b").reduced()
    ts.EngineConfig().validate(cfg)  # the main path passes
    encoder = dataclasses.replace(cfg, arch_type="audio")
    with pytest.raises(ValueError, match="encoder-only arch"):
        ts.EngineConfig().validate(encoder)
    with pytest.raises(ValueError, match="encoder-only arch"):
        ts.EngineConfig().validate(torch_config("hubert-xlarge"))
    with pytest.raises(ValueError, match="not ported"):
        torch_config("bert-base")


def test_entry_points_raise_without_a_card(setup):
    _, tc, _, tp, _ = setup
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.ServingEngine(tc, tp, ts.EngineConfig(slots=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "granite-8b", "--reduced", "--requests", "1"])


def test_serve_cli_on_the_cpu(capsys):
    reqs = tserve.main(["--arch", "granite-8b", "--reduced", "--device",
                        "cpu", "--requests", "3", "--slots", "2", "--rate",
                        "1000", "--max-new", "5", "--temperature", "0.7",
                        "--top-k", "10"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "sampled decode: 3" in out
    assert all(len(r.output) == 5 for r in reqs)
