"""Engine streams of the PyTorch port's MoE archs against the JAX
engine's: grok-1-314b (top-2) and llama4-maverick-400b-a17b (top-1, a
shared expert, a dense layer between), each ``reduced()`` (4 experts),
float32, on the same converted weights, half the requests seeded.

Each case serves the same four prompts (9, 30, 100 and 150 tokens on 3
slots: buckets of 16 and 32, two chunked prompts, a queued one) on both
engines and compares the token streams, and the routed choices every MoE
call kept, call by call, in both packages:
- "drop" at capacity factor 1.0 (binding: tokens drop, idle decode lanes
  and prompt pads route and take capacity as in the reference), chunked
  (chunk 64) and single-shot;
- "strict" at 1.0 (every step at full capacity: nothing drops);
- "backpressure" just under the factor at which no group can drop
  (k * factor < E): groups up to the drop-free bound, nothing drops;
- a prefix hit under "drop" at 1.0 on grok (its suffix routes as its own
  group).

The JAX side's kept choices come from a probe on ``jax.nn.one_hot``
(``jax.debug.callback`` on each round's slot one-hot, which the reference
builds from the slots it assigns); the port's from ``moe.route``."""
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
from repro_torch import models as tm
from repro_torch import serving as ts
from repro_torch.configs import get_config as torch_config
from repro_torch.core.hardware import Chip
from repro_torch.core.misd.scheduler import ChunkedPrefillPolicy
from repro_torch.models import moe as tmoe

torch.set_num_threads(2)
TPU = Chip(**dataclasses.asdict(TPU_V5E))
LENS = (9, 30, 100, 150)


def _arch(name):
    jc, tc = jax_config(name).reduced(), torch_config(name).reduced()
    jp = jm.init_params(jc, jax.random.key(0))
    tp = tm.params_from_jax(tc, jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


@pytest.fixture(scope="module", params=["grok-1-314b",
                                        "llama4-maverick-400b-a17b"])
def arch(request):
    return _arch(request.param)


def _prompts(prefix=False):
    rng = np.random.default_rng(3)
    ps = [rng.integers(0, 500, n).astype(np.int32) for n in LENS]
    if prefix:  # the last two share the first 100 tokens of the third
        ps[3] = np.concatenate([ps[2], ps[3][:20]])
    return ps


def _serve(pkg, cfg, params, *, chunk, policy, prefix=False):
    extra = ({} if pkg is js else dict(
        device="cpu", threefry_partitionable=bool(
            jax.config.jax_threefry_partitionable)))
    pol = None
    if chunk:
        pol = (JaxPolicy(chunk=chunk) if pkg is js
               else ChunkedPrefillPolicy(chunk=chunk, chip=TPU))
    eng = pkg.ServingEngine(cfg, params, pkg.EngineConfig(
        slots=3, max_seq=256, chunk_prefill=chunk, prefill_policy=pol,
        moe_capacity_policy=policy, prefix_cache=prefix), **extra)
    reqs = [pkg.Request(rid=i, prompt=p, max_new_tokens=8,
                        sampling=(pkg.SamplingParams(
                            temperature=0.8, top_k=20, top_p=0.9,
                            seed=1000 + i)
                            if i % 2 else pkg.SamplingParams()))
            for i, p in enumerate(_prompts(prefix))]
    t = 0.0
    # with the prefix cache, the prefix's owner finishes before the hit
    waves = [reqs[:3], reqs[3:]] if prefix else [reqs]
    for wave in waves:
        for r in wave:
            eng.submit(r, t)
        while not all(r.done for r in wave) and t < 500:
            t += 1.0
            eng.step(t)
    eng.drain(t)
    return reqs, eng


def _jax_keeps(monkeypatch, k):
    """Patch ``jax.nn.one_hot`` (the reference's MoE is its only user) so
    that every traced routing round reports its slots at run time.
    Returns a function giving the (N, g, k) kept mask of each MoE call,
    in order."""
    calls = []
    orig = jax.nn.one_hot

    def probe(x, n, *a, **kw):
        jax.debug.callback(lambda v, n=n: calls.append((np.asarray(v), n)),
                           x, ordered=True)
        return orig(x, n, *a, **kw)

    monkeypatch.setattr(jax.nn, "one_hot", probe)

    def keeps():
        slots = calls[1::2]  # (argmax, E) then (slot, C) each round
        return [np.stack([pos < c for pos, c in slots[i:i + k]], axis=-1)
                for i in range(0, len(slots), k)]
    return keeps


def _torch_keeps(monkeypatch):
    calls = []
    orig = tmoe.route

    def probe(cfg, probs, c):
        out = orig(cfg, probs, c)
        calls.append(out[1].numpy().copy())
        return out

    monkeypatch.setattr(tmoe, "route", probe)
    return calls


CASES = [  # (policy, capacity factor or None: just under drop-free, chunk)
    ("drop", 1.0, 64), ("drop", 1.0, 0), ("strict", 1.0, 64),
    ("backpressure", None, 64)]


def _check(monkeypatch, jc, tc, jp, tp, *, policy, chunk, prefix=False):
    keeps_j = _jax_keeps(monkeypatch, tc.experts_per_token)
    keeps_t = _torch_keeps(monkeypatch)
    want, jeng = _serve(js, jc, jp, chunk=chunk, policy=policy,
                        prefix=prefix)
    got, teng = _serve(ts, tc, tp, chunk=chunk, policy=policy,
                       prefix=prefix)
    assert [r.output for r in got] == [r.output for r in want]
    assert all(r.state.value == "finished" and len(r.output) == 8
               for r in got)
    assert teng.slots == jeng.slots
    assert teng.metrics.prefill_chunks == jeng.metrics.prefill_chunks
    assert teng.metrics.prefix_hits == jeng.metrics.prefix_hits
    assert (teng.prefill_traces, teng.decode_traces) == \
        (jeng.prefill_traces, jeng.decode_traces)
    kj = keeps_j()
    assert len(keeps_t) == len(kj)
    for a, b in zip(keeps_t, kj):
        np.testing.assert_array_equal(a, b)
    return sum(int((~k).sum()) for k in keeps_t), teng


@pytest.mark.parametrize("policy,cf,chunk", CASES)
def test_streams_and_drops_match_the_jax_engine(arch, monkeypatch, policy,
                                                cf, chunk):
    jc, tc, jp, tp = arch
    if cf is None:  # k * factor just under E: a drop-free bound of 200+
        cf = tc.num_experts / tc.experts_per_token - 0.01
    jc = dataclasses.replace(jc, moe_capacity_factor=cf)
    tc = dataclasses.replace(tc, moe_capacity_factor=cf)
    dropped, eng = _check(monkeypatch, jc, tc, jp, tp, policy=policy,
                          chunk=chunk)
    assert eng.moe_capacity_policy == policy
    assert bool(eng.metrics.prefill_chunks) == bool(chunk)
    if policy == "drop":
        assert dropped > 0
    else:
        assert dropped == 0
    if policy == "backpressure":
        assert 200 <= eng._moe_gmax < 1 << 20


def test_prefix_hit_streams_and_drops_match_the_jax_engine(monkeypatch):
    """grok's top-2: the hit's suffix (24 tokens past 96 cached, in a step
    32 wide) routes as its own group."""
    jc, tc, jp, tp = _arch("grok-1-314b")
    jc = dataclasses.replace(jc, moe_capacity_factor=1.0)
    tc = dataclasses.replace(tc, moe_capacity_factor=1.0)
    dropped, eng = _check(monkeypatch, jc, tc, jp, tp, policy="drop",
                          chunk=64, prefix=True)
    assert eng.metrics.prefix_hits == 1 and dropped > 0
