"""Request lifecycle in the PyTorch port's engine against the JAX
package's, on granite-8b ``reduced()`` with two kv heads, float32, the
same converted weights: the state machine through chunked prefill,
``cancel()``, ``timeout_s``, ``shed_overdue``, preemption with exact
restore (with and without the prefix cache), the strict-urgency rule,
the mid-decode page shortfall that fails only the starved slot, and
``takeover_queue``. Each test replays one sequence of the reference suite
(``tests/test_lifecycle.py``, ``tests/test_paging.py``) on both engines and
compares streams, terminal states, ``fail_reason`` prefixes, counters and
page accounting.

On the parent tree the port's engine ignored ``cancel()`` and timeouts
(it decoded a cancelled request to its full budget) and wrote fewer table
entries than a starved slot needed instead of failing it: the cancel,
timeout and shortfall tests show both."""
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
from repro_torch.serving import engine as te

torch.set_num_threads(2)

TPU = Chip(**dataclasses.asdict(TPU_V5E))


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


def _both(setup, scenario, **kw):
    """The scenario's observations on the JAX engine and on the port's:
    ``scenario(pkg, engine)``."""
    out = []
    for which in ("jax", "torch"):
        pkg, cfg, params, extra = setup[which]
        if kw.get("chunk_prefill"):
            kw["prefill_policy"] = (
                JaxPolicy(chunk=kw["chunk_prefill"]) if pkg is js
                else ChunkedPrefillPolicy(chunk=kw["chunk_prefill"],
                                          chip=TPU))
        eng = pkg.ServingEngine(cfg, params, pkg.EngineConfig(**kw), **extra)
        out.append(scenario(pkg, eng))
    return out


def _drive(eng, reqs, *, t0=0.0, max_steps=500):
    done, t = [], t0
    while len(done) < len(reqs):
        t += 1.0
        done += eng.step(t)
        assert t - t0 < max_steps, f"{len(done)}/{len(reqs)} resolved"
    return done, t


def _outcome(r):
    return (r.rid, r.state.value, r.fail_reason.split(":")[0],
            list(r.output))


def test_state_machine_through_chunked_prefill(setup):
    """QUEUED -> PREFILL (over several ticks of 8-token chunks) -> DECODE
    -> FINISHED, tick by tick as in the JAX engine."""

    def scenario(pkg, eng):
        req = pkg.Request(0, _prompt(32), max_new_tokens=3)
        states = [req.state.value]
        assert eng.submit(req, 0.0)
        t = 0.0
        while not req.done:
            states.append(req.state.value)
            t += 1.0
            eng.step(t)
            assert t < 50
        states.append(req.state.value)
        return states, list(req.output), eng.metrics.prefill_chunks

    want, got = _both(setup, scenario, slots=1, window=64, sync_every=1,
                      chunk_prefill=8)
    assert got == want
    assert got[0][:2] == ["queued", "prefill"] and got[0][-1] == "finished"
    assert "decode" in got[0] and got[2] == 4


@pytest.mark.parametrize("where", ["decode", "chunk_job", "queued"])
def test_cancel_frees_slot_and_pages(setup, where):
    """``cancel()`` on a decoding request, on one mid-way through chunked
    prefill, and on a queued one: CANCELLED the next tick, its slot and
    pages back at once, and the request behind it served in full."""

    def scenario(pkg, eng):
        long = where == "chunk_job"
        req = pkg.Request(0, _prompt(40 if long else 12), max_new_tokens=40)
        other = pkg.Request(1, _prompt(10, seed=1), max_new_tokens=4)
        if where == "queued":
            hog = pkg.Request(2, _prompt(12, seed=2), max_new_tokens=6)
            assert eng.try_admit(hog, 0.0)
            eng.submit(req, 0.0)
            eng.submit(other, 0.0)
        else:
            assert eng.try_admit(req, 0.0)
            eng.submit(other, 0.0)
        eng.step(1.0)
        mid = (len(req.output), req.state.value)
        req.cancel()
        out = eng.step(2.0)
        first = (req in out, _outcome(req), eng.metrics.cancelled)
        rest = [other] + ([hog] if where == "queued" else [])
        done, _ = _drive(eng, rest, t0=2.0)
        return (mid, first, [_outcome(r) for r in rest], eng.n_active,
                eng.allocator.pages_in_use, eng.idle)

    want, got = _both(setup, scenario, slots=1, window=64, sync_every=1,
                      chunk_prefill=16)
    assert got == want
    assert got[1][0] and got[1][1][1] == "cancelled" and got[1][2] == 1
    assert "cancel" in got[1][1][2]
    assert len(got[2][0][3]) == 4 and got[3:] == (0, 0, True)


def test_timeout_aborts_mid_decode(setup):
    def scenario(pkg, eng):
        req = pkg.Request(0, _prompt(12), max_new_tokens=200, timeout_s=3.0)
        assert eng.try_admit(req, 0.0)
        for t in (1.0, 2.0, 3.0):
            eng.step(t)
        before = req.state.value
        out = eng.step(4.5)
        return (before, req in out, _outcome(req), eng.metrics.timed_out,
                eng.n_active, eng.allocator.pages_in_use)

    want, got = _both(setup, scenario, slots=1, window=64, sync_every=1,
                      chunk_prefill=0)
    assert got == want
    assert got[0] == "decode" and got[1] and got[2][1] == "timed_out"
    assert got[2][2] == "timed out" and 0 < len(got[2][3]) < 200
    assert got[3:] == (1, 0, 0)


def test_shed_overdue_queued_request(setup):
    def scenario(pkg, eng):
        hog = pkg.Request(0, _prompt(12), max_new_tokens=30)
        late = pkg.Request(1, _prompt(10, seed=1), max_new_tokens=4,
                           ttft_slo_s=2.0)
        assert eng.try_admit(hog, 0.0)
        eng.submit(late, 0.0)
        out = []
        for t in (1.0, 2.0, 3.0):
            out += eng.step(t)
        shed = (late in out, _outcome(late), eng.metrics.shed,
                eng.metrics.timed_out, late.prefill_done)
        done, _ = _drive(eng, [hog], t0=3.0)
        return shed, _outcome(hog)

    want, got = _both(setup, scenario, slots=1, window=64, sync_every=1,
                      chunk_prefill=0, shed_overdue=True)
    assert got == want
    (inside, late, n_shed, n_timed_out, prefill_done), hog = got
    assert inside and late[1] == "timed_out" and late[2] == "shed"
    assert (n_shed, n_timed_out, prefill_done) == (1, 0, -1.0)
    assert len(hog[3]) == 30


def test_preemption_refusals_are_the_references(setup):
    msgs = []
    for which in ("jax", "torch"):
        pkg, cfg, params, extra = setup[which]
        got = []
        for kw in (dict(paged=False, preemption=True),
                   dict(preemption=True, preempt_policy="coin-flip")):
            with pytest.raises(ValueError) as e:
                pkg.ServingEngine(cfg, params, pkg.EngineConfig(
                    slots=1, **kw), **extra)
            got.append(str(e.value))
        msgs.append(got)
    assert msgs[0] == msgs[1]
    assert "preemption requires" in msgs[1][0]
    assert "preempt_policy" in msgs[1][1]
    assert set(te.PREEMPT_POLICIES) == {"latest-deadline", "most-remaining"}


@pytest.mark.parametrize("prefix_cache", [False, True],
                         ids=["paged", "prefix_cache"])
def test_preempt_restore_bit_identical(setup, prefix_cache):
    """A seeded request preempted mid-decode by a higher-priority arrival
    resumes with the stream of an undisturbed run, on both engines (with
    the prefix cache its restore prefills only the suffix past its
    cached generated prefix)."""
    kw = dict(slots=1, window=64, max_seq=64, sync_every=1, chunk_prefill=0)

    def sampling(pkg, seed):
        return pkg.SamplingParams(temperature=0.7, top_k=20, top_p=0.95,
                                  seed=seed)

    def undisturbed(pkg, eng):
        ref = pkg.Request(0, _prompt(20), max_new_tokens=10,
                          sampling=sampling(pkg, 77))
        assert eng.try_admit(ref, 0.0)
        _drive(eng, [ref])
        return list(ref.output)

    def scenario(pkg, eng):
        victim = pkg.Request(0, _prompt(20), max_new_tokens=10,
                             sampling=sampling(pkg, 77), ttft_slo_s=100.0)
        assert eng.try_admit(victim, 0.0)
        for t in (1.0, 2.0, 3.0):
            eng.step(t)
        hot = pkg.Request(1, _prompt(10, seed=9), max_new_tokens=3,
                          priority=1, ttft_slo_s=1.0,
                          sampling=sampling(pkg, 78))
        eng.submit(hot, 3.0)
        _drive(eng, [victim, hot], t0=3.0)
        m = eng.metrics
        obs = (_outcome(victim), _outcome(hot), victim.preemptions,
               m.preempted, m.preempt_restores, m.prefix_hits,
               hot.finish_time <= victim.finish_time)
        eng.clear_prefix_cache()
        return obs + (eng.allocator.pages_in_use, eng.allocator.total_refs)

    ref = _both(setup, undisturbed, **kw)
    want, got = _both(setup, scenario, preemption=True,
                      prefix_cache=prefix_cache, **kw)
    assert ref[0] == ref[1]
    assert got == want
    assert got[0][3] == ref[1] and got[0][1] == "finished"
    assert got[2] >= 1 and got[3] >= 1 and got[4] >= 1 and got[6]
    assert (got[5] >= 1) == prefix_cache
    assert got[7:] == (0, 0)


def test_preemption_never_evicts_equal_urgency(setup):
    def scenario(pkg, eng):
        a = pkg.Request(0, _prompt(12), max_new_tokens=20, ttft_slo_s=5.0)
        b = pkg.Request(1, _prompt(12, seed=1), max_new_tokens=20,
                        ttft_slo_s=5.0)
        assert eng.try_admit(a, 0.0)
        eng.submit(b, 0.0)
        for t in range(1, 6):
            eng.step(float(t))
        return eng.metrics.preempted, a.preemptions, a.done, list(a.output)

    want, got = _both(setup, scenario, slots=1, window=64, sync_every=1,
                      chunk_prefill=0, preemption=True)
    assert got == want and got[:3] == (0, 0, False)


def test_page_shortfall_fails_only_the_starved_slot(setup):
    """A budget raised past the admission-time reservation: mid-decode the
    pool runs dry, and only that request fails, with the reference's
    ``OutOfPagesError`` text; the bystander finishes and every page comes
    back."""

    def scenario(pkg, eng):
        bad = pkg.Request(0, _prompt(30), max_new_tokens=2)
        ok = pkg.Request(1, _prompt(30, seed=1), max_new_tokens=8)
        assert eng.try_admit(bad, 0.0)
        assert eng.try_admit(ok, 0.0)
        bad.max_new_tokens = 90  # bypass the reservation
        done = []
        for t in range(200):
            done += eng.step(float(t))
            if ok.done and bad in done:
                break
        return (bad.state.value, bad.fail_reason, eng.metrics.failed,
                _outcome(ok), eng.n_active, eng.allocator.pages_in_use)

    want, got = _both(setup, scenario, slots=2, window=64, pool_pages=6,
                      sync_every=1, chunk_prefill=0)
    assert got == want
    assert got[0] == "failed" and got[1].startswith("OutOfPagesError")
    assert "pool_pages" in got[1] and got[2] == 1
    assert len(got[3][3]) == 8 and got[4:] == (0, 0)


def test_takeover_queue_hands_back_the_unstarted(setup):
    """A retiring replica's queued requests come back in drain order; the
    slot's request stays and finishes."""

    def scenario(pkg, eng):
        run = pkg.Request(0, _prompt(12), max_new_tokens=5)
        assert eng.try_admit(run, 0.0)
        queued = [pkg.Request(i, _prompt(10, seed=i), max_new_tokens=3)
                  for i in (1, 2, 3)]
        for r in queued:
            eng.submit(r, 0.0)
        handed = [r.rid for r in eng.takeover_queue()]
        _drive(eng, [run])
        return handed, _outcome(run), eng.idle

    want, got = _both(setup, scenario, slots=1, window=64, chunk_prefill=0)
    assert got == want and got[0] == [1, 2, 3] and got[2]


def test_a_chunked_restore_counts_as_a_restore(setup):
    """A victim whose folded prompt is longer than the chunk comes back
    through chunked prefill. Both engines restore the same stream, but the
    reference counts no restore for it (its state went PREFILL before the
    activation that counts restores: ROADMAP.md queue 3); the port counts
    one for each preemption, as for a victim prefilled at once."""

    def scenario(pkg, eng):
        sp = pkg.SamplingParams(temperature=0.7, top_k=20, seed=77)
        victim = pkg.Request(0, _prompt(20), max_new_tokens=10,
                             sampling=sp, ttft_slo_s=100.0)
        assert eng.try_admit(victim, 0.0)
        _drive_until(eng, lambda: len(victim.output) >= 3)
        hot = pkg.Request(1, _prompt(10, seed=9), max_new_tokens=3,
                          priority=1, ttft_slo_s=1.0)
        eng.submit(hot, 10.0)
        _drive(eng, [victim, hot], t0=10.0)
        m = eng.metrics
        return (_outcome(victim), victim.preemptions, m.preempted,
                m.preempt_restores, m.prefill_chunks > 0)

    want, got = _both(setup, scenario, slots=1, window=64, max_seq=64,
                      sync_every=1, chunk_prefill=16, preemption=True)
    assert got[:3] == want[:3] and got[4] and want[4]
    assert got[2] >= 1 and got[3] == got[2]
    assert want[3] < want[2]  # the reference's count misses it


def _drive_until(eng, cond, t=0.0):
    while not cond():
        t += 1.0
        eng.step(t)
        assert t < 100
    return t
