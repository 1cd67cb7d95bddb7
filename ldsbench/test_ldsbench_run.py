"""Whole runs of each cell at a tiny size on the CPU (the harness's look
for a card skipped): a sound run comes out correct with the reference
agreeing token for token; runs with the timed path broken underneath
come out not correct; the fp8 control and the planted sampler faults,
put in the program's place, come out not correct. A run on the card is
marked ``gpu``."""
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from ldsbench.harness import load_cell, run_cell

ROOT = Path(__file__).resolve().parents[1]
LIMITS = {"greedy_gap": 1e-3, "sampled_gap": 1e-3, "sampled_z": 4.0,
          "unfinished": 0}

TINY = {
    "granite-8b.chat": {
        "rate_per_s": 3.0,
        "prompt": {"dist": "lognormal", "median": 60, "sigma": 0.7,
                   "min": 20, "max": 200},
        "output": {"dist": "lognormal", "median": 12, "sigma": 0.5,
                   "min": 4, "max": 40},
        "engine": {"slots": 4, "paged": True, "chunk_prefill": 32,
                   "page_size": 16, "max_seq": 256, "window": 256,
                   "prefix_cache": False, "sync_every": 4}},
    "mamba2-1.3b.decode": {
        "clients": 3, "pool": 400,
        "prompt": {"dist": "uniform", "min": 8, "max": 40},
        "output": {"dist": "uniform", "min": 10, "max": 30},
        "engine": {"slots": 3, "window": 256, "sync_every": 4}},
    "granite-8b.docqa": {
        "clients": 3, "pool": 400,
        "documents": {"count": 3, "length": {"dist": "uniform", "min": 100,
                                             "max": 180},
                      "zipf_s": 1.0,
                      "question": {"dist": "uniform", "min": 10, "max": 40}},
        "output": {"dist": "uniform", "min": 6, "max": 20},
        "engine": {"slots": 3, "paged": True, "chunk_prefill": 16,
                   "page_size": 16, "max_seq": 256, "window": 256,
                   "prefix_cache": True, "sync_every": 4}},
}


def tiny_run(workload, seed=2 ** 31 + 77, seconds=2.0, fault=None,
             control=None, also=(), trace=False):
    from repro_torch.configs import get_config

    _, _, conf, mix = load_cell(ROOT, workload)
    mix = copy.deepcopy(mix)
    mix.update(TINY[workload])
    mix["check"] = {"greedy": 8, "sampled": 8, "min_tokens": 2}
    arch = dataclasses.asdict(get_config(conf["name"]).reduced())
    return run_cell(workload, seed, seconds, trace, root=ROOT,
                    t_start=time.perf_counter(), device="cpu", arch=arch,
                    mix=mix, fault=fault, control=control, also=also,
                    limits=LIMITS)


@pytest.mark.parametrize("workload", list(TINY))
def test_sound_run_is_correct(workload):
    out = tiny_run(workload)
    assert out["correct"] is True
    r = out["readings"]
    assert r["greedy_tokens"] > 20 and r["sampled_tokens"] > 10
    assert r["greedy_gap"] == 0.0 and r["unfinished"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) >= {"tpot_p95_ms", "tokens_per_s",
                                   "setup_s"}
    assert out["attempted"] > 5


def test_traced_run_reads_the_engine_layers():
    out = tiny_run("granite-8b.docqa", trace=True)
    m = out["metrics"]
    assert m["prefix_hit_pct"]["value"] > 50
    assert m["chunks_per_tick"]["value"] >= 0
    # 32 closed-loop clients on 32 slots never queue: not declared there
    assert "queue_wait_ms_p95" not in m
    assert out["correct"] is True


def test_traced_open_loop_run_reads_the_queue_wait():
    out = tiny_run("granite-8b.chat", trace=True)
    assert out["metrics"]["queue_wait_ms_p95"]["value"] >= 0
    assert out["correct"] is True


def token_altered(eng):
    """Each delivered block's first row of tokens changed where produced."""
    orig, v = eng._distribute, eng.cfg.vocab_size

    def bad(toks, now=None):
        toks = toks.copy()
        toks[0] = (toks[0] + 1) % v
        return orig(toks, now)
    eng._distribute = bad


def half_batch_left_out(eng):
    """Every other slot's tokens (slots 0, 2, ...) not computed: the
    slot's last token repeated."""
    orig = eng._distribute
    last = {}

    def bad(toks, now=None):
        toks = toks.copy()
        for i in range(0, toks.shape[1], 2):
            prev = last.get(i, int(toks[0, i]))
            toks[:, i] = prev
        for i in range(toks.shape[1]):
            last[i] = int(toks[-1, i])
        return orig(toks, now)
    eng._distribute = bad


def state_unchanged(monkeypatch):
    """A decode step that leaves the cache as it found it: no K/V stored
    (dense), the conv window and SSD state returned as they were (SSD)."""
    import repro_torch.models.blocks as blocks
    import repro_torch.models.ssm as ssm

    def no_store(cache, at, k, v, hd_part=None):
        return None

    orig_mix = ssm._ssd_mix

    def stale(cfg, p, x, xz, cache):
        out, conv, state = orig_mix(cfg, p, x, xz, cache)
        if cache is not None and x.shape[1] == 1:
            return out, cache["conv"].clone(), cache["state"].clone()
        return out, conv, state

    monkeypatch.setattr(blocks, "store_kv", no_store)
    monkeypatch.setattr(ssm, "_ssd_mix", stale)


@pytest.mark.parametrize("workload", list(TINY))
@pytest.mark.parametrize("kind", ["token_altered", "half_batch",
                                  "state_unchanged"])
def test_broken_timed_path_is_not_correct(workload, kind, monkeypatch):
    fault = None
    if kind == "token_altered":
        fault = token_altered
    elif kind == "half_batch":
        fault = half_batch_left_out
    else:
        state_unchanged(monkeypatch)
    out = tiny_run(workload, fault=fault)
    assert out["correct"] is False
    r = out["readings"]
    assert max(r["greedy_gap"], r["sampled_gap"]) > 10 * LIMITS["greedy_gap"]


@pytest.mark.parametrize("workload", list(TINY))
def test_fp8_control_reads_above_the_program(workload):
    """The fp8 control in the program's place: its argmax on greedy rows
    and its own draws on seeded rows, scored and judged as the program's
    tokens are, come out not correct."""
    out = tiny_run(workload, control="fp8")
    assert out["correct"] is False
    r, prog = out["readings"], out["readings_of"]["program"]
    assert r["greedy_gap"] > 10 * LIMITS["greedy_gap"]
    assert r["greedy_tokens"] == prog["greedy_tokens"] > 20
    assert prog["greedy_gap"] == 0.0
    assert out["checks"]["greedy_gap"]["value"] == r["greedy_gap"]


@pytest.mark.parametrize("workload", list(TINY))
def test_sampler_taking_the_top_of_the_set_is_not_correct(workload):
    """A sampler that always takes the top token of the top-k / top-p
    set reads 0 on ``sampled_gap``; ``sampled_z`` fails it. The float32
    reference's own draws read as the program's do."""
    out = tiny_run(workload, control="top", also=("ref",))
    assert out["correct"] is False
    r, ref = out["readings"], out["readings_of"]["ref"]
    assert r["sampled_gap"] == 0.0
    assert r["sampled_z"] > 2 * LIMITS["sampled_z"]
    assert ref["sampled_z"] < LIMITS["sampled_z"]
    assert ref["sampled_gap"] == 0.0 and ref["greedy_gap"] == 0.0


@pytest.mark.gpu
def test_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = subprocess.run(
        [sys.executable, "ldsbench/run.py", "--workload",
         "mamba2-1.3b.decode", "--seed", "5", "--seconds", "3",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env=dict(os.environ))
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["device"]["platform"] == "gpu"
    assert np.isfinite(out["metrics"]["tokens_per_s"]["value"])


def test_host_tally_times_the_window_steps():
    out = tiny_run("granite-8b.chat")
    host = out["samples"]["host"]
    assert host["steps"]["decode"] > 0
    assert host["steps"]["prefill"] > 0  # the open loop's chunk steps
    assert 0 < sum(host["step_s"].values()) < 2.0 + 1.0
    assert host["gc_s"] >= 0
