"""The granite-4.0-h-small cell at a tiny size on the CPU: a sound run is
correct with the reference agreeing token for token; the timed path
broken underneath, the model's own mathematics planted wrong (gates not
renormalised, the shared expert left out, the residual multiplier 1), the
fp8 control and a sampler taking the top of the set each come out not
correct. Then the family's layout and counts, the two MoE readers on
synthetic runs, and the plain reference against the program's forward."""
import copy
import dataclasses
import time
from pathlib import Path

import pytest
import torch

from ldsbench.families import hybrid
from ldsbench.harness import load_cell, run_cell
from ldsbench.metrics import moe_prefill_share_pct, moe_rows_per_routed
from ldsbench.reference import hybrid as ref_hybrid
from ldsbench.test_ldsbench_run import (
    half_batch_left_out,
    state_unchanged,
    token_altered,
)
from ldsbench.test_ldsbench_timeline import make_run, request
from repro_torch.serving.tracing import Timing

ROOT = Path(__file__).resolve().parents[1]
CELL = "granite-4.0-h-small.summarize"
TINY = {"clients": 3, "pool": 400,
        "prompt": {"dist": "uniform", "min": 8, "max": 40},
        "output": {"dist": "uniform", "min": 10, "max": 30},
        "engine": {"slots": 3, "window": 256, "sync_every": 4,
                   "moe_capacity_policy": "strict"}}
#: the other cells' tiny limits on the gaps, over 10: this model's logits
#: are its tied embedding (drawn at 1/12 of the other families' scale, as
#: the x 12 multiplier asks) over 16, so its gaps read ~1/100 of theirs;
#: the float32 program still reads 0
LIMITS = {"greedy_gap": 1e-4, "sampled_gap": 1e-4, "sampled_z": 4.0,
          "unfinished": 0}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread while a test runs: the tiny model's steps are
    hundreds of small ops, which other test processes' thread pools
    would otherwise starve."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_arch():
    from repro_torch.configs import get_config

    return dataclasses.asdict(get_config("granite-4.0-h-small").reduced())


def tiny_run(seed=2 ** 31 + 77, fault=None, control=None, also=(),
             trace=False):
    _, _, _, mix = load_cell(ROOT, CELL)
    mix = copy.deepcopy(mix)
    mix.update(TINY)
    mix["check"] = {"greedy": 8, "sampled": 8, "min_tokens": 2}
    return run_cell(CELL, seed, 6.0, trace, root=ROOT,
                    t_start=time.perf_counter(), device="cpu",
                    arch=tiny_arch(), mix=mix, fault=fault, control=control,
                    also=also, limits=LIMITS)


def caught(out):
    assert out["correct"] is False
    r = out["readings"]
    assert max(r["greedy_gap"], r["sampled_gap"]) > 10 * LIMITS["greedy_gap"]


def test_sound_run_is_correct():
    out = tiny_run()
    assert out["correct"] is True
    r = out["readings"]
    assert r["greedy_tokens"] > 20 and r["sampled_tokens"] > 10
    assert r["greedy_gap"] == 0.0 and r["sampled_gap"] == 0.0
    assert r["unfinished"] == 0
    assert set(out["metrics"]) >= {"tpot_p95_ms", "tokens_per_s", "setup_s"}


@pytest.mark.parametrize("kind", ["token_altered", "half_batch",
                                  "state_unchanged"])
def test_broken_timed_path_is_not_correct(kind, monkeypatch):
    fault = {"token_altered": token_altered,
             "half_batch": half_batch_left_out}.get(kind)
    if kind == "state_unchanged":
        state_unchanged(monkeypatch)
    caught(tiny_run(fault=fault))


def gates_not_renormalised(monkeypatch):
    """The softmax over all E experts, its top k as gates (the other
    router's)."""
    import repro_torch.models.moe as moe

    def plain_topk(cfg, logits):
        return torch.topk(torch.softmax(logits, dim=-1),
                          cfg.experts_per_token, dim=-1)

    monkeypatch.setattr(moe, "top_gates", plain_topk)


def shared_expert_left_out(monkeypatch):
    import repro_torch.models.blocks as blocks

    monkeypatch.setattr(blocks, "apply_mlp",
                        lambda cfg, p, x: torch.zeros_like(x))


def residual_one(eng):
    eng.cfg = dataclasses.replace(eng.cfg, residual_multiplier=1.0)


@pytest.mark.parametrize("kind", ["gates", "shared", "residual"])
def test_planted_model_fault_is_not_correct(kind, monkeypatch):
    fault = None
    if kind == "gates":
        gates_not_renormalised(monkeypatch)
    elif kind == "shared":
        shared_expert_left_out(monkeypatch)
    else:
        fault = residual_one
    caught(tiny_run(fault=fault))


def test_fp8_control_and_top_of_set_are_not_correct():
    out = tiny_run(control="fp8", also=("top", "ref"))
    caught(out)
    of = out["readings_of"]
    assert of["program"]["sampled_gap"] == 0.0
    assert of["top"]["sampled_z"] > 2 * LIMITS["sampled_z"]
    assert of["ref"]["sampled_z"] < LIMITS["sampled_z"]


def test_traced_run_reads_the_moe_counts():
    """On the CPU no CUDA event times the MoE part, so only the counter
    reads: between 1 (token-sorted prefills) and E / k (full-capacity
    ticks)."""
    out = tiny_run(trace=True)
    assert out["correct"] is True
    m = out["metrics"]
    assert "moe_prefill_share_pct" not in m
    assert 1.0 < m["moe_rows_per_routed"]["value"] < 8 / 2


def test_weights_take_the_programs_layout():
    from repro_torch.configs import ArchConfig
    from repro_torch.models import init_params
    from repro_torch.tree import flatten

    c = tiny_arch()
    cfg = ArchConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in c.items()})
    mine = {p: (tuple(t.shape), t.dtype) for p, t in
            flatten(hybrid.make_weights(c, 5, torch.device("cpu")))}
    want = {p: (tuple(t.shape), t.dtype) for p, t in
            flatten(init_params(cfg, 0, "meta"))}
    assert mine == want


def test_counts_of_the_published_config():
    import json

    conf = json.loads((ROOT / "ldsbench/configs/granite-4.0-h-small.json")
                      .read_text())
    c = conf["arch"]
    # the program's layers are the published layer_types kept
    types = hybrid.layer_types(c)
    assert types == [{"mamba": "ssd_moe", "attention": "moe"}[t]
                     for t in conf["layer_types"]]
    assert [i for i, t in enumerate(types) if t == "moe"] == [5, 15]
    # the routed weights a token multiplies by: 18 SSD and 2 attention
    # mixers, 20 routers, 20 x (10 experts + the shared one), the head
    per_moe = 4096 * 72 + 10 * 3 * 4096 * 768 + 3 * 4096 * 1536
    want = (18 * (4096 * 16768 + 8192 * 4096) + 2 * (2 * 4096 * 4096
                                                      + 2 * 4096 * 1024)
            + 20 * per_moe + 4096 * 100352)
    assert hybrid.routed_weights(c) == want
    assert hybrid.token_flops(c, 0, 1) > 2 * want


def timing(prefill=None, moe=None, counts=None, serial=None):
    t = Timing(serial, ("decode", "prefill", "aux") if prefill is not None
               else None)
    if prefill is not None:
        t.device_s["prefill"] = prefill
        if moe is not None:
            t.device_s["moe"] = moe
    t.counts = dict(counts or {})
    return t


def test_moe_readers_on_synthetic_runs():
    c = {"moe_routed_pairs": 100, "moe_expert_rows": 100}
    d = {"moe_routed_pairs": 640, "moe_expert_rows": 4608}
    recs = [request(0, 101.0, 101.0, timing(0.2, 0.05),
                    [(102.0, timing(counts=c, serial=1))]),
            request(1, 101.5, 101.5, timing(0.3, 0.15),
                    [(103.0, timing(counts=d, serial=2))]),
            # a prefill and a period outside the window are not read
            request(2, 111.0, 111.0, timing(1.0, 1.0),
                    [(112.0, timing(counts=d, serial=3))])]
    run = make_run(recs)
    assert moe_prefill_share_pct.read(run) == pytest.approx(100 * 0.2 / 0.5)
    assert moe_rows_per_routed.read(run) == pytest.approx(4708 / 740)
    # a program that times and counts nothing: nothing to read
    bare = make_run([request(0, 101.0, 101.0, timing(0.2),
                             [(102.0, timing(serial=1))])])
    assert moe_prefill_share_pct.read(bare) is None
    assert moe_rows_per_routed.read(bare) is None


@pytest.mark.parametrize("length", [7, 70])
def test_reference_matches_the_program(length):
    """The plain reference against the program's own forward at the
    tiny size, float32 on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward

    cfg = get_config("granite-4.0-h-small").reduced()
    c = dataclasses.asdict(cfg)
    params = hybrid.make_weights(c, 3, torch.device("cpu"))
    tokens = torch.randint(0, cfg.vocab_size, (1, length),
                           generator=torch.Generator().manual_seed(length))
    with torch.no_grad():
        want, _ = forward(cfg, params, tokens)
    got = ref_hybrid.logits_at(c, params, [tokens[0]], [(0, length)])[0]
    # the other families' limit: float32 sums in another order
    assert float((got - want[0]).abs().max() / want.abs().max()) < 2e-5


def test_fp8_control_departs():
    c = tiny_arch()
    params = hybrid.make_weights(c, 4, torch.device("cpu"))
    tokens = torch.randint(0, c["vocab_size"], (40,),
                           generator=torch.Generator().manual_seed(1))
    full = ref_hybrid.logits_at(c, params, [tokens], [(0, 40)])[0]
    low = ref_hybrid.logits_at(c, params, [tokens], [(0, 40)],
                               precision="fp8")[0]
    rel = float((low - full).abs().max() / full.abs().max())
    assert 1e-3 < rel < 0.5
