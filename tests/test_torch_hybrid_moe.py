"""granite-4.0-h-small's pieces of the port on the CPU (it has no JAX twin:
ldsbench's plain reference holds its forward, ``ldsbench/
test_ldsbench_reference.py``): the published config and its count; the
Granite router (the top k of the logits, the softmax over those k); the
token-sorted dispatch of the eager prefill against the full-capacity
buffer, under a router skewed to one expert, dropping nothing; its
grouped expert product (``ops.moe_grouped``, the plain version here)
against the per-expert loop it replaced, bit for bit; the SSD
mixer without a conv bias as it computed before the bias existed, bit
for bit; grok's and llama4's routing as the unchanged ``route`` gives
it; the engine's MoE counters, step-timeline counts and sync sites (no
``moe.counts``) and cache bytes; the one resolver of the MoE dispatch
and the device span's hook; ``validate()`` refusing the new blocks
on a grid, and a token-sorted prefill in a dtype the card's grouped
kernel does not take."""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config, reference_view
from repro_torch.models import forward, init_params, layer_types
from repro_torch.models import layers as L
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm
from repro_torch.serving import (
    DeviceTopology,
    EngineConfig,
    Request,
    SamplingParams,
    ServingEngine,
)

GRANITE = "granite-4.0-h-small"


def tiny():
    return get_config(GRANITE).reduced()


def test_the_published_config():
    cfg = get_config(GRANITE)
    assert cfg.param_count() == 32_207_337_984  # 32.2 B, as published
    assert round(cfg.active_param_count() / 1e9, 2) == 8.80
    types = layer_types(cfg)
    assert [i for i, t in enumerate(types) if t == "moe"] == [5, 15, 25, 35]
    assert types.count("ssd_moe") == 36 and cfg.num_moe_layers == 40
    assert (cfg.d_inner, cfg.ssm_num_heads) == (8192, 128)
    with pytest.raises(ValueError, match="port-only"):
        reference_view(cfg)
    t = tiny()
    assert layer_types(t) == ["ssd_moe", "moe"] * 2
    assert (t.num_experts, t.experts_per_token, t.moe_shared_d_ff) == (8, 2,
                                                                        128)
    assert t.attention_multiplier == 1 / 32  # 1 / head_dim, as published


def test_router_gates_sum_to_one_over_the_picks():
    cfg = dataclasses.replace(tiny(), num_experts=72, experts_per_token=10)
    g = torch.Generator().manual_seed(1)
    logits = torch.randn(3, 33, 72, generator=g)
    gates, idx = tmoe.top_gates(cfg, logits)
    vals, want_idx = torch.topk(logits, 10, dim=-1)
    e = torch.exp(vals - vals[..., :1])
    assert torch.equal(idx, want_idx)
    torch.testing.assert_close(gates, e / e.sum(-1, keepdim=True),
                               rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(gates.sum(-1), torch.ones(3, 33))
    # the capacity path gives each token exactly its k gates
    d = cfg.d_model
    p = {"router": torch.randn(d, 72, generator=g) * d ** -0.5}
    x = torch.randn(2, 16, d, generator=g)
    combine, _, _, _ = tmoe._dispatch(cfg, p, x, 2048, "full")
    per = combine.reshape(32, 72, -1).sum(-1)
    gates, idx = tmoe.top_gates(cfg, x.reshape(32, d) @ p["router"])
    want = torch.zeros(32, 72).scatter_(-1, idx, gates)
    torch.testing.assert_close(per, want)


def _skewed(cfg, seed=3):
    params = init_params(cfg, seed, "cpu")
    m = dict(params["layers"][0]["moe"])
    m["router"] = m["router"].clone()
    # expert 0's logits 50 x wider: every token whose logit there is
    # positive picks it first (about half of them, against k / E = 1/4)
    m["router"][:, 0] *= 50.0
    return params, m


def test_sorted_dispatch_equals_full_capacity_dropping_nothing():
    cfg = tiny()
    _, m = _skewed(cfg)
    x = torch.randn(1, 40, cfg.d_model, generator=torch.Generator()
                    .manual_seed(2))
    with torch.no_grad():
        full, _ = tmoe.apply_moe(cfg, m, x, dispatch="full")
        srt, aux = tmoe.apply_moe(cfg, m, x, dispatch="sorted")
        capped, _ = tmoe.apply_moe(cfg, m, x)
    _, idx = tmoe.top_gates(cfg, x.reshape(40, -1) @ m["router"])
    offsets = tmoe.expert_offsets(idx, 8)
    counts = (offsets[1:] - offsets[:-1]).tolist()
    assert offsets.dtype == torch.int32 and int(offsets[0]) == 0
    assert counts == torch.bincount(idx.reshape(-1), minlength=8).tolist()
    assert counts[0] == max(counts) > 1.5 * 40 * 2 / 8
    assert sum(counts) == 40 * 2
    # float32: the same products, each token's k outputs summed in another
    # order than the combine product's
    torch.testing.assert_close(srt, full, rtol=1e-5, atol=1e-6)
    assert aux == 0.0
    # the full-capacity buffer kept every pick; a capacity factor of 1
    # would have dropped some of expert 0's
    logits = x.reshape(1, 40, -1) @ m["router"]
    gates, idx = tmoe.top_gates(cfg, logits)
    probs = torch.zeros_like(logits).scatter_(-1, idx, gates)
    _, keep, _ = tmoe.route(cfg, probs, tmoe._capacity(cfg, 40, full=True))
    assert bool(keep.all())
    one = dataclasses.replace(cfg, moe_capacity_factor=1.0)
    _, keep, _ = tmoe.route(one, probs, tmoe._capacity(one, 40))
    assert not bool(keep.all())
    torch.testing.assert_close(capped, full)  # factor 8: nothing binds
    assert tmoe.expert_rows(cfg, 40, "sorted") == (80, 80)
    assert tmoe.expert_rows(cfg, 40, "full") == (80, 8 * 40)


def _loop_before(cfg, p, x):
    """``_apply_sorted`` as it was before the grouped product: the counts
    by ``torch.bincount``, read to the host, and one product per expert."""
    from repro_torch.models.blocks import mlp_hidden

    d, e, k = x.shape[-1], cfg.num_experts, cfg.experts_per_token
    xf = x.reshape(-1, d)
    logits = torch.matmul(xf.to(torch.float32), p["router"].to(torch.float32))
    if cfg.moe_router == "topk_softmax":
        gates, idx = tmoe.top_gates(cfg, logits)
    else:
        gates, idx = torch.topk(torch.softmax(logits, dim=-1), k, dim=-1)
    order = torch.argsort(idx.reshape(-1), stable=True)
    counts = torch.bincount(idx.reshape(-1), minlength=e).tolist()
    rows = xf[order // k]
    ys = torch.empty_like(rows)
    lo = 0
    for j, n in enumerate(counts):
        if n:
            w = {name: p[name][j] for name in ("w_gate", "w_up", "w_down")
                 if name in p}
            ys[lo:lo + n] = torch.matmul(mlp_hidden(cfg, w, rows[lo:lo + n]),
                                         w["w_down"])
            lo += n
    picked = torch.empty_like(ys)
    picked[order] = ys
    g = gates.to(x.dtype).to(torch.float32)
    y = (picked.reshape(-1, k, d).to(torch.float32) * g[..., None]).sum(dim=1)
    return y.to(x.dtype).reshape(x.shape), (xf, order, idx, ys)


def _routed(name, variant, routing, t):
    """A MoE layer of ``name``'s reduced config in bf16 under ``variant``
    and x (1, t, d), its router set for ``routing``: "natural" (random);
    "one" (every token's first coordinate positive and each expert's
    logit that coordinate times a constant: every token picks the same k
    experts, the rest get no row; llama4's k 1 sends every pair to one
    expert); "empty" (every odd expert's logit below -100: half the
    experts get no row)."""
    cfg = dataclasses.replace(get_config(name).reduced(), mlp_variant=variant,
                              dtype="bfloat16")
    gen = torch.Generator().manual_seed(t + len(variant))
    p = tmoe.init_moe(cfg, gen, torch.bfloat16, "cpu")
    x = torch.randn(1, t, cfg.d_model, generator=gen)
    e = cfg.num_experts
    if routing != "natural":
        x[..., 0] = x[..., 0].abs() + 1.0
    if routing == "one":
        p["router"] = torch.zeros_like(p["router"])
        p["router"][0] = torch.linspace(1.0, -1.0, e)
    elif routing == "empty":
        p["router"][:, 1::2] = 0.0
        p["router"][0, 1::2] = -100.0
    return cfg, p, x.to(torch.bfloat16)


@pytest.mark.parametrize("t", [1, 37])
@pytest.mark.parametrize("routing", ["natural", "one", "empty"])
@pytest.mark.parametrize("name,variant", [
    (GRANITE, "swiglu"), (GRANITE, "geglu"), (GRANITE, "gelu"),
    ("grok-1-314b", "geglu"), ("llama4-maverick-400b-a17b", "swiglu")])
def test_grouped_experts_are_the_per_expert_loop(name, variant, routing, t):
    """On the CPU ``ops.moe_grouped`` takes ``plain.moe_grouped``: the
    per-expert loop that ``_apply_sorted`` ran before, bit for bit, fed
    the offsets from the device-side count; so ``_apply_sorted`` is what
    it was, for every MLP variant, at grok's and llama4's widths, with one
    token and with counts that fill no tile."""
    from repro_torch.kernels import ops, plain

    cfg, p, x = _routed(name, variant, routing, t)
    e, k = cfg.num_experts, cfg.experts_per_token
    with torch.no_grad():
        want, (xf, order, idx, ys_before) = _loop_before(cfg, p, x)
        offsets = tmoe.expert_offsets(idx, e)
        ys = plain.moe_grouped(xf, order, offsets, p.get("w_gate"),
                               p["w_up"], p["w_down"], k=k, variant=variant)
        assert torch.equal(ys, ys_before)
        assert torch.equal(ops.moe_grouped(
            xf, order, offsets, p.get("w_gate"), p["w_up"], p["w_down"],
            k=k, variant=variant), ys)
        assert torch.equal(tmoe._apply_sorted(cfg, p, x), want)
    counts = (offsets[1:] - offsets[:-1]).tolist()
    assert sum(counts) == t * k
    if routing == "one":
        assert counts[:k] == [t] * k and not any(counts[k:])
    if routing == "empty":
        assert not any(counts[1::2])


def test_grouped_experts_refuse_what_the_kernel_does_not_take():
    from repro_torch.kernels import ops

    cfg, p, x = _routed(GRANITE, "swiglu", "natural", 5)
    xf = x.reshape(5, -1)
    _, idx = tmoe.top_gates(cfg, xf.float() @ p["router"])
    order = torch.argsort(idx.reshape(-1), stable=True)
    offsets = tmoe.expert_offsets(idx, cfg.num_experts)
    args = (p["w_gate"], p["w_up"], p["w_down"])
    with pytest.raises(ValueError, match="no MLP variant"):
        ops.moe_grouped(xf, order, offsets, *args, k=2, variant="relu")
    with pytest.raises(ValueError, match="takes no w_gate"):
        ops.moe_grouped(xf, order, offsets, *args, k=2, variant="gelu")
    with pytest.raises(ValueError, match="do not match"):
        ops.moe_grouped(xf, order, offsets, *args, k=3, variant="swiglu")
    with pytest.raises(ValueError, match="do not match"):
        ops.moe_grouped(xf, order, offsets[:-1], *args, k=2,
                        variant="swiglu")


def _conv_before(x, conv_w, conv_state=None, activation=None):
    """``ssm.causal_conv`` as it was before the conv bias."""
    k, s = conv_w.shape[0], x.shape[1]
    pad = (torch.zeros(x.shape[:1] + (k - 1,) + x.shape[2:], dtype=x.dtype)
           if conv_state is None else conv_state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    out = xp[:, 0:s] * conv_w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * conv_w[i]
    return activation(out), xp[:, -(k - 1):]


def _mixer_before(cfg, p, x, cache):
    """The SSD mixer (``ssm._ssd_mix`` and the in-projection) as it was
    before the conv bias and the config's norm eps."""
    di, ns = cfg.d_inner, cfg.ssm_state_dim
    nh, hd = cfg.ssm_num_heads, cfg.ssm_head_dim
    b, s, _ = x.shape
    z, xbc, dt = ssm._split_proj(cfg, torch.matmul(x, p["in_proj"]))
    xbc, _ = _conv_before(xbc, p["conv_w"], None if cache is None
                          else cache["conv"], activation=F.silu)
    xs = xbc[..., :di].reshape(b, s, nh, hd)
    B, C = xbc[..., di:di + ns], xbc[..., di + ns:]
    if cache is not None:
        from repro_torch.kernels import plain

        y, _ = plain.ssd_step(cache["state"].clone(), xs[:, 0], B[:, 0],
                              C[:, 0], dt[:, 0], p["dt_bias"], p["A_log"],
                              p["D"], in_place=True)
        y = y.reshape(b, 1, di)
    else:
        dt = L.softplus(dt.to(torch.float32) + p["dt_bias"])
        y4, _ = ssm.ssd_chunked(xs, dt, -torch.exp(p["A_log"]), B, C,
                                p["D"], cfg.ssm_chunk)
        y = y4.reshape(b, s, di)
    y = L.rmsnorm(y.to(x.dtype) * F.silu(z), p["norm_scale"])
    return torch.matmul(y, p["out_proj"])


def test_ssd_without_conv_bias_is_the_mixer_as_before():
    cfg = get_config("mamba2-1.3b").reduced()
    params = init_params(cfg, 4, "cpu")
    p = params["layers"][1]["mixer"]
    assert "conv_b" not in p and not cfg.ssm_conv_bias
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        x = torch.randn(2, 37, cfg.d_model, generator=g)
        assert torch.equal(ssm.apply_ssd(cfg, p, x),
                           _mixer_before(cfg, p, x, None))
        cache = ssm.init_ssd_cache(cfg, 2, torch.float32, "cpu")
        cache["conv"].normal_(generator=g)
        cache["state"].normal_(generator=g)
        x1 = torch.randn(2, 1, cfg.d_model, generator=g)
        want = _mixer_before(cfg, p, x1, cache)
        assert torch.equal(ssm.apply_ssd(cfg, p, x1, cache=cache), want)


@pytest.mark.parametrize("name", ["grok-1-314b",
                                  "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("full", [False, True])
def test_grok_and_llama4_route_as_before(name, full):
    """Their router stays softmax-then-k-rounds: ``_dispatch``'s combine
    weights are ``route``'s over the softmax of the logits, bit for
    bit."""
    cfg = get_config(name).reduced()
    assert cfg.moe_router == "softmax_topk"
    params = init_params(cfg, 7, "cpu")
    m = next(p["moe"] for p in params["layers"] if "moe" in p)
    x = torch.randn(3, 16, cfg.d_model,
                    generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        dispatch = "full" if full else "factor"
        combine, _, probs, _ = tmoe._dispatch(cfg, m, x, 2048, dispatch)
        n, g = tmoe.group_shape(48)
        c = tmoe._capacity(cfg, g, full=full)
        want = torch.softmax(x.reshape(n, g, -1) @ m["router"], dim=-1)
        assert torch.equal(probs, want)
        cw, _, _ = tmoe.route(cfg, want, c)
        assert torch.equal(combine, cw.to(x.dtype).reshape(n, g, -1))
        _, aux = tmoe.apply_moe(cfg, m, x, dispatch=dispatch)
        assert float(aux) > 0


def _serve(eng, prompts, new=8):
    reqs = [Request(rid=i, prompt=p, max_new_tokens=new, arrival_time=0.0,
                    sampling=SamplingParams()) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r, 0.0)
    t = 0.0
    while any(r.state.name != "FINISHED" for r in reqs):
        t += 1.0
        eng.step(t)
    eng.drain(t)
    return reqs


def test_engine_counts_moe_work_and_cache_bytes():
    """Under the strict policy with a router skewed to one expert: greedy
    streams are the full forward's argmax, the counters come from the
    shapes (the exact prefills token-sorted, the decode ticks at full
    capacity), nothing is dropped, no prefill blocks on a read of the
    per-expert counts (the ``moe.counts`` site is gone: the offsets stay
    on the device), and the step timeline's records carry the same
    counts."""
    cfg = tiny()
    params, m = _skewed(cfg)
    params["layers"][0] = dict(params["layers"][0], moe=m)
    slots, window = 3, 128
    eng = ServingEngine(cfg, params, EngineConfig(
        slots=slots, window=window, sync_every=4,
        moe_capacity_policy="strict", tracing=True), device="cpu")
    assert not eng.paged and eng.moe_capacity_policy == "strict"
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (9, 23, 17)]
    reqs = _serve(eng, prompts)
    for r in reqs:
        seq = np.concatenate([r.prompt, np.asarray(r.output[:-1], np.int32)])
        with torch.no_grad():
            lg, _ = forward(cfg, params, torch.from_numpy(seq)[None].long(),
                            moe_dispatch="full")
        assert r.output == lg[0, len(r.prompt) - 1:].argmax(-1).tolist()
        pre = next(s for s in r.trace.spans if s.kind == "prefill").timing
        assert "moe.counts" not in pre.syncs
        assert dict(pre.syncs) == {"exact.tokens": 1, "exact.len": 1,
                                   "exact.slot": 1, "first_token": 1}
        assert pre.counts["moe_routed_pairs"] == pre.counts[
            "moe_expert_rows"] == cfg.num_moe_layers * 2 * len(r.prompt)
    met = eng.metrics
    layers, k, e = cfg.num_moe_layers, 2, cfg.num_experts
    plen = sum(len(p) for p in prompts)
    ticks = met.decode_ticks
    assert met.moe_routed_pairs == layers * k * (plen + ticks * slots)
    assert met.moe_expert_rows == layers * (k * plen + ticks * slots * e)
    rep = eng.load_report()
    conv = (cfg.conv_kernel - 1) * (cfg.d_inner + 2 * cfg.ssm_state_dim)
    state = cfg.ssm_num_heads * cfg.ssm_head_dim * cfg.ssm_state_dim
    assert rep.state_bytes == 2 * slots * (conv + state) * 4
    assert rep.kv_ring_bytes == 2 * slots * window * 2 * 2 * 32 * 4
    wire = rep.to_dict()
    assert "state_bytes" not in wire and "kv_ring_bytes" not in wire
    assert type(rep).from_dict(wire) == rep


@pytest.mark.parametrize("step", ["exact", "sharded exact", "captured"])
@pytest.mark.parametrize("policy", ["strict", "backpressure", "drop"])
def test_one_resolver_decides_the_moe_dispatch(policy, step, monkeypatch):
    """``moe.resolve_dispatch``: token-sorted only for the eager exact
    prefill on one card under "strict", the whole group for every other
    "strict" step (a sharded replica's exact prefill too), the factor
    under the other policies. ``validate()`` refuses a float32 card
    exactly where it says token-sorted. On one card the engine serves
    with it: the MoE hook (``moe.sorted_span``: the step timeline's
    ``moe`` device span) is entered around each MoE layer of a
    token-sorted exact prefill and nowhere else, and every step counts
    the rows of the dispatch it took."""
    exact, sharded = step != "captured", step == "sharded exact"
    want = ("factor" if policy != "strict"
            else "sorted" if step == "exact" else "full")
    assert tmoe.resolve_dispatch(policy, exact=exact,
                                 sharded=sharded) == want
    grok = get_config("grok-1-314b").reduced()
    config = EngineConfig(moe_capacity_policy=policy, paged=not exact,
                          topology=DeviceTopology(tp=2 if sharded else 1))
    if want == "sorted":
        with pytest.raises(ValueError, match="another capacity policy"):
            config.validate(grok, devices=["cpu"], device="cuda")
    else:
        config.validate(grok, devices=["cpu"] * (2 if sharded else 1),
                        device="cuda")
    if sharded:
        return
    cfg = tiny()
    slots = 3
    eng = ServingEngine(cfg, init_params(cfg, 0, "cpu"), EngineConfig(
        slots=slots, window=128, sync_every=4, moe_capacity_policy=policy,
        tracing=True), device="cpu")
    assert eng._moe_dispatch(exact=exact) == want
    # the timeline as on a card (no CUDA events on the CPU): each step
    # noted, the device span recorded
    tl, now, spans, sorted_calls = eng._tl, [None], [], []

    def step_(run, kind, name, n, step, capture):
        now[0] = (kind, name)
        try:
            return run(kind, name, n, step, capture)
        finally:
            now[0] = None

    @contextlib.contextmanager
    def device_span(kind):
        spans.append((kind, now[0]))
        now.append("in span")
        try:
            yield
        finally:
            now.pop()

    apply_sorted = tmoe._apply_sorted

    def spy(*a):
        sorted_calls.append(now[-1])
        return apply_sorted(*a)

    monkeypatch.setattr(tl, "events", True)
    monkeypatch.setattr(tl, "step", step_)
    monkeypatch.setattr(tl, "device_span", device_span)
    monkeypatch.setattr(tmoe, "_apply_sorted", spy)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (9, 23)]
    reqs = _serve(eng, prompts)
    layers = cfg.num_moe_layers
    n_sorted = layers * len(prompts) if policy == "strict" else 0
    assert spans == [("moe", ("prefill", "exact"))] * n_sorted
    assert sorted_calls == ["in span"] * n_sorted
    prefill = eng._moe_dispatch(exact=True)
    for r in reqs:
        pre = next(s for s in r.trace.spans if s.kind == "prefill").timing
        assert (pre.counts["moe_routed_pairs"], pre.counts[
            "moe_expert_rows"]) == tuple(layers * v for v in tmoe.expert_rows(
                cfg, len(r.prompt), prefill))
    met = eng.metrics
    decode = layers * met.decode_ticks * tmoe.expert_rows(
        cfg, slots, eng._moe_dispatch())[1]
    assert met.moe_expert_rows == decode + sum(
        layers * tmoe.expert_rows(cfg, len(p), prefill)[1] for p in prompts)


@pytest.mark.parametrize("dtype,policy,paged,device,refused", [
    ("float32", "strict", None, "cuda", True),
    ("float32", "strict", False, "cuda:0", True),
    ("float16", None, None, "cuda", False),  # resolves to "drop"
    ("float32", "drop", None, "cuda", False),
    ("float32", "strict", None, "cpu", False),
    ("bfloat16", "strict", None, "cuda", False),
])
def test_engine_refuses_a_sorted_moe_prefill_the_card_has_no_kernel_for(
        dtype, policy, paged, device, refused):
    """The exact-length prefill of the "strict" policy on rolling caches
    routes the MoE layers through the grouped expert kernel on a CUDA
    card, bfloat16 only: the engine refuses another dtype when it is
    built (before it touches the card), and serves the rest: the CPU's
    plain version takes any dtype, and another policy keeps the capacity
    path."""
    cfg = dataclasses.replace(tiny(), dtype=dtype)
    config = EngineConfig(moe_capacity_policy=policy, paged=paged)
    if refused:
        with pytest.raises(ValueError, match="bfloat16 only on a CUDA"):
            config.validate(cfg, device=device)
        with pytest.raises(ValueError, match="another capacity policy"):
            ServingEngine(cfg, {}, config, device=device)
    else:
        assert config.validate(cfg, device=device) is config
    # on a grid the sorted path never runs: the grid's own refusal holds
    grid = EngineConfig(moe_capacity_policy=policy,
                        topology=DeviceTopology(tp=2))
    with pytest.raises(ValueError, match="Hybrid MoE on a grid"):
        grid.validate(cfg, devices=[device] * 2)


def test_validate_refuses_the_new_blocks_on_a_grid():
    for topo in (DeviceTopology(tp=2), DeviceTopology(dp=2)):
        config = EngineConfig(topology=topo)
        with pytest.raises(ValueError, match="Hybrid MoE on a grid"):
            config.validate(tiny(), devices=["cpu"] * 2)
        # a port-only field on an arch the grid serves is refused too
        grok = dataclasses.replace(get_config("grok-1-314b").reduced(),
                                   moe_router="topk_softmax")
        with pytest.raises(ValueError, match="Hybrid MoE on a grid"):
            config.validate(grok, devices=["cpu"] * 2)
        config.validate(get_config("grok-1-314b").reduced(),
                        devices=["cpu"] * 2)
    EngineConfig().validate(tiny())
