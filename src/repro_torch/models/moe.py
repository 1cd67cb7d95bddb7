"""Mixture-of-Experts MLP of the PyTorch port (the reference's
``repro.models.moe``): grouped, capacity-based top-k dispatch.

Tokens are split into groups of ``g`` (``min(2048, t)``, halved until it
divides the token count t). Each group routes its tokens to experts with
a per-expert capacity ``c = max(int(g * k * capacity_factor / E) + 1,
k)`` (dispatch "factor"), or ``c = g`` (dispatch "full"), which no
routing pattern can overflow. A token past its expert's capacity is
dropped: its residual passes through untouched.

The routing is the reference's integer logic, step for step, so the same
tokens are kept and dropped in both packages: float32 router logits and
softmax; k rounds of argmax (the first index on ties, in both
``torch.argmax`` and ``jnp.argmax``); each token's slot in its expert's
buffer is the cumulative count of earlier tokens choosing that expert,
plus the slots the earlier rounds filled; ``keep = slot < c``. The
combine weights round to the activation dtype before ``dispatch =
combine > 0`` is taken from the rounded values. One-hots are comparisons
with an ``arange``, never ``F.one_hot`` (which checks its values on the
host), and nothing reads a value back: the routing runs inside a
captured CUDA graph at the fixed shape (N, g, E, C).

The expert products are batched matmuls over the (E, C) buffer of every
expert, as the reference's einsums: each expert's weights are read
whatever the routing. The reference's sharding hints have no
counterpart on one card.

``cfg.moe_router`` "topk_softmax" (Granite's ``TopKGating``, no JAX
twin) takes the top k of the float32 logits and the softmax over those
k: the gates sum to 1. It enters the same capacity routing as the k
picked gates, zeros elsewhere, so the k argmax rounds take the picks in
descending order.

Dispatch "sorted" (an eager step on one card) routes token-sorted
instead: each token goes through its own k experts only, in one grouped
product over every expert's rows (``ops.moe_grouped``: two launches of a
hand-written kernel on the card, the per-expert loop on the CPU), the
per-expert offsets left on the device. It drops nothing, as full capacity
does, and computes k rows a token where the (E, C) buffer computes E.

``resolve_dispatch`` decides a serving step's dispatch from the engine's
capacity policy and the kind of step; the engine and
``EngineConfig.validate`` both ask it.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import ops

F32 = torch.float32


def init_moe(cfg, gen, dtype, device):
    """Random router (d, E) float32 and expert stacks (E, d, ff) /
    (E, ff, d) in ``dtype``, scaled as the reference's init, plus the
    shared expert's MLP when the arch has one. Each expert is drawn on its
    own, so no float32 copy of a whole stack is ever made (llama4's
    (128, 5120, 8192) stack is 21.5 GB in float32)."""
    from repro_torch.models.blocks import init_mlp

    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts

    def stack(shape, std):
        w = torch.empty((e,) + shape, dtype=dtype, device=device)
        for i in range(e):
            w[i] = (torch.randn(shape, generator=gen, device=device,
                                dtype=F32) * std).to(dtype)
        return w

    p = {"router": torch.randn((d, e), generator=gen, device=device,
                               dtype=F32) * d ** -0.5}
    if cfg.mlp_variant != "gelu":
        p["w_gate"] = stack((d, ff), d ** -0.5)
    p["w_up"] = stack((d, ff), d ** -0.5)
    p["w_down"] = stack((ff, d), ff ** -0.5)
    if cfg.moe_shared_expert:
        p["shared"] = init_mlp(cfg, gen, d, cfg.moe_shared_d_ff or ff, dtype,
                               device)
    return p


def resolve_dispatch(policy: str, *, exact: bool = False,
                     sharded: bool = False) -> str:
    """The expert dispatch of a serving step under the engine's resolved
    capacity ``policy``: "factor" (the (E, C) buffer at
    ``moe_capacity_factor``) under "backpressure" and "drop"; under
    "strict", "sorted" (token-sorted) for the eager exact-length prefill
    (``exact``) on one card, else "full" (the buffer at the whole group),
    a sharded replica's exact prefill included: the grid has no
    token-sorted form."""
    if policy != "strict":
        return "factor"
    return "sorted" if exact and not sharded else "full"


_SORTED_SPAN = contextlib.nullcontext


@contextlib.contextmanager
def sorted_span(span):
    """Inside, every token-sorted MoE MLP (its routed and shared experts)
    runs inside ``span()``, a context manager: the serving engine's CUDA
    event pair for its step timeline's ``moe`` device seconds."""
    global _SORTED_SPAN
    prev, _SORTED_SPAN = _SORTED_SPAN, span
    try:
        yield
    finally:
        _SORTED_SPAN = prev


def _capacity(cfg, g: int, *, full: bool = False) -> int:
    """Per-expert capacity slots for a token group of ``g``; ``full``
    sizes the buffer to the whole group, which no routing can overflow
    (an expert receives at most one slot per token)."""
    if full:
        return g
    e, k = cfg.num_experts, cfg.experts_per_token
    c = int(g * k * cfg.moe_capacity_factor / e) + 1
    return max(c, k)


def drop_free_group(cfg, *, cap: int = 1 << 20) -> int:
    """Largest token group that can never drop a token under the
    configured ``moe_capacity_factor``, even if every token picks the same
    expert (which then needs capacity >= g); ``cap`` when the factor
    covers every group (k * capacity_factor >= E). The engine's
    "backpressure" policy clamps its slots to this bound and rejects
    prompts whose prefill group exceeds it."""
    e, k = cfg.num_experts, cfg.experts_per_token
    if not e or k * cfg.moe_capacity_factor >= e:
        return cap
    g = 1
    while g < cap and _capacity(cfg, g + 1) >= g + 1:
        g += 1
    return g


def group_shape(t: int, group_size: int = 2048):
    """(groups, group size) of ``t`` tokens: g = min(group_size, t),
    halved until it divides t."""
    g = min(group_size, t)
    while t % g:
        g //= 2
    return t // g, g


def top_gates(cfg, logits):
    """The "topk_softmax" router's picks: the top k of the float32
    ``logits`` (..., E) and the softmax over those k. Returns (gates,
    expert ids), each (..., k)."""
    vals, idx = torch.topk(logits, cfg.experts_per_token, dim=-1)
    return torch.softmax(vals, dim=-1), idx


def route(cfg, probs, c: int):
    """Top-k routing of router probabilities (N, g, E) float32 into
    capacity slots: returns (combine (N, g, E, C) float32 with each kept
    choice's gate at its expert and slot, keep (N, g, k) bool per round,
    the Switch aux loss's routed fraction (N, E))."""
    n, g, e = probs.shape
    k = cfg.experts_per_token
    experts = torch.arange(e, device=probs.device)
    slots = torch.arange(c, device=probs.device)
    combine = torch.zeros((n, g, e, c), dtype=F32, device=probs.device)
    gates = probs
    base = torch.zeros((n, e), dtype=torch.int32, device=probs.device)
    routed = torch.zeros((n, e), dtype=F32, device=probs.device)
    keeps = []
    for _ in range(k):
        idx = torch.argmax(gates, dim=-1)  # (N, g): first index on ties
        onehot = (idx[..., None] == experts).to(F32)  # (N, g, E)
        gate = (gates * onehot).sum(-1)
        # the token's slot in its expert's buffer
        pos_in_e = (torch.cumsum(onehot, dim=1) - onehot) + base[:, None, :]
        pos = (pos_in_e * onehot).sum(-1).to(torch.int32)  # (N, g)
        keep = pos < c
        pos_oh = (pos[..., None] == slots).to(F32) * keep[..., None]
        combine = combine + (gate[..., None, None] * onehot[..., None]
                             * pos_oh[:, :, None, :])
        base = base + onehot.sum(dim=1).to(torch.int32)
        routed = routed + onehot.mean(dim=1)
        gates = gates * (1.0 - onehot)
        keeps.append(keep)
    return combine, torch.stack(keeps, dim=-1), routed


def _dispatch(cfg, p, x, group_size: int, dispatch: str):
    """Route x (B, S, d) in groups and gather each expert's capacity
    buffer (``dispatch`` "factor" or "full"): (combine (N, g, E*C) in x's
    dtype, the buffers xe (E, N*C, d), probs (N, g, E) float32, the
    routed fraction (N, E))."""
    b, s, d = x.shape
    e = cfg.num_experts
    n, g = group_shape(b * s, group_size)
    c = _capacity(cfg, g, full=dispatch == "full")
    xg = x.reshape(n, g, d)
    logits = torch.matmul(xg.to(F32), p["router"].to(F32))  # (N, g, E)
    probs = torch.softmax(logits, dim=-1)
    if cfg.moe_router == "topk_softmax":  # the k picks' gates, zeros else
        gates, idx = top_gates(cfg, logits)
        probs = torch.zeros_like(logits).scatter_(-1, idx, gates)
    combine, _, routed = route(cfg, probs, c)
    combine = combine.to(x.dtype)  # the gates, rounded, then the dispatch
    dispatch = (combine > 0).to(x.dtype)
    # (N, g, E*C)^T @ (N, g, d): each expert slot holds one token or none
    xe = torch.matmul(dispatch.reshape(n, g, e * c).transpose(1, 2), xg)
    xe = xe.reshape(n, e, c, d).transpose(0, 1).reshape(e, n * c, d)
    return combine.reshape(n, g, e * c), xe, probs, routed


def _combine(combine, ye, shape):
    """Each token's gated sum of its experts' outputs ye (E, N*C, d), by
    the (N, g, E*C) combine weights, shaped ``shape`` (B, S, d)."""
    n, g, ec = combine.shape
    e, _, d = ye.shape
    ye = ye.reshape(e, n, ec // e, d).transpose(0, 1).reshape(n, ec, d)
    return torch.matmul(combine, ye).reshape(shape)


def expert_offsets(idx, e: int):
    """(E + 1,) int32 row offsets of each expert in the pairs sorted by
    expert, from the picks ``idx`` (..., k), on their device: a
    ``scatter_add_`` of ones and a cumsum (``torch.bincount`` would read
    the largest id to the host on the card)."""
    flat = idx.reshape(-1)
    counts = torch.zeros(e + 1, dtype=torch.int32, device=idx.device)
    counts.scatter_add_(0, flat + 1, torch.ones_like(flat, dtype=torch.int32))
    return torch.cumsum(counts, 0, dtype=torch.int32)


def _apply_sorted(cfg, p, x):
    """The routed experts of x (B, S, d), token-sorted: the (token,
    expert) pairs grouped by expert (a stable sort, so each expert's rows
    keep token order), each expert's MLP over its rows alone
    (``ops.moe_grouped``), and each token's gated sum over its k outputs
    in float32, in pick order. The gates round to x's dtype first, as the
    capacity path's combine weights do. Nothing is read to the host."""
    d, e, k = x.shape[-1], cfg.num_experts, cfg.experts_per_token
    xf = x.reshape(-1, d)
    logits = torch.matmul(xf.to(F32), p["router"].to(F32))
    if cfg.moe_router == "topk_softmax":
        gates, idx = top_gates(cfg, logits)
    else:
        gates, idx = torch.topk(torch.softmax(logits, dim=-1), k, dim=-1)
    order = torch.argsort(idx.reshape(-1), stable=True)
    ys = ops.moe_grouped(xf, order, expert_offsets(idx, e), p.get("w_gate"),
                         p["w_up"], p["w_down"], k=k,
                         variant=cfg.mlp_variant)
    picked = torch.empty_like(ys)
    picked[order] = ys  # back to (token, pick) order
    g = gates.to(x.dtype).to(F32)
    y = (picked.reshape(-1, k, d).to(F32) * g[..., None]).sum(dim=1)
    return y.to(x.dtype).reshape(x.shape)


def expert_rows(cfg, tokens: int, dispatch: str, group_size: int = 2048):
    """(routed pairs, expert-product rows) of one MoE layer over
    ``tokens`` tokens under ``dispatch``, from the shapes alone: k pairs
    a token; the token-sorted dispatch computes one row a pair, the
    capacity path every slot of its (E, C) buffer in every group."""
    pairs = tokens * cfg.experts_per_token
    if dispatch == "sorted":
        return pairs, pairs
    n, g = group_shape(tokens, group_size)
    return pairs, n * cfg.num_experts * _capacity(cfg, g,
                                                  full=dispatch == "full")


def apply_moe(cfg, p, x, *, group_size: int = 2048,
              dispatch: str = "factor"):
    """x (B, S, d) -> (y (B, S, d), aux loss, a float32 scalar), under
    ``dispatch`` "factor", "full" or "sorted" (``_apply_sorted``:
    dropless, no aux loss, inside ``sorted_span``'s span)."""
    from repro_torch.models.blocks import apply_mlp, mlp_hidden

    if dispatch == "sorted":
        with _SORTED_SPAN():
            y = _apply_sorted(cfg, p, x)
            if cfg.moe_shared_expert:
                y = y + apply_mlp(cfg, p["shared"], x)
        return y, 0.0
    combine, xe, probs, routed = _dispatch(cfg, p, x, group_size, dispatch)
    ye = torch.bmm(mlp_hidden(cfg, p, xe, torch.bmm), p["w_down"])
    y = _combine(combine, ye, x.shape)
    if cfg.moe_shared_expert:
        y = y + apply_mlp(cfg, p["shared"], x)
    e, k = cfg.num_experts, cfg.experts_per_token
    aux = (e * (routed / k) * probs.mean(dim=1)).sum(-1).mean()
    return y, aux


def apply_moe_sharded(cfg, ps, xs, *, group_size: int = 2048,
                      dispatch: str = "factor"):
    """``apply_moe`` over n shards (lists, one entry per shard, ``xs``
    whole on every shard), ``dispatch`` "factor" or "full". Every shard
    routes all tokens with the whole router (the same routing on each),
    then runs its block of the experts: under expert parallelism (``w_up``
    holds E / n experts) its experts' outputs, concatenated over the
    expert axis on every shard;
    with the experts split on ff, its block of their hidden,
    concatenated for the whole ``w_down``. Each shard then combines the
    whole (E, C) buffer with the single-card product: no shard adds
    another's partial sums. Returns the outputs (B, S, d) per shard."""
    from repro_torch.models.blocks import _mlp_sharded, gather, mlp_hidden

    e = cfg.num_experts
    combs, parts = [], []
    for j, (x, p) in enumerate(zip(xs, ps)):
        combine, xe, _, _ = _dispatch(cfg, p, x, group_size, dispatch)
        e_loc = p["w_up"].shape[0]
        if e_loc < e:  # expert parallel: this shard's experts
            xe = xe[j * e_loc:(j + 1) * e_loc]
        h = mlp_hidden(cfg, p, xe, torch.bmm)
        parts.append(torch.bmm(h, p["w_down"]) if e_loc < e else h)
        combs.append(combine)
    ys = []
    for j, (x, p) in enumerate(zip(xs, ps)):
        if p["w_up"].shape[0] < e:
            ye = gather(parts, x.device, dim=0)  # (E, N*C, d)
        else:
            h = parts[j]
            if h.shape[-1] < p["w_down"].shape[1]:  # ff-split experts
                h = gather(parts, x.device)
            ye = torch.bmm(h, p["w_down"])
        ys.append(_combine(combs[j], ye, x.shape))
    if cfg.moe_shared_expert:
        ys = [y + m for y, m in zip(ys, _mlp_sharded(
            cfg, [p["shared"] for p in ps], xs))]
    return ys
