"""RG-LRU recurrent block of the PyTorch port (RecurrentGemma / Griffin)
[arXiv:2402.19427], the torch twin of ``repro/models/rglru.py``.

y = out_proj( GeLU(gate_branch(x)) * RGLRU(conv1d(lin_branch(x))) )

RG-LRU recurrence (per channel):
    r_t = sigmoid(W_a u_t + b_a)            (recurrence gate)
    i_t = sigmoid(W_x u_t + b_x)            (input gate)
    log a_t = -c * softplus(Lambda) * r_t   (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The gates and the state are float32. Over a sequence (prefill) the gates
are computed in PyTorch and the recurrence runs through ``ops.rglru_scan``
(the RG-LRU scan kernel on the card; the reference uses an associative
scan, which sums in another order). One decode step is plain PyTorch, as
in the reference. The caches are updated IN PLACE, where the reference
returns new ones.

``apply_rglru_block_sharded`` runs the block over the shards of a
tensor-parallel group under the reference's bit-exact serving layout:
``w_gate_branch``, ``w_lin_branch``, ``w_a`` and ``w_x`` split by output
channel, ``w_out`` and the conv window and state whole on every shard.
Each shard gates, scans and steps its own block of channels (the scan
kernel at L / tp), and only concatenation crosses shards: every channel
is computed as on one card, in the same order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import softplus
from repro_torch.models.ssm import causal_conv

F32 = torch.float32
_C = 8.0


def init_rglru(cfg, gen, dtype, device):
    """Random weights, scaled as the reference's init (``Lambda`` such
    that a = exp(-c softplus(Lambda)) is uniform in (0.9, 0.999) at r = 1).
    Not the reference's bits: parity tests convert its weights."""
    d, lw = cfg.d_model, cfg.resolved_lru_width
    ck = cfg.conv_kernel

    def normal(shape, std):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=F32) * std
        return w.to(dtype)

    std = d ** -0.5
    u = torch.rand((lw,), generator=gen, device=device, dtype=F32)
    u = 0.9 + 0.099 * u
    lam = torch.log(torch.expm1(-torch.log(u) / _C))  # inverse softplus
    return {
        "w_gate_branch": normal((d, lw), std),
        "w_lin_branch": normal((d, lw), std),
        "w_out": normal((lw, d), lw ** -0.5),
        "conv_w": normal((ck, lw), 0.2),
        "w_a": normal((lw, lw), lw ** -0.5),
        "b_a": torch.zeros((lw,), dtype=F32, device=device),
        "w_x": normal((lw, lw), lw ** -0.5),
        "b_x": torch.zeros((lw,), dtype=F32, device=device),
        "Lambda": lam,
    }


def _rglru_gates(p, u, blk=slice(None)):
    """u (B, S, L) -> (a, gated input), both float32 (B, S, L), or (B, S,
    |blk|) for the channel block ``blk`` of a shard whose ``w_a`` / ``w_x``
    hold those output columns."""
    r = torch.sigmoid(torch.matmul(u, p["w_a"]).to(F32) + p["b_a"][blk])
    i = torch.sigmoid(torch.matmul(u, p["w_x"]).to(F32) + p["b_x"][blk])
    log_a = -_C * softplus(p["Lambda"][blk])[None, None, :] * r
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (
        i * u[..., blk].to(F32))
    return a, gated_in


def rglru_scan(p, u, h0=None, blk=slice(None)):
    """u (B, S, L) -> (y (B, S, L) in u's dtype, h_S (B, L) float32); the
    recurrence from ``h0`` (zeros when None) through the scan kernel; on
    channel block ``blk`` only (``_rglru_gates``; ``h0`` that block's)."""
    a, x = _rglru_gates(p, u, blk)
    if h0 is None:
        h0 = torch.zeros((u.shape[0], a.shape[2]), dtype=F32,
                         device=u.device)
    y, h = ops.rglru_scan(a.contiguous(), x.contiguous(),
                          h0.to(F32).contiguous())
    return y.to(u.dtype), h


def rglru_step(p, u, h_prev, blk=slice(None)):
    """One decode step. u (B, 1, L), h_prev (B, L) -> (y (B, 1, L), h);
    on channel block ``blk`` only (``h_prev`` that block's)."""
    a, x = _rglru_gates(p, u, blk)
    h = a[:, 0] * h_prev + x[:, 0]
    return h[:, None].to(u.dtype), h


def apply_rglru_block(cfg, p, x, *, cache=None):
    """Temporal-mixing block. x (B, S, d) -> y (B, S, d). ``cache``
    {"conv": (B, K-1, L), "state": (B, L) float32} or None (a prefill from
    nothing); when given, it is read and then overwritten in place with
    the new conv window and state. The one-shard case of
    ``apply_rglru_block_sharded``."""
    return apply_rglru_block_sharded(
        cfg, [p], [x], caches=None if cache is None else [cache])[0]


def apply_rglru_block_sharded(cfg, ps, xs, *, caches=None):
    """``apply_rglru_block`` over the n shards of a tensor-parallel group
    (lists, one entry per shard; ``xs`` whole on every shard, ``caches``
    whole on every shard). Shard j projects its column blocks of the gate
    and linear branches; the linear branch's blocks are concatenated, so
    every shard runs the depthwise conv over all channels (from its whole
    conv window) and holds the whole input of its ``w_a`` / ``w_x``
    column blocks; it gates and scans (or steps) its channel block from
    its block of the state; the gated outputs and the new states are
    concatenated on every shard, which projects the whole ``w_out`` and
    writes the whole conv window and state. Returns the outputs (B, S, d)
    per shard. Every shard reads its cache before any shard writes, so
    shards may share one cache tensor."""
    from repro_torch.models.blocks import gather

    s = xs[0].shape[1]
    gates = [F.gelu(torch.matmul(x, p["w_gate_branch"]), approximate="tanh")
             for x, p in zip(xs, ps)]
    lin = [torch.matmul(x, p["w_lin_branch"]) for x, p in zip(xs, ps)]
    lw = cfg.resolved_lru_width
    w = lin[0].shape[-1]
    split = w < lw
    ys, hs, convs = [], [], []
    for j, (x, p) in enumerate(zip(xs, ps)):
        dev = x.device
        u = gather(lin, dev) if split else lin[j]
        cache = caches[j] if caches is not None else None
        u, new_conv = causal_conv(u, p["conv_w"],
                                  cache["conv"] if cache is not None
                                  else None)
        blk = slice(j * w, (j + 1) * w) if split else slice(None)
        h0 = cache["state"][:, blk] if cache is not None else None
        if s == 1 and cache is not None:
            y, h = rglru_step(p, u, h0, blk)
        else:
            y, h = rglru_scan(p, u, h0, blk)
        ys.append(y * gates[j])
        hs.append(h)
        convs.append(new_conv)
    outs = []
    for j, (x, p) in enumerate(zip(xs, ps)):
        dev = x.device
        y = gather(ys, dev) if split else ys[j]
        outs.append(torch.matmul(y, p["w_out"]))
        if caches is not None:
            caches[j]["conv"].copy_(convs[j])
            caches[j]["state"].copy_(gather(hs, dev) if split else hs[j])
    return outs


def init_rglru_cache(cfg, batch: int, dtype, device):
    lw, k = cfg.resolved_lru_width, cfg.conv_kernel
    return {"conv": torch.zeros((batch, k - 1, lw), dtype=dtype,
                                device=device),
            "state": torch.zeros((batch, lw), dtype=F32, device=device)}
