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


def _rglru_gates(p, u):
    """u (B, S, L) -> (a, gated input), both float32 (B, S, L)."""
    r = torch.sigmoid(torch.matmul(u, p["w_a"]).to(F32) + p["b_a"])
    i = torch.sigmoid(torch.matmul(u, p["w_x"]).to(F32) + p["b_x"])
    log_a = -_C * softplus(p["Lambda"])[None, None, :] * r
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (
        i * u.to(F32))
    return a, gated_in


def rglru_scan(p, u, h0=None):
    """u (B, S, L) -> (y (B, S, L) in u's dtype, h_S (B, L) float32); the
    recurrence from ``h0`` (zeros when None) through the scan kernel."""
    a, x = _rglru_gates(p, u)
    if h0 is None:
        h0 = torch.zeros((u.shape[0], u.shape[2]), dtype=F32,
                         device=u.device)
    y, h = ops.rglru_scan(a.contiguous(), x.contiguous(),
                          h0.to(F32).contiguous())
    return y.to(u.dtype), h


def rglru_step(p, u, h_prev):
    """One decode step. u (B, 1, L), h_prev (B, L) -> (y (B, 1, L), h)."""
    a, x = _rglru_gates(p, u)
    h = a[:, 0] * h_prev + x[:, 0]
    return h[:, None].to(u.dtype), h


def apply_rglru_block(cfg, p, x, *, cache=None):
    """Temporal-mixing block. x (B, S, d) -> y (B, S, d). ``cache``
    {"conv": (B, K-1, L), "state": (B, L) float32} or None (a prefill from
    nothing); when given, it is read and then overwritten in place with
    the new conv window and state."""
    s = x.shape[1]
    gate = F.gelu(torch.matmul(x, p["w_gate_branch"]), approximate="tanh")
    u = torch.matmul(x, p["w_lin_branch"])
    conv_state = cache["conv"] if cache is not None else None
    u, new_conv = causal_conv(u, p["conv_w"], conv_state)
    if s == 1 and cache is not None:
        y, h = rglru_step(p, u, cache["state"])
    else:
        y, h = rglru_scan(p, u, cache["state"] if cache is not None
                          else None)
    out = torch.matmul(y * gate, p["w_out"])
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(h)
    return out


def init_rglru_cache(cfg, batch: int, dtype, device):
    lw, k = cfg.resolved_lru_width, cfg.conv_kernel
    return {"conv": torch.zeros((batch, k - 1, lw), dtype=dtype,
                                device=device),
            "state": torch.zeros((batch, lw), dtype=F32, device=device)}
