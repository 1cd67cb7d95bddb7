"""Plain float32 reference of the Mamba-2 SSD model (mamba2-1.3b).

The model as its paper describes it, in plain PyTorch, from the
benchmark's own weights: token embedding; per layer ``x + mixer(norm(x))``
with the SSD mixer: ``in_proj`` to (z, x, B, C, dt); a causal depthwise
conv of width K over (x, B, C) and SiLU; dt = softplus(dt + dt_bias),
A = -exp(A_log); the state-space map in its quadratic ("dual") form,

    y_i = sum_{j <= i} (C_i . B_j) exp(sum_{j < t <= i} dt_t A) dt_j x_j
          + D x_i,

per head, with one B and C shared by the heads; then RMSNorm(y *
silu(z)) and ``out_proj``. A final norm and the tied head. No chunks, no
state is carried: each sequence is computed whole, in blocks of query
rows, in float32 with TF32 off. RMSNorm multiplies by (1 + scale), the
program's convention for the scales the benchmark draws.
``precision="fp8"`` is the control: the projections' input rows and
weight columns rounded to float8 e4m3 with their own scales.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ldsbench.reference.dense import _f32, _mm, rmsnorm

F32 = torch.float32
Q_BLOCK = 512


def conv(x, w):
    """Causal depthwise conv: x (S, C), w (K, C); out_t = sum_i w_i x_{t-K+1+i}."""
    k = w.shape[0]
    xp = torch.cat([x.new_zeros((k - 1, x.shape[1])), x])
    return sum(xp[i:i + x.shape[0]] * w[i] for i in range(k))


def ssd(x, dt, A, B, C, D):
    """x (S, H, P), dt (S, H), A (H), B, C (S, N), D (H) -> y (S, H, P)."""
    s = x.shape[0]
    cum = torch.cumsum(dt * A, dim=0).T  # (H, S): log-decay up to t
    xdt = (x * dt[..., None]).transpose(0, 1)  # (H, S, P)
    y = torch.empty_like(xdt)
    for lo in range(0, s, Q_BLOCK):
        hi = min(s, lo + Q_BLOCK)
        seg = cum[:, lo:hi, None] - cum[:, None, :hi]  # (H, i, j)
        keep = (torch.arange(hi, device=x.device)[None, :]
                <= torch.arange(lo, hi, device=x.device)[:, None])
        w = torch.where(keep, torch.exp(torch.where(keep, seg, 0.0)), 0.0)
        y[:, lo:hi] = (w * (C[lo:hi] @ B[:hi].T)) @ xdt[:, :hi]
    return y.transpose(0, 1) + D[:, None] * x


def _layer(c, p, x, precision):
    s = x.shape[0]
    d = c["d_model"]
    di, ns, hp = c["ssm_expand"] * d, c["ssm_state_dim"], c["ssm_head_dim"]
    m = p["mixer"]
    h = rmsnorm(x, p["norm1"]["scale"])
    zxbcdt = _mm(h, m["in_proj"], precision)
    z, xbc, dt = (zxbcdt[:, :di], zxbcdt[:, di:2 * di + 2 * ns],
                  zxbcdt[:, 2 * di + 2 * ns:])
    xbc = F.silu(conv(xbc, m["conv_w"]))
    xs = xbc[:, :di].reshape(s, di // hp, hp)
    B, C = xbc[:, di:di + ns], xbc[:, di + ns:]
    dt = F.softplus(dt + m["dt_bias"])
    y = ssd(xs, dt, -torch.exp(m["A_log"]), B, C, m["D"]).reshape(s, di)
    y = rmsnorm(y * F.silu(z), m["norm_scale"])
    return x + _mm(y, m["out_proj"], precision)


def logits_at(c, params, seqs, spans, *, precision="f32"):
    """As ``dense.logits_at``: per sequence the float32 logits at
    positions [start, end)."""
    if c["arch_type"] != "ssm":
        raise ValueError(f"{c['name']}: not an SSD model")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            xs = [params["embed"][t.long()].to(F32) for t in seqs]
            for p in params["layers"]:
                p32 = _f32(p)
                xs = [_layer(c, p32, x, precision) for x in xs]
                del p32
            head = params["embed"].T.to(F32)
            fin = params["final_norm"]["scale"].to(F32)
            return [rmsnorm(x[lo:hi], fin) @ head
                    for x, (lo, hi) in zip(xs, spans)]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
