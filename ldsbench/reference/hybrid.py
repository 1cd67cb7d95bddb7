"""Plain float32 reference of the hybrid SSD / attention model with MoE
MLPs (granite-4.0-h-small).

The model as its published configuration describes it, in plain PyTorch,
from the benchmark's own weights: x0 = embedding_multiplier x embed[ids];
per layer h = x + r mixer(norm1(x)), then h + r (moe(u) + shared(u)) with
u = norm2(h) and r the residual multiplier. The mixer is the Mamba-2 SSD
mixer (``reference/ssd.py``'s, with the conv's bias added before the
SiLU; the state-space map in its quadratic form) on ``ssd_moe`` layers,
and causal GQA attention with no positional encoding and the softmax
scale ``attention_multiplier`` on ``moe`` layers. The MoE: float32
router logits, the top k of them and the softmax over those k as gates,
sum_e gate_e SwiGLU_e(u) over the k picks; the shared SwiGLU always on.
A final norm, the tied head, the logits / ``logits_scaling``.

Each sequence is computed whole, in float32 with TF32 off, layer by
layer over every sequence, one layer's weights upcast at a time, and
each expert over the rows that picked it. RMSNorm (eps ``norm_eps``)
multiplies by (1 + scale), the program's convention for the scales the
benchmark draws.
``precision="fp8"`` is the control: every projection's and expert
product's input rows and weight columns (the router's too) rounded to
float8 e4m3 with their own scales.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ldsbench.reference.dense import _f32, _mm, attention, rmsnorm
from ldsbench.reference.ssd import conv, ssd

F32 = torch.float32


def _ssd_mixer(c, m, h, precision):
    s = h.shape[0]
    d = c["d_model"]
    di, ns, hp = c["ssm_expand"] * d, c["ssm_state_dim"], c["ssm_head_dim"]
    zxbcdt = _mm(h, m["in_proj"], precision)
    z, xbc, dt = (zxbcdt[:, :di], zxbcdt[:, di:2 * di + 2 * ns],
                  zxbcdt[:, 2 * di + 2 * ns:])
    xbc = conv(xbc, m["conv_w"])
    if "conv_b" in m:
        xbc = xbc + m["conv_b"]
    xbc = F.silu(xbc)
    xs = xbc[:, :di].reshape(s, di // hp, hp)
    B, C = xbc[:, di:di + ns], xbc[:, di + ns:]
    dt = F.softplus(dt + m["dt_bias"])
    y = ssd(xs, dt, -torch.exp(m["A_log"]), B, C, m["D"]).reshape(s, di)
    y = rmsnorm(y * F.silu(z), m["norm_scale"], c["norm_eps"])
    return _mm(y, m["out_proj"], precision)


def _attention(c, a, h, precision):
    s = h.shape[0]
    hd = c["head_dim"] or c["d_model"] // c["num_heads"]
    q = _mm(h, a["wq"], precision).view(s, c["num_heads"], hd)
    k = _mm(h, a["wk"], precision).view(s, c["num_kv_heads"], hd)
    v = _mm(h, a["wv"], precision).view(s, c["num_kv_heads"], hd)
    # dense.attention scales by hd^-0.5: q carries the rest of the
    # published scale
    scale = c["attention_multiplier"] or hd ** -0.5
    q = q * (scale * hd ** 0.5)
    return _mm(attention(q, k, v).reshape(s, -1), a["wo"], precision)


def _swiglu(w_gate, w_up, w_down, u, precision):
    return _mm(F.silu(_mm(u, w_gate, precision)) * _mm(u, w_up, precision),
               w_down, precision)


def _moe(c, m, u, precision):
    """The routed experts and the shared one over u (S, d)."""
    k = c["experts_per_token"]
    logits = _mm(u, m["router"], precision)
    top, idx = torch.topk(logits, k, dim=-1)
    gates = torch.softmax(top, dim=-1)  # (S, k): sum to 1
    picked = torch.zeros((u.shape[0], k, u.shape[1]), dtype=F32,
                         device=u.device)
    for e in range(c["num_experts"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if len(tok):
            out = _swiglu(m["w_gate"][e], m["w_up"][e], m["w_down"][e],
                          u[tok], precision)
            picked[tok, slot] = out * gates[tok, slot, None]
    y = picked.sum(dim=1)
    if "shared" in m:
        sh = m["shared"]
        y = y + _swiglu(sh["w_gate"], sh["w_up"], sh["w_down"], u,
                        precision)
    return y


def _layer(c, p, x, precision):
    r = c["residual_multiplier"]
    h = rmsnorm(x, p["norm1"]["scale"], c["norm_eps"])
    if "attn" in p:
        out = _attention(c, p["attn"], h, precision)
    else:
        out = _ssd_mixer(c, p["mixer"], h, precision)
    x = x + r * out
    u = rmsnorm(x, p["norm2"]["scale"], c["norm_eps"])
    return x + r * _moe(c, p["moe"], u, precision)


def logits_at(c, params, seqs, spans, *, precision="f32"):
    """As ``dense.logits_at``: per sequence the float32 logits at
    positions [start, end)."""
    if c["arch_type"] != "hybrid" or "ssd_moe" not in c["block_pattern"]:
        raise ValueError(f"{c['name']}: not an SSD / attention MoE hybrid")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            xs = [params["embed"][t.long()].to(F32)
                  * c["embedding_multiplier"] for t in seqs]
            for p in params["layers"]:
                p32 = _f32(p)
                xs = [_layer(c, p32, x, precision) for x in xs]
                del p32
            head = params["embed"].T.to(F32)
            fin = params["final_norm"]["scale"].to(F32)
            return [rmsnorm(x[lo:hi], fin, c["norm_eps"]) @ head
                    / c["logits_scaling"]
                    for x, (lo, hi) in zip(xs, spans)]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
