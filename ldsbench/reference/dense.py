"""Plain float32 reference of the dense GQA decoder (granite-8b).

The model as its paper describes it, in plain PyTorch, from the
benchmark's own weights: token embedding; per layer a pre-norm residual
GQA attention block with split-half RoPE (theta from the config) and a
pre-norm SwiGLU MLP; a final norm and the head, all in float32 with TF32
off, over the whole sequence at once (no cache, no paging, no batching).
RMSNorm multiplies by (1 + scale), the program's convention for the
scales the benchmark draws; query head h reads KV head h // (H / KV).

``logits_at`` runs layer by layer over every sequence, upcasting one
layer's weights at a time and attending in blocks of query rows, so the
whole model never lives in float32 at once. ``precision="fp8"`` is the
control: every projection's input rows and weight columns rounded to
float8 e4m3 with their own scales before the product.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32
Q_BLOCK = 1024
FP8_MAX = 448.0


def _fp8(t, dim):
    """t rounded to float8 e4m3 with one scale per slice along ``dim``
    (the amax over ``dim``), back in float32."""
    s = torch.clamp(t.abs().amax(dim=dim, keepdim=True) / FP8_MAX, min=1e-12)
    return (t / s).to(torch.float8_e4m3fn).to(F32) * s


def _mm(x, w, precision):
    if precision == "fp8":
        return _fp8(x, -1) @ _fp8(w, 0)
    return x @ w


def rmsnorm(x, scale, eps=1e-6):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + scale)


def rope(x, pos, theta):
    """x (S, H, D), pos (S,): split-half rotation by pos * theta^(-i/(D/2))."""
    half = x.shape[-1] // 2
    freq = torch.exp(-math.log(theta) * torch.arange(half, dtype=F32,
                                                     device=x.device) / half)
    ang = pos.to(F32)[:, None, None] * freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v):
    """Causal GQA over one sequence: q (S, H, D), k, v (S, KV, D)."""
    s, h, d = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)  # (H, S, D)
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    q = q.transpose(0, 1)
    out = torch.empty_like(q)
    for lo in range(0, s, Q_BLOCK):
        hi = min(s, lo + Q_BLOCK)
        sc = (q[:, lo:hi] @ k[:, :hi].transpose(1, 2)) * d ** -0.5
        qpos = torch.arange(lo, hi, device=q.device)[:, None]
        kpos = torch.arange(hi, device=q.device)[None, :]
        sc = sc.masked_fill(kpos > qpos, -math.inf)
        out[:, lo:hi] = torch.softmax(sc, dim=-1) @ v[:, :hi]
    return out.transpose(0, 1)


def _layer(c, p, x, precision):
    s = x.shape[0]
    d = c["d_model"]
    hd = c["head_dim"] or d // c["num_heads"]
    a = p["attn"]
    h = rmsnorm(x, p["norm1"]["scale"])
    q = _mm(h, a["wq"], precision).view(s, c["num_heads"], hd)
    k = _mm(h, a["wk"], precision).view(s, c["num_kv_heads"], hd)
    v = _mm(h, a["wv"], precision).view(s, c["num_kv_heads"], hd)
    pos = torch.arange(s, device=x.device)
    q, k = rope(q, pos, c["rope_theta"]), rope(k, pos, c["rope_theta"])
    x = x + _mm(attention(q, k, v).reshape(s, -1), a["wo"], precision)
    m = p["mlp"]
    h = rmsnorm(x, p["norm2"]["scale"])
    gate = torch.nn.functional.silu(_mm(h, m["w_gate"], precision))
    return x + _mm(gate * _mm(h, m["w_up"], precision), m["w_down"],
                   precision)


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.to(F32)


def logits_at(c, params, seqs, spans, *, precision="f32"):
    """seqs: token id tensors (S_i,) on the weights' device; spans:
    (start, end) per sequence. Returns, per sequence, the float32 logits
    (end - start, V) at positions [start, end)."""
    if c["arch_type"] != "dense" or c["mlp_variant"] != "swiglu":
        raise ValueError(f"{c['name']}: not a dense SwiGLU decoder")
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
            head = (params["embed"].T if c["tie_embeddings"]
                    else params["lm_head"]).to(F32)
            fin = params["final_norm"]["scale"].to(F32)
            return [rmsnorm(x[lo:hi], fin) @ head
                    for x, (lo, hi) in zip(xs, spans)]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
