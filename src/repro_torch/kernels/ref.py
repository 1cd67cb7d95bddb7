"""Oracles of the JAX package's ``kernels/ref.py`` that the slice's
kernels are held against, in PyTorch (all arithmetic in float32)."""
from __future__ import annotations

import torch

F32 = torch.float32


def ref_attention(q, k, v, *, causal: bool = True):
    """q/k/v: (BH, S, D)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q.to(F32), k.to(F32)) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = torch.tril(torch.ones((sq, sk), dtype=torch.bool,
                                     device=q.device))
        s = s.masked_fill(~mask[None], -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.to(F32)).to(q.dtype)


def ref_decode_attention(q, k, v, n_valid):
    """q: (BH, S, D); k/v: (BH, W, D); n_valid: (BH,) valid slots for the
    LAST query row; row i sees n_valid - (S-1) + i."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q.to(F32), k.to(F32)) * scale
    w, sq = k.shape[1], q.shape[1]
    limit = (n_valid[:, None].to(torch.int64) - (sq - 1)
             + torch.arange(sq, device=q.device)[None, :])
    valid = torch.arange(w, device=q.device)[None, None, :] < limit[:, :, None]
    s = s.masked_fill(~valid, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.to(F32)).to(q.dtype)


def ref_paged_decode_attention(q, k_pool, v_pool, page_table, n_valid):
    """q: (B, S, H, D); pools: (P, ps, Hkv, D); page_table: (B, n_pages);
    n_valid: (B,) valid slots for the LAST query row."""
    b, sq, h, d = q.shape
    ps, hkv = k_pool.shape[1], k_pool.shape[2]
    n_pages = page_table.shape[1]
    w = n_pages * ps
    idx = page_table.to(torch.int64)
    k = k_pool[idx].reshape(b, w, hkv, d)
    v = v_pool[idx].reshape(b, w, hkv, d)
    rep = h // hkv
    kk = k.repeat_interleave(rep, dim=2).transpose(1, 2).reshape(b * h, w, d)
    vv = v.repeat_interleave(rep, dim=2).transpose(1, 2).reshape(b * h, w, d)
    qq = q.transpose(1, 2).reshape(b * h, sq, d)
    nv = torch.clamp(n_valid.to(torch.int64), max=w).repeat_interleave(h)
    out = ref_decode_attention(qq, kk, vv, nv)
    return out.reshape(b, h, sq, d).transpose(1, 2)


def ref_topk_sample(logits, k, temperature, uniform):
    """Sort-based oracle of the radix-select sampling kernel: Gumbel argmax
    over the k largest temperature-scaled logits (ties at the k-th value
    all survive). logits (B, V); k (B,) in [1, V]; uniform (B, V)."""
    x = logits.to(F32) / temperature.to(F32)[:, None]
    srt = torch.sort(x, dim=-1, descending=True).values
    kth = torch.gather(srt, 1, (k.to(torch.int64) - 1)[:, None])
    g = -torch.log(-torch.log(torch.clamp(uniform.to(F32), min=1e-12)))
    z = torch.where(x >= kth, x + g, torch.full_like(x, -float("inf")))
    return torch.argmax(z, dim=-1).to(torch.int32)


def ref_paged_decode_attention_int8(q, k_pool, v_pool, k_scale, v_scale,
                                    page_table, n_valid):
    """Oracle of the int8 paged kernel: dequantize the pools (int8 values
    times their (P, ps, Hkv, 1) float32 scales, rounded to q's dtype),
    then the paged oracle."""
    kd = (k_pool.to(F32) * k_scale.to(F32)).to(q.dtype)
    vd = (v_pool.to(F32) * v_scale.to(F32)).to(q.dtype)
    return ref_paged_decode_attention(q, kd, vd, page_table, n_valid)


def int8_attention_score_bound(q, k_scale):
    """Bound on the max absolute scaled-score error of int8-K attention
    against exact K: ``(max scale / 2) * max_row ||q||_1 * d^-1/2`` (a
    float32 scalar tensor)."""
    d = q.shape[-1]
    q1 = torch.sum(torch.abs(q.to(F32)), dim=-1)
    return 0.5 * torch.max(k_scale.to(F32)) * torch.max(q1) * float(d) ** -0.5


def int8_attention_output_bound(q, k_scale, v_scale, v_deq):
    """Bound on the max absolute output error of int8-K/V attention against
    exact attention: ``(e^{2 eps} - 1) * max|v_deq| + max(v_scale) / 2``
    with eps the score bound; ``v_deq`` is the dequantized V attended."""
    eps = int8_attention_score_bound(q, k_scale)
    vmax = torch.max(torch.abs(v_deq.to(F32)))
    return (torch.exp(2.0 * eps) - 1.0) * vmax \
        + 0.5 * torch.max(v_scale.to(F32))


def ref_int8_matmul(x, w_q, scales):
    """The looser oracle: the weight is scaled first, then the float32
    product, cast to x's dtype."""
    w = w_q.to(F32) * scales.reshape(1, -1).to(F32)
    return (x.to(F32) @ w).to(x.dtype)
