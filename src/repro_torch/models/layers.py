"""Primitive layers of the PyTorch port: norms, RoPE, MLPs, attention and
the sampler — the torch twins of ``repro.models.layers`` on the main path.

All functions take tensors in the JAX package's layouts ((B, S, H, D)
activations, (P, ps, Hkv, D) page pools, (B, n_pages) page tables) and
repeat its arithmetic: matmul products of the model dtype accumulate in
float32, softmax and normalization statistics are float32, masked scores
are ``-1e30`` (not ``-inf``) and probabilities are cast to the query dtype
before the PV product. The attention and sampler functions here are the
PLAIN versions of the port's hand-written kernels (``repro_torch.kernels``):
the kernel wrappers call them for CPU tensors, and ``chip_smoke.py`` holds
each kernel against them on the card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F32 = torch.float32
NEG = -1e30
_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x, scale, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` in float32, back to
    x's dtype (``F.rms_norm`` is the same formula in one call)."""
    y = F.rms_norm(x.to(F32), (x.shape[-1],), eps=eps)
    return (y * (1.0 + scale.to(F32))).to(x.dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    xf = x.to(F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(F32) + bias.to(F32)).to(x.dtype)


def apply_norm(cfg, p, x):
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


# ---------------------------------------------------------------------------
# RoPE (standard)
# ---------------------------------------------------------------------------


def _rope_angles(positions, dim_half: int, theta: float):
    """positions (...,) -> angles (..., dim_half) in float32, with the
    reference's frequency recipe ``exp(-log(theta) * i / dim_half)``."""
    i = torch.arange(dim_half, dtype=F32, device=positions.device)
    freqs = torch.exp(torch.tensor(-math.log(theta), dtype=F32) * i
                      / dim_half)
    return positions.to(F32)[..., None] * freqs


def _rotate(x, angles):
    """x (..., 2*Dh) split-half rotation with angles (..., Dh)."""
    return rotate(x, _table(angles))


def _table(angles):
    cos, sin = torch.cos(angles), torch.sin(angles)
    return torch.cat([cos, cos], dim=-1), torch.cat([-sin, sin], dim=-1)


def rotate(x, table):
    """Split-half rotation of x (..., 2*Dh) by a ``rope_table``, in
    float32, back to x's dtype: ``[x1 cos - x2 sin, x2 cos + x1 sin]``
    written as ``x * cos2 + roll(x, Dh) * sin2`` with cos2 = [cos, cos]
    and sin2 = [-sin, sin], which rounds the same, in 6 launches."""
    cos2, sin2 = table
    xf = x.to(F32)
    rolled = torch.roll(xf, cos2.shape[-1] // 2, dims=-1)
    return (xf * cos2 + rolled * sin2).to(x.dtype)


def rope_table(cfg, positions):
    """The rotation table of positions (B, S) for q and k of every layer:
    ``(cos2, sin2)``, each (B, S, 1, Dh) float32 (see ``rotate``); None
    without RoPE. The model builds it once per forward or decode step,
    where the reference's per-layer recomputation is fused away by XLA
    and eager PyTorch would pay ~10 launches per layer for it."""
    if cfg.rope_variant == "none":
        return None
    if cfg.rope_variant != "standard":
        raise ValueError(
            f"rope variant {cfg.rope_variant!r} is not ported yet "
            f"(ROADMAP.md queue 1, 'Other block families')")
    ang = _rope_angles(positions, cfg.resolved_head_dim // 2,
                       cfg.rope_theta)
    return _table(ang[:, :, None, :])


def apply_rope(cfg, x, positions):
    """x: (B, S, H, D). positions: (B, S) integer."""
    table = rope_table(cfg, positions)
    return x if table is None else rotate(x, table)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def linear(x, w):
    """``x @ w`` with the weight in the reference's (in, out) orientation."""
    return torch.matmul(x, w)


def apply_mlp(cfg, p, x):
    if cfg.mlp_variant in ("swiglu", "geglu"):
        g = linear(x, p["w_gate"])
        u = linear(x, p["w_up"])
        act = (F.silu(g) if cfg.mlp_variant == "swiglu"
               else F.gelu(g, approximate="tanh"))
        h = act * u
    else:
        h = F.gelu(linear(x, p["w_up"]), approximate="tanh")
    return linear(h, p["w_down"])


# ---------------------------------------------------------------------------
# Attention — prefill (plain version of kernels/flash_attention)
# ---------------------------------------------------------------------------


def dense_attention(q, k, v, *, causal: bool):
    """Plain masked attention. q (B,Sq,H,D), k/v (B,Skv,Hkv,D); q head h
    reads kv head ``h // G``. Scores and softmax in float32, probabilities
    cast to ``q.dtype`` before PV, output in ``q.dtype``."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.to(F32).reshape(b, sq, hkv, g, d)
    scale = d ** -0.5
    scores = torch.einsum("bqcgd,bkcd->bcgqk", qg, k.to(F32)) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        scores = scores.masked_fill(~(kpos <= qpos), NEG)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bcgqk,bkcd->bqcgd", probs.to(q.dtype).to(F32),
                       v.to(F32))
    return out.reshape(b, sq, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Attention — decode against a rolling or paged KV cache
# ---------------------------------------------------------------------------


def decode_attention(q, k_cache, v_cache, pos):
    """q (B,S,H,D); k/v_cache (B,W,Hkv,D); pos (B,) = tokens written
    INCLUDING the S queries: query i of S sees ``pos - S + 1 + i`` slots
    (capped at W). Grouped-GQA contraction, as the reference."""
    b, w, hkv, d = k_cache.shape
    sq, h = q.shape[1], q.shape[2]
    g = h // hkv
    qg = q.to(F32).reshape(b, sq, hkv, g, d)
    scale = d ** -0.5
    scores = torch.einsum("bqcgd,bwcd->bcgqw", qg, k_cache.to(F32)) * scale
    pos = torch.as_tensor(pos, device=q.device).to(torch.int64)
    pos = pos.reshape(-1).expand(b)
    n_valid = torch.clamp(
        pos[:, None] - (sq - 1)
        + torch.arange(sq, device=q.device)[None, :], max=w)  # (B, S)
    valid = (torch.arange(w, device=q.device)[None, None, None, None, :]
             < n_valid[:, None, None, :, None])
    scores = scores.masked_fill(~valid, NEG)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bcgqw,bwcd->bqcgd", probs.to(q.dtype).to(F32),
                       v_cache.to(F32))
    return out.to(q.dtype).reshape(b, sq, h, d)


def paged_decode_attention(q, k_pool, v_pool, page_table, pos):
    """Decode attention through a paged KV cache (plain version of
    kernels/decode_attention): gathers each slot's pages into a linear
    (B, n_pages*ps, Hkv, D) view and runs ``decode_attention`` on it, so
    garbage in unwritten slots is hidden by the same validity mask."""
    b = q.shape[0]
    _, ps, hkv, d = k_pool.shape
    n_pages = page_table.shape[1]
    idx = page_table.to(torch.int64)
    k = k_pool[idx].reshape(b, n_pages * ps, hkv, d)
    v = v_pool[idx].reshape(b, n_pages * ps, hkv, d)
    return decode_attention(q, k, v, pos)


# ---------------------------------------------------------------------------
# Sampler (plain version of kernels/topk_sample)
# ---------------------------------------------------------------------------


def _float_bits_descending(x):
    """Order-isomorphic unsigned image of float32, held in int64 (torch on
    the CPU has no right shift for uint32): bigger float <=> bigger value.
    ``+ 0.0`` canonicalizes -0.0 first."""
    bits = (x.to(F32) + 0.0).view(torch.int32).to(torch.int64) & _U32
    return torch.where((bits >> 31) == 0, bits | 0x80000000, (~bits) & _U32)


def _radix_threshold(weights, mapped, target):
    """Per row, the largest mapped value t with ``sum(weights where mapped
    >= t) >= target``: 32 rounds of MSB-first bit building."""
    t = torch.zeros(weights.shape[0], dtype=torch.int64,
                    device=weights.device)
    zero = torch.zeros((), dtype=weights.dtype, device=weights.device)
    for b in range(32):
        cand = t | (1 << (31 - b))
        acc = torch.where(mapped >= cand[:, None], weights, zero).sum(-1)
        t = torch.where(acc >= target, cand, t)
    return t


def _restricted_probs(x, top_k, top_p):
    """Both cuts as thresholds over ONE logit-bit image: the k-th largest
    logit by a count radix, then the nucleus boundary by a mass radix over
    the restricted softmax weights. Rows without a cut (top_k <= 0,
    top_p >= 1) keep everything, as the reference's batch-wide skip does.
    Returns (keep mask, softmax weights with 0 outside the mask)."""
    v = x.shape[1]
    mapped = _float_bits_descending(x)
    k = torch.where(top_k > 0, torch.clamp(top_k, 1, v),
                    torch.full_like(top_k, v)).to(F32)
    kth = _radix_threshold(torch.ones_like(x), mapped, k)
    keep = mapped >= kth[:, None]
    w = torch.where(keep, torch.softmax(x, dim=-1), torch.zeros_like(x))
    target = torch.clamp(top_p.to(F32), 1e-30, 1.0) * w.sum(-1)
    pth = _radix_threshold(w, mapped, target)
    keep = keep & ((mapped >= pth[:, None]) | (top_p >= 1.0)[:, None])
    return keep, torch.where(keep, w, torch.zeros_like(w))


def process_logits(logits, temperature, top_k, top_p):
    """Temperature scale, then top-k and top-p restriction; removed entries
    come back ``-inf``."""
    x = logits.to(F32) / torch.clamp(temperature.to(F32), min=1e-6)[:, None]
    keep, _ = _restricted_probs(x, top_k, top_p)
    return torch.where(keep, x, torch.full_like(x, -math.inf))


def sample_tokens(logits, greedy, temperature, top_k, top_p, uniform):
    """Engine-facing masked composition: greedy rows take argmax (lowest
    index on ties); stochastic rows draw one token from the temperature-
    scaled, top-k/top-p-restricted softmax by inverse CDF with ONE uniform
    per row, ``min(u*total, nextafter(total, 0))`` against the cumulative
    masked weights. logits (B, V); greedy (B,) bool; temperature, top_p,
    uniform (B,) float32; top_k (B,) int. Returns (B,) int32."""
    last = logits.to(F32)
    greedy_tok = torch.argmax(last, dim=-1)
    x = last / torch.clamp(temperature.to(F32), min=1e-6)[:, None]
    _, pk = _restricted_probs(x, top_k, top_p)
    c = torch.cumsum(pk, dim=-1)
    total = c[:, -1]
    thresh = torch.minimum(uniform.to(F32) * total,
                           torch.nextafter(total, torch.zeros_like(total)))
    stoch = torch.argmax((c > thresh[:, None]).to(torch.int32), dim=-1)
    return torch.where(greedy.to(torch.bool), greedy_tok,
                       stoch).to(torch.int32)


def topk_sample(logits, k, temperature, uniform):
    """Plain version of the Pallas kernel's own semantics (kernels/
    topk_sample.py, TPU kernel 3): ``x = logits/T + 0.0``, keep ``x >=
    kth`` (the k-th largest by radix select), Gumbel argmax with the
    caller's (B, V) uniforms, lowest index on ties."""
    x = logits.to(F32) / temperature.to(F32)[:, None] + 0.0
    mapped = _float_bits_descending(x)
    kth = _radix_threshold(torch.ones_like(x), mapped, k.to(F32))
    keep = mapped >= kth[:, None]
    u = torch.clamp(uniform.to(F32), min=1e-12)
    z = torch.where(keep, x - torch.log(-torch.log(u)),
                    torch.full_like(x, NEG))
    return torch.argmax(z, dim=-1).to(torch.int32)
