"""Primitive layers of the PyTorch port: norms, RoPE (standard, half and
Qwen2-VL's three-stream mrope), and the plain versions of the kernels
(attention, the int8 matmul, the sampler) — the torch twins of
``repro.models.layers`` on the main path.

All functions take tensors in the JAX package's layouts ((B, S, H, D)
activations, (P, ps, Hkv, D) page pools, (B, n_pages) page tables) and
repeat its arithmetic: matmul products of the model dtype accumulate in
float32, normalization statistics are float32. The kernels' plain
versions live beside the kernels (``repro_torch.kernels.plain``) and are
re-exported here under their reference names. The projections and MLPs,
which dispatch to a kernel for int8 weights, live in ``blocks``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.plain import (  # noqa: F401
    decode_attention,
    dense_attention,
    int8_matmul,
    paged_decode_attention,
    paged_decode_attention_int8,
    process_logits,
    sample_tokens,
    topk_sample,
)

F32 = torch.float32


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
    return rmsnorm(x, p["scale"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# RoPE (standard, half and mrope)
# ---------------------------------------------------------------------------

#: RoPE variants the port serves.
ROPE_VARIANTS = ("standard", "half", "mrope", "none")


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
    """Split-half rotation by a ``rope_table``, in float32, back to x's
    dtype: ``[x1 cos - x2 sin, x2 cos + x1 sin]`` over the table's width
    2*Dh, written as ``x * cos2 + roll(x, Dh) * sin2`` with cos2 = [cos,
    cos] and sin2 = [-sin, sin], which rounds the same, in 6 launches.
    A table narrower than x's last dim (the "half" variant) rotates the
    first 2*Dh lanes and passes the rest through untouched: the roll runs
    over the rotated lanes only, so lane i pairs with lane i + Dh there."""
    cos2, sin2 = table
    d_rot = cos2.shape[-1]
    if d_rot < x.shape[-1]:
        return torch.cat([rotate(x[..., :d_rot], table), x[..., d_rot:]],
                         dim=-1)
    xf = x.to(F32)
    rolled = torch.roll(xf, d_rot // 2, dims=-1)
    return (xf * cos2 + rolled * sin2).to(x.dtype)


def _mrope_angles(positions, sections, dim_half: int, theta: float):
    """Qwen2-VL's M-RoPE: positions (3, B, S), one stream per section of
    the D/2 frequencies (temporal, height, width). Section i takes the
    frequencies ``exp(-log(theta) * (j + off_i) / dim_half)``, j < its
    width, of stream i; the sections concatenate into (B, S, dim_half).
    Three equal streams give the standard variant's angles bit for bit
    (the same frequency, the same product)."""
    if positions.dim() != 3 or positions.shape[0] != 3:
        raise ValueError(f"mrope needs (3, B, S) positions, got "
                         f"{tuple(positions.shape)}")
    if sum(sections) != dim_half:
        raise ValueError(f"mrope sections {tuple(sections)} must sum to "
                         f"head_dim / 2 = {dim_half}")
    angs, off = [], 0
    for i, sec in enumerate(sections):
        j = torch.arange(sec, dtype=F32, device=positions.device) + off
        freqs = torch.exp(torch.tensor(-math.log(theta), dtype=F32) * j
                          / dim_half)
        angs.append(positions[i].to(F32)[..., None] * freqs)
        off += sec
    return torch.cat(angs, dim=-1)


def rope_table(cfg, positions):
    """The rotation table of positions (B, S) for q and k of every layer:
    ``(cos2, sin2)``, each (B, S, 1, 2*Dh) float32 (see ``rotate``), with
    Dh = D/2 ("standard", and "mrope" over positions (3, B, S): one stream
    per frequency section) or D/4 ("half": ChatGLM's rotation of the
    first half of each head, angles of width D/4 as the reference's);
    None without RoPE. The model builds it once per forward or decode
    step, where the reference's per-layer recomputation is fused away by
    XLA and eager PyTorch would pay ~10 launches per layer for it."""
    if cfg.rope_variant == "none":
        return None
    if cfg.rope_variant not in ROPE_VARIANTS:
        raise ValueError(f"unknown rope variant {cfg.rope_variant!r}")
    d = cfg.resolved_head_dim
    if cfg.rope_variant == "mrope":
        ang = _mrope_angles(positions, cfg.mrope_sections, d // 2,
                            cfg.rope_theta)
        return _table(ang[:, :, None, :])
    width = d // 2 if cfg.rope_variant == "standard" else d // 4
    ang = _rope_angles(positions, width, cfg.rope_theta)
    return _table(ang[:, :, None, :])


def apply_rope(cfg, x, positions):
    """x: (B, S, H, D). positions: (B, S) integer, or (3, B, S) for
    mrope."""
    table = rope_table(cfg, positions)
    return x if table is None else rotate(x, table)


def softplus(x):
    """JAX's ``softplus``: ``logaddexp(x, 0)`` (no threshold, unlike
    ``F.softplus``)."""
    return torch.logaddexp(x, torch.zeros_like(x))
