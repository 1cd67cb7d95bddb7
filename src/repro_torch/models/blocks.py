"""Transformer blocks of the PyTorch port (the dense block type of
``repro.models.blocks``), with the main path's attention going through the
kernels' dispatch points (``repro_torch.kernels.ops``).

Params are plain dicts of tensors in the reference's (in, out) weight
orientation. Paged pools are updated IN PLACE (``index_put_``), where the
JAX package returns a new pytree: the engine owns one pool per layer and
nothing else holds a reference to it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as L

# Block types the port serves so far (ROADMAP.md queue 1 lists the rest).
PORTED_BLOCKS = ("dense",)


def init_attn(cfg, gen, dtype, device):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    q_dim, kv_dim = cfg.num_heads * hd, cfg.num_kv_heads * hd

    def normal(shape, std):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32) * std
        return w.to(dtype)

    std = d ** -0.5
    return {
        "wq": normal((d, q_dim), std),
        "wk": normal((d, kv_dim), std),
        "wv": normal((d, kv_dim), std),
        "wo": normal((q_dim, d), q_dim ** -0.5),
    }


def init_mlp(cfg, gen, d, ff, dtype, device):
    def normal(shape, std):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32) * std
        return w.to(dtype)

    if cfg.mlp_variant in ("swiglu", "geglu"):
        return {"w_gate": normal((d, ff), d ** -0.5),
                "w_up": normal((d, ff), d ** -0.5),
                "w_down": normal((ff, d), ff ** -0.5)}
    return {"w_up": normal((d, ff), d ** -0.5),
            "w_down": normal((ff, d), ff ** -0.5)}


def init_norm(cfg, d, dtype, device):
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def init_block(cfg, btype: str, gen, dtype, device):
    if btype not in PORTED_BLOCKS:
        raise ValueError(f"block type {btype!r} is not ported yet "
                         f"(ROADMAP.md queue 1, 'Other block families')")
    d = cfg.d_model
    return {"norm1": init_norm(cfg, d, dtype, device),
            "attn": init_attn(cfg, gen, dtype, device),
            "norm2": init_norm(cfg, d, dtype, device),
            "mlp": init_mlp(cfg, gen, d, cfg.dense_d_ff or cfg.d_ff, dtype,
                            device)}


def init_paged_block_cache(cfg, n_pages: int, page_size: int, dtype,
                           device):
    """One attention block's page pools (P, ps, kv, hd), shared by every
    slot. Zero-filled, never ``torch.empty``: unwritten slots are masked
    in the scores, but a masked slot still multiplies its V by 0, and
    0 * NaN would poison the row."""
    hd, kv = cfg.resolved_head_dim, cfg.num_kv_heads
    shape = (n_pages, page_size, kv, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def paged_write_index(pages, pos, s: int, page_size: int):
    """Where the S new tokens of each slot land, the same for every layer:
    token t of slot b goes to page ``pages[b, t // ps]`` at offset
    ``t % ps``; released slots point every entry at trash page 0. The page
    index is clamped to the table so a vacated slot whose position runs
    past ``max_seq`` keeps writing into the trash page. Returns (page ids,
    offsets), each (B, S) int64."""
    n_pages = pages.shape[1]
    t = pos.to(torch.int64)[:, None] + torch.arange(s, device=pos.device)
    idx = torch.clamp(t // page_size, max=n_pages - 1)
    return torch.gather(pages.to(torch.int64), 1, idx), t % page_size


def _paged_attn_decode(q, k, v, cache, pages, write_at, n_valid):
    """Write the chunk's K/V at ``write_at`` (``paged_write_index``), in
    place, and attend through the page table; ``n_valid`` (B,) int32 is
    each slot's token count including the S new ones."""
    phys, off = write_at
    cache["k"].index_put_((phys, off), k.to(cache["k"].dtype))
    cache["v"].index_put_((phys, off), v.to(cache["v"].dtype))
    return ops.paged_decode_attention(q, cache["k"], cache["v"], pages,
                                      n_valid)


def _attn_apply(cfg, p, x, rope, *, mode: str, cache=None, pages=None,
                write_at=None, n_valid=None):
    """Attention sub-block. ``rope`` is the step's ``L.rope_table``. mode
    "prefill": causal attention over the whole sequence (the prefill
    kernel); returns (out, (k, v)) so the caller can scatter the prompt's
    K/V into pages. mode "decode": K/V of the S new tokens go through the
    page table, then paged attention; returns (out, None)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    q = L.linear(x, p["wq"]).reshape(b, s, h, hd)
    k = L.linear(x, p["wk"]).reshape(b, s, kv, hd)
    v = L.linear(x, p["wv"]).reshape(b, s, kv, hd)
    if rope is not None:
        q, k = L.rotate(q, rope), L.rotate(k, rope)
    if mode == "decode":
        out = _paged_attn_decode(q, k, v, cache, pages, write_at, n_valid)
        new_kv = None
    else:
        out = ops.flash_attention(q, k, v, causal=cfg.causal)
        new_kv = (k, v)
    out = out.reshape(b, s, h * hd)
    return L.linear(out, p["wo"]), new_kv


def apply_block(cfg, btype: str, p, x, rope, *, mode: str, cache=None,
                pages=None, write_at=None, n_valid=None):
    """Pre-norm residual dense block. Returns (x, new_kv) where new_kv is
    the prompt's (k, v) in prefill mode and None in decode mode."""
    if btype not in PORTED_BLOCKS:
        raise ValueError(f"block type {btype!r} is not ported yet")
    h = L.apply_norm(cfg, p["norm1"], x)
    a, new_kv = _attn_apply(cfg, p["attn"], h, rope, mode=mode, cache=cache,
                            pages=pages, write_at=write_at, n_valid=n_valid)
    x = x + a
    h = L.apply_norm(cfg, p["norm2"], x)
    x = x + L.apply_mlp(cfg, p["mlp"], h)
    return x, new_kv
