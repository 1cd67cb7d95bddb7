"""Blocks of the PyTorch port (the ``dense``, ``encoder``, ``moe``,
``local_attn``, ``rglru`` and ``ssd`` block types of
``repro.models.blocks``), with the attention, the RG-LRU scan and the int8
projections going through the kernels' dispatch points
(``repro_torch.kernels.ops``). An ``encoder`` block is the dense block
with bidirectional attention.

Params are plain dicts of tensors in the reference's (in, out) weight
orientation. Paged pools, rolling rings and recurrent states are updated
IN PLACE, where the JAX package returns a new pytree: the engine owns one
cache per layer and nothing else holds a reference to it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.models.rglru import (
    apply_rglru_block,
    init_rglru,
    init_rglru_cache,
)
from repro_torch.models.ssm import apply_ssd, init_ssd, init_ssd_cache

F32 = torch.float32

# Block types the port carries (every block type of the reference).
PORTED_BLOCKS = ("dense", "encoder", "moe", "local_attn", "rglru", "ssd")

# Block types whose decode cache is a KV ring (vs recurrent state); the
# engine keys bucketed prefill off this (the reference's list).
KV_CACHE_BLOCKS = ("dense", "moe", "encoder", "local_attn")

# Block types servable from a paged KV cache (the reference's list):
# a local_attn ring IS its window (slot index != absolute position).
PAGED_BLOCKS = ("dense", "moe")


# ---------------------------------------------------------------------------
# KV quantization (int8 values + per-vector float32 scales)
# ---------------------------------------------------------------------------


def quantize_kv(t, group: int = 0):
    """Symmetric int8 quantization of a (..., S, kv, hd) K/V tensor, as the
    reference's ``blocks.quantize_kv``: one float32 scale per (token, kv
    head) vector, shaped (..., S, kv, 1). ``group`` > 1 that divides S
    shares one scale per ``group`` consecutive tokens (the "page" scale
    granularity); otherwise scales stay per token."""
    tf = t.to(F32)
    a = torch.amax(torch.abs(tf), dim=-1, keepdim=True)
    s = t.shape[-3]
    if group and group > 1 and s % group == 0:
        shp = a.shape
        grouped = shp[:-3] + (s // group, group) + shp[-2:]
        g = torch.amax(a.reshape(grouped), dim=-3, keepdim=True)
        a = g.expand(grouped).reshape(shp)
    scale = torch.clamp(a / 127.0, min=1e-8)
    q8 = torch.clamp(torch.round(tf / scale), -127, 127)
    return q8.to(torch.int8), scale


def dequantize_kv(q8, scale, dtype):
    return (q8.to(F32) * scale).to(dtype)


# ---------------------------------------------------------------------------
# Projections and MLPs
# ---------------------------------------------------------------------------


def linear(x, w):
    """``x @ w`` with the weight in the reference's (in, out) orientation.
    A plain tensor runs ``torch.matmul`` untouched; a ``{"w_q": int8,
    "scale": float32}`` dict (``model.quantize_weights``) runs weight-only
    int8 (``ops.int8_matmul``) over the leading dims flattened into M."""
    if isinstance(w, dict):
        k = x.shape[-1]
        y = ops.int8_matmul(x.reshape(-1, k).contiguous(), w["w_q"],
                            w["scale"])
        return y.reshape(*x.shape[:-1], y.shape[-1])
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
    if btype == "rglru":
        return {"norm1": init_norm(cfg, d, dtype, device),
                "mixer": init_rglru(cfg, gen, dtype, device),
                "norm2": init_norm(cfg, d, dtype, device),
                "mlp": init_mlp(cfg, gen, d, cfg.d_ff, dtype, device)}
    if btype == "ssd":  # the mixer alone: no norm2, no MLP
        return {"norm1": init_norm(cfg, d, dtype, device),
                "mixer": init_ssd(cfg, gen, dtype, device)}
    if btype == "moe":
        return {"norm1": init_norm(cfg, d, dtype, device),
                "attn": init_attn(cfg, gen, dtype, device),
                "norm2": init_norm(cfg, d, dtype, device),
                "moe": init_moe(cfg, gen, dtype, device)}
    return {"norm1": init_norm(cfg, d, dtype, device),
            "attn": init_attn(cfg, gen, dtype, device),
            "norm2": init_norm(cfg, d, dtype, device),
            "mlp": init_mlp(cfg, gen, d, cfg.dense_d_ff or cfg.d_ff, dtype,
                            device)}


def init_block_cache(cfg, btype: str, batch: int, window: int, dtype,
                     device, kv_dtype: str = ""):
    """One block's rolling decode cache: a KV ring (B, W, kv, hd), with
    W = min(window, local_window) for local attention, or the RG-LRU or
    SSD conv window and float32 state. Zero-filled (a masked ring row still
    multiplies its V by 0). ``kv_dtype`` "int8": int8 rings with float32
    scales (B, W, kv, 1), the chunked-prefill buffer under int8 pages."""
    if btype in KV_CACHE_BLOCKS:
        w = min(window, cfg.local_window) if btype == "local_attn" \
            else window
        shape = (batch, w, cfg.num_kv_heads, cfg.resolved_head_dim)
        if kv_dtype == "int8":
            scales = shape[:3] + (1,)
            return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                    "v": torch.zeros(shape, dtype=torch.int8, device=device),
                    "k_scale": torch.zeros(scales, dtype=F32, device=device),
                    "v_scale": torch.zeros(scales, dtype=F32, device=device)}
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if btype == "rglru":
        return init_rglru_cache(cfg, batch, dtype, device)
    if btype == "ssd":
        return init_ssd_cache(cfg, batch, dtype, device)
    raise ValueError(f"block type {btype!r} has no rolling cache in the "
                     f"port yet")


def init_paged_block_cache(cfg, n_pages: int, page_size: int, dtype,
                           device, kv_dtype: str = ""):
    """One attention block's page pools (P, ps, kv, hd), shared by every
    slot. Zero-filled, never ``torch.empty``: unwritten slots are masked
    in the scores, but a masked slot still multiplies its V by 0, and
    0 * NaN would poison the row. ``kv_dtype`` "int8" stores int8 values
    plus float32 scale pools (P, ps, kv, 1) addressed by the same page
    ids."""
    hd, kv = cfg.resolved_head_dim, cfg.num_kv_heads
    shape = (n_pages, page_size, kv, hd)
    if kv_dtype == "int8":
        scales = (n_pages, page_size, kv, 1)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(scales, dtype=F32, device=device),
                "v_scale": torch.zeros(scales, dtype=F32, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def last_writer(keys):
    """For n write targets ``keys`` (n,) int64, the index of the last
    write to each one's target. A CUDA scatter applies writes to one
    target in no fixed order, the CPU's in order (the last one wins):
    writes that all carry their last writer's values land alike on
    both."""
    n = keys.shape[0]
    idx = torch.arange(n, device=keys.device)
    same = keys[:, None] == keys[None, :]
    return torch.where(same, idx[None, :], -1).amax(dim=1)


def paged_write_index(pages, pos, s: int, page_size: int, *,
                      resolve_duplicates: bool = False):
    """Where the S new tokens of each slot land, the same for every layer:
    token t of slot b goes to page ``pages[b, t // ps]`` at offset
    ``t % ps``; released slots point every entry at trash page 0, where
    two idle lanes at positions equal modulo ps write the same row. The
    page index is clamped to the table so a vacated slot whose position
    runs past ``max_seq`` keeps writing into the trash page. Returns (page
    ids, offsets), each (B, S) int64, and, with ``resolve_duplicates``,
    the (B*S,) last writer of each write's row (``last_writer``), else
    None."""
    n_pages = pages.shape[1]
    t = pos.to(torch.int64)[:, None] + torch.arange(s, device=pos.device)
    idx = torch.clamp(t // page_size, max=n_pages - 1)
    phys, off = torch.gather(pages.to(torch.int64), 1, idx), t % page_size
    win = (last_writer((phys * page_size + off).reshape(-1))
           if resolve_duplicates else None)
    return phys, off, win


def _paged_attn_decode(q, k, v, cache, pages, write_at, n_valid):
    """Write the chunk's K/V at ``write_at`` (``paged_write_index``), in
    place, and attend through the page table; ``n_valid`` (B,) int32 is
    each slot's token count including the S new ones. Writes to one row
    carry their last writer's K/V when ``write_at`` resolves them. Over
    int8 pools the values and their per-token scales are written at the
    same addresses (decode-time writes are always per token, whatever the
    prefill's scale granularity)."""
    phys, off, win = write_at
    if win is not None:
        k, v = (t.reshape(-1, *t.shape[2:])[win].reshape(t.shape)
                for t in (k, v))
    if "k_scale" in cache:
        for name, t in (("k", k), ("v", v)):
            q8, scale = quantize_kv(t)
            cache[name].index_put_((phys, off), q8)
            cache[name + "_scale"].index_put_((phys, off), scale)
        return ops.paged_decode_attention_int8(
            q, cache["k"], cache["v"], cache["k_scale"], cache["v_scale"],
            pages, n_valid)
    cache["k"].index_put_((phys, off), k.to(cache["k"].dtype))
    cache["v"].index_put_((phys, off), v.to(cache["v"].dtype))
    return ops.paged_decode_attention(q, cache["k"], cache["v"], pages,
                                      n_valid)


def ring_fill(cache, k, v):
    """Store a prefill's keys in a fresh ring (B, W, kv, hd), in place:
    the last min(S, W) tokens, token t at ring row ``t % W``, which is
    where decode's writes (row ``pos % W``) assume them. (The reference
    stores the last W at rows 0..W-1, which its decode misreads after a
    prompt with S > W and S % W != 0: ROADMAP.md queue 3.) An int8 ring
    takes the tokens' per-token codes and scales, as the reference's
    prefill quantizes outside a page-scale hint."""
    s, w = k.shape[1], cache["k"].shape[1]
    n = min(s, w)
    rows = torch.arange(s - n, s, device=k.device) % w
    for name, t in (("k", k[:, s - n:]), ("v", v[:, s - n:])):
        if name + "_scale" in cache:
            t, scale = quantize_kv(t)
            cache[name + "_scale"][:, rows] = scale
        cache[name][:, rows] = t.to(cache[name].dtype)


def _ring_attn_decode(q, k, v, cache, pos):
    """Write the S new tokens' K/V at ring rows ``(pos + i) % W`` of each
    slot, in place, and attend the ring; ``pos`` (B,) int32 is each slot's
    token count before the S new ones. An int8 ring (the chunked-prefill
    buffer under int8 pages) takes the tokens' per-token codes and scales,
    and is attended dequantized to q's dtype, whole, as the reference
    does."""
    b, s = q.shape[:2]
    w = cache["k"].shape[1]
    rows = (pos.to(torch.int64)[:, None]
            + torch.arange(s, device=q.device)[None, :]) % w
    slots = torch.arange(b, device=q.device)[:, None]
    n_valid = (pos + s).to(torch.int32)
    if "k_scale" in cache:
        for name, t in (("k", k), ("v", v)):
            q8, scale = quantize_kv(t)
            cache[name].index_put_((slots, rows), q8)
            cache[name + "_scale"].index_put_((slots, rows), scale)
        return ops.decode_attention(
            q, dequantize_kv(cache["k"], cache["k_scale"], q.dtype),
            dequantize_kv(cache["v"], cache["v_scale"], q.dtype), n_valid)
    cache["k"].index_put_((slots, rows), k.to(cache["k"].dtype))
    cache["v"].index_put_((slots, rows), v.to(cache["v"].dtype))
    return ops.decode_attention(q, cache["k"], cache["v"], n_valid)


def _attn_apply(cfg, p, x, rope, *, mode: str, window: int = 0, cache=None,
                pos=None, pages=None, write_at=None, n_valid=None,
                causal: bool = True):
    """Attention sub-block. ``rope`` is the step's ``L.rope_table``;
    ``window`` > 0 is local attention. mode "prefill" or "train":
    attention over the whole sequence (the prefill kernel; bidirectional
    unless ``causal``), then, given a rolling ``cache``, the ring fill;
    returns (out, (k, v)) so the caller can scatter the prompt's K/V into
    pages. mode "decode": K/V of the S new
    tokens go through the page table (``pages``) and paged attention, or
    into the ring at ``pos`` and rolling-cache attention; returns (out,
    None)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    q = linear(x, p["wq"]).reshape(b, s, h, hd)
    k = linear(x, p["wk"]).reshape(b, s, kv, hd)
    v = linear(x, p["wv"]).reshape(b, s, kv, hd)
    if rope is not None:
        q, k = L.rotate(q, rope), L.rotate(k, rope)
    new_kv = None
    if mode == "decode" and pages is not None:
        out = _paged_attn_decode(q, k, v, cache, pages, write_at, n_valid)
    elif mode == "decode":
        out = _ring_attn_decode(q, k, v, cache, pos)
    else:
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        if cache is not None:
            ring_fill(cache, k, v)
        new_kv = (k, v)
    out = out.reshape(b, s, h * hd)
    return linear(out, p["wo"]), new_kv


def apply_block(cfg, btype: str, p, x, rope, *, mode: str, cache=None,
                pos=None, pages=None, write_at=None, n_valid=None,
                moe_full_cap: bool = False):
    """Pre-norm residual block: attention (dense, bidirectional in an
    ``encoder`` block, or local over ``cfg.local_window``) or the RG-LRU
    mixer, then the MLP (the MoE MLP in a ``moe`` block, at the whole
    group's capacity when ``moe_full_cap``: the engine's "strict" policy);
    or the SSD mixer alone (``x + ssd(norm1(x))``, no MLP). Returns (x,
    new_kv, aux): the prompt's (k, v) of an attention block in prefill
    mode, else None, and the block's aux loss (the MoE block's Switch
    load-balance term, a float32 scalar; 0.0 for any other block).
    ``cache`` is the block's paged pools (with ``pages``) or its rolling
    cache (ring or recurrent state, with the slots' positions ``pos`` in
    decode mode), updated in place."""
    if btype not in PORTED_BLOCKS:
        raise ValueError(f"block type {btype!r} is not ported yet")
    aux = 0.0
    h = L.apply_norm(cfg, p["norm1"], x)
    if btype == "ssd":
        return x + apply_ssd(cfg, p["mixer"], h, cache=cache), None, aux
    if btype == "rglru":
        a, new_kv = apply_rglru_block(cfg, p["mixer"], h, cache=cache), None
    else:
        window = cfg.local_window if btype == "local_attn" else 0
        a, new_kv = _attn_apply(cfg, p["attn"], h, rope, mode=mode,
                                window=window, cache=cache, pos=pos,
                                pages=pages, write_at=write_at,
                                n_valid=n_valid,
                                causal=cfg.causal and btype != "encoder")
    x = x + a
    h = L.apply_norm(cfg, p["norm2"], x)
    if btype == "moe":
        m, aux = apply_moe(cfg, p["moe"], h, full_cap=moe_full_cap)
    else:
        m = apply_mlp(cfg, p["mlp"], h)
    return x + m, new_kv, aux
