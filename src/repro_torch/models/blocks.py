"""Blocks of the PyTorch port (the ``dense``, ``encoder``, ``moe``,
``local_attn``, ``rglru`` and ``ssd`` block types of
``repro.models.blocks``), with the attention, the RG-LRU scan and the int8
projections going through the kernels' dispatch points
(``repro_torch.kernels.ops``). An ``encoder`` block is the dense block
with bidirectional attention. ``ssd_moe`` (port-only: granite-4.0-h-small)
is the SSD mixer followed by a pre-norm MoE MLP; it serves on one card.
Granite's scalars: each sublayer's output times ``residual_multiplier``
into the residual, and q times ``attention_multiplier * sqrt(head_dim)``
before the kernels (which scale by 1 / sqrt(head_dim)), when set.

``apply_block_sharded`` runs a serving block (``dense``, ``moe``,
``local_attn``, ``rglru``, ``ssd``) over the shards of a sharded replica:
a grid of data rows, each a model group of tensor- (and expert-) parallel
shards, with only concatenation between shards.

``apply_block(..., parallel_block=True)`` is the reference's
``parallel_block`` lever as an explicit option: PaLM-style attention and
MLP side by side with one fused ``wo`` / ``w_down`` product.

Params are plain dicts of tensors in the reference's (in, out) weight
orientation. Paged pools, rolling rings and recurrent states are updated
IN PLACE, where the JAX package returns a new pytree: the engine owns one
cache per layer and nothing else holds a reference to it.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.moe import apply_moe, apply_moe_sharded, init_moe
from repro_torch.models.rglru import (
    apply_rglru_block,
    apply_rglru_block_sharded,
    init_rglru,
    init_rglru_cache,
)
from repro_torch.models.ssm import (
    apply_ssd,
    apply_ssd_sharded,
    init_ssd,
    init_ssd_cache,
)

F32 = torch.float32

# Block types the port carries (every block type of the reference, and
# the port-only ``ssd_moe``).
PORTED_BLOCKS = ("dense", "encoder", "moe", "local_attn", "rglru", "ssd",
                 "ssd_moe")

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


def mlp_hidden(cfg, p, x, mm=linear):
    """The MLP's hidden activations, ``act(x w_gate) * (x w_up)`` (swiglu,
    geglu) or ``gelu(x w_up)``, with the products of ``mm`` (``bmm`` over
    a MoE block's expert stacks)."""
    if cfg.mlp_variant in ("swiglu", "geglu"):
        g = mm(x, p["w_gate"])
        act = (F.silu(g) if cfg.mlp_variant == "swiglu"
               else F.gelu(g, approximate="tanh"))
        return act * mm(x, p["w_up"])
    return F.gelu(mm(x, p["w_up"]), approximate="tanh")


def apply_mlp(cfg, p, x):
    return linear(mlp_hidden(cfg, p, x), p["w_down"])


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
    if btype == "ssd_moe":
        return {"norm1": init_norm(cfg, d, dtype, device),
                "mixer": init_ssd(cfg, gen, dtype, device),
                "norm2": init_norm(cfg, d, dtype, device),
                "moe": init_moe(cfg, gen, dtype, device)}
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


def attn_cache_window(cfg, btype: str, seq_len: int) -> int:
    """KV window of a block's decode cache for a ``seq_len`` context (the
    reference's): a local-attention block's own window, else the whole
    sequence."""
    if btype == "local_attn":
        return min(cfg.local_window, seq_len)
    return seq_len


def init_block_cache(cfg, btype: str, batch: int, window: int, dtype,
                     device, kv_dtype: str = ""):
    """One block's rolling decode cache: a KV ring (B, W, kv, hd), with
    W = min(window, local_window) for local attention, or the RG-LRU or
    SSD conv window and float32 state. Zero-filled (a masked ring row still
    multiplies its V by 0). ``kv_dtype`` "int8": int8 rings with float32
    scales (B, W, kv, 1), the chunked-prefill buffer under int8 pages."""
    if btype in KV_CACHE_BLOCKS:
        shape = (batch, attn_cache_window(cfg, btype, window), cfg.num_kv_heads, cfg.resolved_head_dim)
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
    if btype in ("ssd", "ssd_moe"):
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


def kv_codes(cache, t, hd_part=None):
    """What a cache stores for K or V ``t`` (..., kv, hd) of whole heads:
    (values, per-vector scales or None), the int8 codes and their scales
    when the cache is int8 (quantized over the whole vector), the values
    narrowed to block j of n of head_dim when ``hd_part`` = (j, n) (a
    sharded replica's head_dim-split pools)."""
    scale = None
    if "k_scale" in cache:
        t, scale = quantize_kv(t)
    if hd_part is not None:
        j, n = hd_part
        w = t.shape[-1] // n
        t = t[..., j * w:(j + 1) * w]
    return t, scale


def decode_rows(k, v, pos, write_at, ring: int):
    """Where the S new tokens' K/V land in decode mode, and the K/V to
    write there: pool rows ``write_at`` (``paged_write_index``; writes to
    one row carry their last writer's K/V when it resolves them), or,
    with no ``write_at``, ring rows ``(pos + i) % ring`` of each slot
    (``pos`` (B,) the slots' token counts before the S new ones)."""
    if write_at is not None:
        phys, off, win = write_at
        if win is not None:
            k, v = (t.reshape(-1, *t.shape[2:])[win].reshape(t.shape)
                    for t in (k, v))
        return (phys, off), k, v
    b, s = k.shape[:2]
    rows = (pos.to(torch.int64)[:, None]
            + torch.arange(s, device=k.device)[None, :]) % ring
    return (torch.arange(b, device=k.device)[:, None], rows), k, v


def store_kv(cache, at, k, v, hd_part=None):
    """Write K/V at ``at`` into a pool or ring, in place: int8 caches take
    the per-token codes and scales at the same addresses (decode-time
    writes are always per token, whatever the prefill's scale
    granularity); ``hd_part`` as ``kv_codes``."""
    for name, t in (("k", k), ("v", v)):
        vals, scale = kv_codes(cache, t, hd_part)
        cache[name].index_put_(at, vals.to(cache[name].dtype))
        if scale is not None:
            cache[name + "_scale"].index_put_(at, scale)


def attend_cache(q, k, v, scales, pages, n_valid):
    """Decode attention of q (B, S, H, D) over pools (through the page
    table ``pages``) or rings, ``n_valid`` (B,) int32 each slot's token
    count including the S new ones: over int8 pools the int8 kernel with
    their ``scales`` (k, v), an int8 ring dequantized to q's dtype, whole,
    as the reference does, else the model dtype's kernel."""
    if pages is not None and scales is not None:
        return ops.paged_decode_attention_int8(q, k, v, *scales, pages,
                                               n_valid)
    if pages is not None:
        return ops.paged_decode_attention(q, k, v, pages, n_valid)
    if scales is not None:
        k, v = (dequantize_kv(t, sc, q.dtype) for t, sc in zip((k, v),
                                                                scales))
    return ops.decode_attention(q, k, v, n_valid)


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


def _attn_apply(cfg, p, x, rope, *, mode: str, window: int = 0, cache=None,
                pos=None, pages=None, write_at=None, n_valid=None,
                causal: bool = True, project: bool = True):
    """Attention sub-block. ``rope`` is the step's ``L.rope_table``;
    ``window`` > 0 is local attention. mode "prefill" or "train":
    attention over the whole sequence (the prefill kernel; bidirectional
    unless ``causal``), then, given a rolling ``cache``, the ring fill;
    returns (out, (k, v)) so the caller can scatter the prompt's K/V into
    pages. mode "decode": K/V of the S new
    tokens go through the page table (``pages``) and paged attention, or
    into the ring at ``pos`` and rolling-cache attention; returns (out,
    None). ``project`` False returns the heads' outputs (B, S, H * hd)
    before ``wo`` (the parallel block fuses it)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    q = linear(x, p["wq"]).reshape(b, s, h, hd)
    k = linear(x, p["wk"]).reshape(b, s, kv, hd)
    v = linear(x, p["wv"]).reshape(b, s, kv, hd)
    if rope is not None:
        q, k = L.rotate(q, rope), L.rotate(k, rope)
    if cfg.attention_multiplier:
        q = q * (cfg.attention_multiplier * hd ** 0.5)
    new_kv = None
    if mode == "decode":
        at, k, v = decode_rows(k, v, pos, write_at, cache["k"].shape[1])
        store_kv(cache, at, k, v)
        scales = ((cache["k_scale"], cache["v_scale"])
                  if "k_scale" in cache else None)
        if n_valid is None:  # a ring's count from its positions
            n_valid = (pos + s).to(torch.int32)
        out = attend_cache(q, cache["k"], cache["v"], scales, pages,
                           n_valid)
    else:
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        if cache is not None:
            ring_fill(cache, k, v)
        new_kv = (k, v)
    out = out.reshape(b, s, h * hd)
    if not project:
        return out, new_kv
    return linear(out, p["wo"]), new_kv


def apply_block(cfg, btype: str, p, x, rope, *, mode: str, cache=None,
                pos=None, pages=None, write_at=None, n_valid=None,
                moe_dispatch: str = "factor", parallel_block: bool = False):
    """Pre-norm residual block: attention (dense, bidirectional in an
    ``encoder`` block, or local over ``cfg.local_window``), the RG-LRU
    mixer or the SSD mixer (``ssd_moe``), then the MLP (the MoE MLP in a
    ``moe`` or ``ssd_moe`` block, under ``moe_dispatch``:
    ``moe.apply_moe``'s ``dispatch``); or the SSD mixer alone (``x +
    ssd(norm1(x))``, no MLP). Returns (x, new_kv, aux): the prompt's (k,
    v) of an attention block in prefill mode, else None, and the block's
    aux loss (the MoE block's Switch
    load-balance term, a float32 scalar; 0.0 for any other block).
    ``cache`` is the block's paged pools (with ``pages``) or its rolling
    cache (ring or recurrent state, with the slots' positions ``pos`` in
    decode mode), updated in place.

    ``parallel_block`` (the reference's lever of that name, off by
    default) computes an attention block as ``x + [attn(norm1(x)),
    mlp_hidden(norm2(x))] @ [wo; w_down]``: both norms read x, and the
    heads' outputs and the MLP hidden go through one fused product. A
    ``moe`` block and int8 weight leaves take the unfused path, as in the
    reference."""
    if btype not in PORTED_BLOCKS:
        raise ValueError(f"block type {btype!r} is not ported yet")
    aux = 0.0
    if (parallel_block and btype in KV_CACHE_BLOCKS and btype != "moe"
            and not isinstance(p["attn"]["wo"], dict)):
        x, new_kv = _parallel_block(cfg, btype, p, x, rope, mode=mode,
                                    cache=cache, pos=pos, pages=pages,
                                    write_at=write_at, n_valid=n_valid)
        return x, new_kv, aux
    h = L.apply_norm(cfg, p["norm1"], x)
    if btype == "ssd":
        return x + apply_ssd(cfg, p["mixer"], h, cache=cache), None, aux
    if btype == "rglru":
        a, new_kv = apply_rglru_block(cfg, p["mixer"], h, cache=cache), None
    elif btype == "ssd_moe":
        a, new_kv = apply_ssd(cfg, p["mixer"], h, cache=cache), None
    else:
        window = cfg.local_window if btype == "local_attn" else 0
        a, new_kv = _attn_apply(cfg, p["attn"], h, rope, mode=mode,
                                window=window, cache=cache, pos=pos,
                                pages=pages, write_at=write_at,
                                n_valid=n_valid,
                                causal=cfg.causal and btype != "encoder")
    x = _residual(cfg, x, a)
    h = L.apply_norm(cfg, p["norm2"], x)
    if "moe" in p:
        m, aux = apply_moe(cfg, p["moe"], h, dispatch=moe_dispatch)
    else:
        m = apply_mlp(cfg, p["mlp"], h)
    return _residual(cfg, x, m), new_kv, aux


def _residual(cfg, x, a):
    """``x + residual_multiplier * a`` (just ``x + a`` at 1)."""
    r = cfg.residual_multiplier
    return x + a if r == 1.0 else x + a * r


def _parallel_block(cfg, btype, p, x, rope, *, mode, **cache_kw):
    """The parallel attention + MLP block of ``apply_block``; returns (x,
    new_kv)."""
    window = cfg.local_window if btype == "local_attn" else 0
    ctx, new_kv = _attn_apply(cfg, p["attn"], L.apply_norm(cfg, p["norm1"],
                                                           x), rope,
                              mode=mode, window=window,
                              causal=cfg.causal and btype != "encoder",
                              project=False, **cache_kw)
    hid = mlp_hidden(cfg, p["mlp"], L.apply_norm(cfg, p["norm2"], x))
    w_cat = torch.cat([p["attn"]["wo"], p["mlp"]["w_down"]], dim=0)
    return x + torch.matmul(torch.cat([ctx, hid], dim=-1), w_cat), new_kv


# ---------------------------------------------------------------------------
# Sharded blocks: one replica over the shards of a mesh (data rows of
# tensor- and expert-parallel shards, the reference's bit-exact serving
# profile)
# ---------------------------------------------------------------------------
#
# Every argument that is a list holds one entry per shard, shard j's on its
# device, row-major over the data rows: the activations ``xs`` (each shard
# holds the whole of its row's: its block of the batch, or the whole
# batch when the rows do not divide it), the shards' params
# (``core.simd.sharding.place`` under ``serving_policy``), caches, page
# tables and positions. A shard computes only what its block
# of a weight determines with the whole contraction; blocks cross shards
# only by concatenation (``gather``), never by adding partial products, so
# each shard's result is the single-card one, bit for bit, wherever a
# block's product is the block of the whole product.


def gather(parts, device, dim: int = -1):
    """Concatenation of every shard's block of a tensor, on ``device``: the
    shards' all-gather (a peer copy from another card, none on the same
    device). Inside ``count_gathers()`` the bytes the destination
    receives from the other blocks are added to its count."""
    if _GATHERED is not None and len(parts) > 1:
        nbytes = sum(t.numel() * t.element_size() for t in parts)
        _GATHERED["bytes"] += nbytes - nbytes // len(parts)
        _GATHERED["calls"] += 1
    return torch.cat([t.to(device) for t in parts], dim=dim)


_GATHERED = None


@contextlib.contextmanager
def count_gathers():
    """Count what ``gather`` moves between shards while the block runs:
    yields {"bytes", "calls"}, each destination's incoming bytes (all but
    one equal block of each concatenation) summed over the calls (the
    dry run's counterpart of the reference's HLO collective bytes)."""
    global _GATHERED
    prev, _GATHERED = _GATHERED, {"bytes": 0, "calls": 0}
    try:
        yield _GATHERED
    finally:
        _GATHERED = prev


def rows_of(lst, tp: int) -> list:
    """A grid's per-shard list cut into its data rows of ``tp`` shards
    (shard j = row j // tp, model coordinate j % tp)."""
    return [lst[r:r + tp] for r in range(0, len(lst), tp)]


def by_rows(fn, tp: int, *lists):
    """``fn(*row)`` on each data row's slices of ``lists`` (None passes
    through), the results concatenated back into one per-shard list."""
    n = len(lists[0]) // tp
    rows = [[None] * n if x is None else rows_of(x, tp) for x in lists]
    return [y for r in zip(*rows) for y in fn(*r)]


def kv_layout(cfg, n: int, cache=None):
    """How a replica of ``n`` shards splits its K/V storage: "kv" (each
    shard keeps kv_heads / n whole heads, whenever n divides them), "hd"
    (each keeps a head_dim block of every head: ``cache``'s leaves are
    narrower than the head) or None (whole on every shard)."""
    if cfg.num_kv_heads % n == 0:
        return "kv"
    if cache is not None and cache["k"].shape[-1] < cfg.resolved_head_dim:
        return "hd"
    return None


def _head_plan(h: int, kv: int, n: int, j: int):
    """Shard j's query heads [a, e) (h / n each when n divides h, else the
    nearest split), the kv heads [ka, ke) they read, and whether those
    group evenly (h / kv queries each, in order); when they do not, each
    query head reads its own copy of its kv head (``_kv_index``)."""
    a, e = j * h // n, (j + 1) * h // n
    g = h // kv
    ka, ke = a // g, (e - 1) // g + 1 if e > a else a // g
    even = (a % g == 0 and e % g == 0) or ke - ka <= 1
    return a, e, ka, ke, even


def _kv_index(h: int, kv: int, plan, device):
    """The kv head within [ka, ke) of each of a plan's query heads, built
    on ``device`` (no host copy inside a captured step); None when they
    group evenly."""
    a, e, ka, _, even = plan
    if even:
        return None
    return torch.arange(a, e, device=device) // (h // kv) - ka


def _kv_read(caches, j, name, layout, ka, ke, idx):
    """Shard j's K/V (or scale) leaf ``name`` for kv heads [ka, ke) with
    whole head_dim, on its device (``caches`` the caches of shard j's data
    row, j its model coordinate): its own leaf under "kv" (which holds
    exactly those heads), the head_dim blocks of every shard of the row
    concatenated under "hd" (scales are whole there), else a slice of its
    whole leaf."""
    dev = caches[j][name].device
    if layout == "hd" and not name.endswith("_scale"):
        t = gather([c[name][:, :, ka:ke] for c in caches], dev)
    elif layout == "kv":
        t = caches[j][name]
    else:
        t = caches[j][name]
        if (ka, ke) != (0, t.shape[2]):
            t = t[:, :, ka:ke].contiguous()
    if idx is not None:
        t = t[:, :, idx].contiguous()
    return t


def _attn_sharded(cfg, ps, hs, ropes, *, tp: int, mode, window: int = 0,
                  caches=None, poss=None, pagess=None, write_ats=None,
                  n_valids=None, causal=True):
    """``_attn_apply`` over a grid of data rows of ``tp`` shards each (the
    lists hold one entry per shard, row-major): each shard projects its
    column blocks of q, k, v for its row's batch; takes the whole heads it
    needs (its own blocks under the "kv" layout, else the blocks of every
    shard of its row concatenated); rotates them; writes its part of the
    K/V into its cache (every shard of every row before any shard reads:
    the rows of a paged replica share their pools); attends its query
    heads (``_head_plan``) through the kernels; and the heads' outputs
    are concatenated on every shard of the row for the whole ``wo``.
    ``window`` > 0 is local attention (its ring, whole on every shard,
    when one kv head cannot split). Returns (outs, new_kvs): new_kvs[j]
    the (k, v) of the heads shard j stores, whole head_dim, in prefill
    mode, else None."""
    n = len(ps)
    hd, h, kv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    layout = kv_layout(cfg, tp, caches[0] if caches is not None else None)
    kvs = kv // tp if layout == "kv" else kv
    q_bl = [linear(x, p["wq"]) for x, p in zip(hs, ps)]
    k_bl = [linear(x, p["wk"]) for x, p in zip(hs, ps)]
    v_bl = [linear(x, p["wv"]) for x, p in zip(hs, ps)]
    split_q = q_bl[0].shape[-1] < h * hd
    split_kv = k_bl[0].shape[-1] < kv * hd

    def row(lst, j):
        return rows_of(lst, tp)[j // tp]

    qs, ks, vs, plans = [], [], [], []
    for j in range(n):
        dev, m = hs[j].device, j % tp
        b, s = hs[j].shape[:2]
        plan = _head_plan(h, kv, tp, m)
        a, e = plan[:2]
        if split_q and h % tp == 0:  # the block is the shard's heads
            q = q_bl[j].reshape(b, s, e - a, hd)
        else:
            q = (gather(row(q_bl, j), dev) if split_q else q_bl[j]).reshape(
                b, s, h, hd)[:, :, a:e]
        if layout == "kv" or not split_kv:
            k, v = k_bl[j], v_bl[j]
        else:
            k, v = gather(row(k_bl, j), dev), gather(row(v_bl, j), dev)
        k, v = k.reshape(b, s, kvs, hd), v.reshape(b, s, kvs, hd)
        if ropes[j] is not None:
            q, k = L.rotate(q, ropes[j]), L.rotate(k, ropes[j])
        qs.append(q.contiguous())
        ks.append(k)
        vs.append(v)
        plans.append(plan)
    if mode == "decode":  # the new tokens' K/V into every shard first
        for j, c in enumerate(caches):
            at, k, v = decode_rows(ks[j], vs[j], poss[j], write_ats[j],
                                   c["k"].shape[1])
            store_kv(c, at, k, v, (j % tp, tp) if layout == "hd" else None)
    elif caches is not None:  # a fresh rolling cache (never head_dim-split)
        for c, k, v in zip(caches, ks, vs):
            ring_fill(c, k, v)
    outs = []
    for j in range(n):
        a, e, ka, ke, _ = plans[j]
        q = qs[j]
        b, s = q.shape[:2]
        idx = _kv_index(h, kv, plans[j], q.device)
        if e == a:  # more shards than query heads: nothing to attend
            outs.append(q.reshape(b, s, 0))
            continue
        if mode != "decode":
            c0 = (j % tp) * kvs if layout == "kv" else 0
            sel = slice(ka - c0, ke - c0)
            k, v = ks[j][:, :, sel], vs[j][:, :, sel]
            if idx is not None:
                k, v = k[:, :, idx], v[:, :, idx]
            out = ops.flash_attention(q, k.contiguous(), v.contiguous(),
                                      causal=causal, window=window)
        else:
            cs = row(caches, j)
            k, v = (_kv_read(cs, j % tp, name, layout, ka, ke, idx)
                    for name in ("k", "v"))
            scales = (tuple(_kv_read(cs, j % tp, name, layout, ka, ke, idx)
                            for name in ("k_scale", "v_scale"))
                      if "k_scale" in caches[j] else None)
            out = attend_cache(q, k, v, scales, pagess[j], n_valids[j])
        outs.append(out.reshape(b, s, (e - a) * hd))
    ys = [linear(gather(row(outs, j), x.device), p["wo"])
          for j, (x, p) in enumerate(zip(hs, ps))]
    return ys, (None if mode == "decode" else list(zip(ks, vs)))


def _mlp_sharded(cfg, ps, xs):
    """``apply_mlp`` over the n shards of one data row: each its column
    block of the hidden (``w_gate`` / ``w_up`` split on ff, or whole), the
    blocks concatenated on every shard for the whole ``w_down``."""
    hb = [mlp_hidden(cfg, p, x) for x, p in zip(xs, ps)]
    split = hb[0].shape[-1] < ps[0]["w_down"].shape[0]
    return [linear(gather(hb, x.device) if split else h, p["w_down"])
            for x, h, p in zip(xs, hb, ps)]


def _moe_grid(cfg, ps, hs, tp: int, split: bool, dispatch: str):
    """The MoE MLP over a grid: the reference routes and sizes capacity
    over the whole batch's token group, so the rows' blocks of the batch
    (``split``) are concatenated at each model coordinate, the first row's
    shards run ``apply_moe_sharded`` on the whole batch, and every row
    takes its block of the output (its own under a whole batch)."""
    if len(ps) == tp:
        return apply_moe_sharded(cfg, ps, hs, dispatch=dispatch)
    whole = [gather(hs[m::tp], hs[m].device, dim=0) if split else hs[m]
             for m in range(tp)]
    ys = apply_moe_sharded(cfg, ps[:tp], whole, dispatch=dispatch)
    out = []
    for j, h in enumerate(hs):
        y = ys[j % tp]
        if split:
            b = h.shape[0]
            y = y[(j // tp) * b:(j // tp + 1) * b]
        out.append(y.to(h.device))
    return out


def apply_block_sharded(cfg, btype: str, ps, xs, ropes, *, mode: str,
                        tp: int = 0, split: bool = False, caches=None,
                        poss=None, pagess=None, write_ats=None,
                        n_valids=None, moe_dispatch: str = "factor"):
    """``apply_block`` over a grid of shards: lists with one entry per
    shard, row-major over data rows of ``tp`` shards (``tp`` 0: one row
    of all of them); ``split`` when each row holds its block of the batch
    (else every row the whole batch); ``caches`` and the rest as the
    single-card block's, per shard. Only concatenation crosses shards.
    The attention (``dense``, ``moe``, ``local_attn``), RG-LRU
    (``rglru``) and SSD (``ssd``) mixers each run their sharded form; a
    MoE block routes the whole batch (``_moe_grid``). Returns (xs,
    new_kvs): new_kvs[j] the prompt's (k, v) of the heads shard j stores,
    in prefill mode."""
    if btype not in ("dense", "moe", "local_attn", "rglru", "ssd"):
        raise ValueError(f"block type {btype!r} has no sharded form "
                         f"(serving blocks only)")
    tp = tp or len(ps)
    hs = [L.apply_norm(cfg, p["norm1"], x) for x, p in zip(xs, ps)]
    new_kvs = None
    if btype == "ssd":
        m = by_rows(lambda p, h, c: apply_ssd_sharded(
            cfg, [q["mixer"] for q in p], h, caches=c), tp, ps, hs, caches)
        return [x + y for x, y in zip(xs, m)], None
    if btype == "rglru":
        a = by_rows(lambda p, h, c: apply_rglru_block_sharded(
            cfg, [q["mixer"] for q in p], h, caches=c), tp, ps, hs, caches)
    else:
        a, new_kvs = _attn_sharded(
            cfg, [p["attn"] for p in ps], hs, ropes, tp=tp, mode=mode,
            window=cfg.local_window if btype == "local_attn" else 0,
            caches=caches, poss=poss, pagess=pagess, write_ats=write_ats,
            n_valids=n_valids, causal=cfg.causal)
    xs = [x + y for x, y in zip(xs, a)]
    hs = [L.apply_norm(cfg, p["norm2"], x) for x, p in zip(xs, ps)]
    if btype == "moe":
        m = _moe_grid(cfg, [p["moe"] for p in ps], hs, tp, split,
                      moe_dispatch)
    else:
        m = by_rows(lambda p, h: _mlp_sharded(cfg, [q["mlp"] for q in p], h),
                    tp, ps, hs)
    return [x + y for x, y in zip(xs, m)], new_kvs
