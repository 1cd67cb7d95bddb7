"""Decode attention: the wrappers of the hand-written Hopper kernels
``csrc/paged_decode_attention.cu`` (the port of TPU kernel 2,
``repro/kernels/decode_attention.py::paged_decode_attention``),
``csrc/paged_decode_attention_int8.cu`` (TPU kernel 4,
``::paged_decode_attention_int8``) and ``csrc/decode_attention.cu`` (TPU
kernel 6, ``::decode_attention``, over a rolling cache: bfloat16 rings
take the one-pass tensor-core kernel of ``csrc/decode_sm90.cuh``, float32
rings the three launches of ``csrc/paged_decode.cuh``), beside their
plain versions ``plain.paged_decode_attention``,
``plain.paged_decode_attention_int8`` and ``plain.decode_attention``.

q (B, S, H, D); k/v_pool (P, ps, KVH, D) in the model layout, read through
their strides (no transpose per call); int8 pools come with float32 scale
pools (P, ps, KVH, 1), also read in place; page_table (B, n_pages) int32;
a rolling cache is k/v_cache (B, W, KVH, D), also read through its
strides; pos (B,) int32 = tokens written including the S queries. head_dim
32, 64, 128 or 256. A CPU tensor goes to the plain version; a CUDA tensor
launches the kernel or raises."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import plain

_ENTRY = {torch.float32: "paged_decode_attention_f32",
          torch.bfloat16: "paged_decode_attention_bf16"}
_ENTRY_INT8 = {torch.float32: "paged_decode_attention_int8_f32",
               torch.bfloat16: "paged_decode_attention_int8_bf16"}
_ENTRY_RING = {torch.float32: "decode_attention_f32",
               torch.bfloat16: "decode_attention_bf16"}
HEAD_DIMS = (32, 64, 128, 256)
MAX_ROWS = 64  # G * S query rows per (slot, kv head) block
TILE = 32  # cache slots per tile
TARGET_BLOCKS = 2 * 132  # two blocks for each of the H100's 132 SMs
SM90_TILE = 64  # cache rows per tile of the one-pass bf16 kernel
MAX_SPLITS_SM90 = 8  # its splits of one (slot, kv head): one cluster


def n_splits(b: int, hkv: int, window: int) -> int:
    """Blocks each (slot, kv head) pair's context is split across by the
    three-launch kernels (paged pools, float32 rings): enough pairs x
    splits to fill the card, never more splits than tiles."""
    return max(1, min(-(-TARGET_BLOCKS // (b * hkv)), -(-window // TILE)))


def n_splits_sm90(b: int, hkv: int, window: int) -> int:
    """Splits per (slot, kv head) of the one-pass bf16 kernel, one
    thread-block cluster: the power of two that brings pairs x splits to
    about ``TARGET_BLOCKS``, at most 8 and at most the 64-row tiles (one
    more power of two where the tiles are not one). At recurrentgemma's
    8 slots over 1 kv head that is 8 splits, 64 blocks: 16 or 32 splits
    merged across clusters measured slower on the H100."""
    want = min(-(-TARGET_BLOCKS // (b * hkv)), -(-window // SM90_TILE),
               MAX_SPLITS_SM90)
    return 1 << (max(1, want) - 1).bit_length()


def split_rows(nmax: int, nsplit: int, split: int):
    """[begin, end) of the rows of a slot with ``nmax`` valid rows that
    split ``split`` covers: whole 64-row tiles in contiguous runs (the
    kernel's ``sm90::split_rows``)."""
    tiles = -(-nmax // SM90_TILE)
    per = -(-tiles // nsplit)
    return (min(nmax, split * per * SM90_TILE),
            min(nmax, (split + 1) * per * SM90_TILE))


def _check_shapes(name, q, k_pool, v_pool, page_table, pos):
    """page_table None: the pools are rolling caches (B, W, KVH, D)."""
    if q.dim() != 4 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"{name}: want q (B,S,H,D), pools (P,ps,KVH,D) "
                         f"or caches (B,W,KVH,D); got {tuple(q.shape)}, "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    b, _, h, d = q.shape
    _, _, hkv, d2 = k_pool.shape
    rows = k_pool.shape[0] if page_table is None else page_table.shape[0]
    if d2 != d or h % hkv or rows != b or tuple(pos.shape) != (b,):
        table = None if page_table is None else tuple(page_table.shape)
        raise ValueError(f"{name}: shapes do not match: q "
                         f"{tuple(q.shape)} pool {tuple(k_pool.shape)} "
                         f"table {table} pos {tuple(pos.shape)}")


def _strides(name, pools, vec: int):
    """The pools' common strides; each pool needs a contiguous last axis,
    rows on ``vec``-element (16-byte) boundaries and a 16-byte base."""
    st = pools[0].stride()
    if (any(p.stride() != st for p in pools) or st[3] != 1
            or any(s % vec for s in st[:3])
            or any(p.data_ptr() % 16 for p in pools)):
        raise ValueError(f"{name}: pools need equal strides, a contiguous "
                         f"last axis and rows aligned to 16 bytes")
    return st[:3]


def _launch(name, entry, q, pools, scale_pools, page_table, pos):
    """Checks every kernel of the family shares, then one launch of
    ``entry`` (three kernels on the current stream; one for a bf16
    ring). ``page_table`` None: the pools are rolling caches (B, W, KVH,
    D), one page of W rows per slot, and the entry takes no table."""
    b, s, h, d = q.shape
    ring = page_table is None
    _, ps, hkv, _ = pools[0].shape
    n_pages = 1 if ring else page_table.shape[1]
    if pos.dtype != torch.int32 or not (ring
                                        or page_table.dtype == torch.int32):
        raise ValueError(f"{name}: page_table and pos must be int32")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not in {HEAD_DIMS}")
    rows = (h // hkv) * s
    if rows > MAX_ROWS:
        raise ValueError(f"{name}: G*S = {rows} query rows per kv head "
                         f"exceeds {MAX_ROWS}")
    strides = _strides(name, pools, 16 // pools[0].element_size())
    if scale_pools:
        strides += _strides(name, scale_pools, 1)
    if not (q.is_contiguous() and pos.is_contiguous()
            and (ring or page_table.is_contiguous())):
        raise ValueError(f"{name}: q, page_table, pos must be contiguous")
    out = torch.empty_like(q)
    window = n_pages * ps
    lib = build.load()
    if ring and q.dtype == torch.bfloat16:
        return _launch_sm90(name, entry, lib, q, pools, pos, out, strides,
                            window)
    nsplit = n_splits(b, hkv, window)
    # scratch of the kernel's three launches; freed on return, its memory
    # is reused only by later work on the same stream
    f32 = dict(dtype=torch.float32, device=q.device)
    scores = torch.empty((b, hkv, rows, -(-window // TILE) * TILE), **f32)
    stats = torch.empty((b, hkv, nsplit, rows, 2), **f32)
    partial = torch.empty((b, hkv, nsplit, rows, d), **f32)
    table = () if ring else (page_table.data_ptr(),)
    geometry = (ps,) if ring else (n_pages, ps)
    lib.call(entry, q.data_ptr(), *(p.data_ptr() for p in pools),
             *(p.data_ptr() for p in scale_pools), *table,
             pos.data_ptr(), out.data_ptr(), scores.data_ptr(),
             stats.data_ptr(), partial.data_ptr(), b, s, h, hkv, d,
             *geometry, *strides, nsplit, d ** -0.5,
             torch.cuda.current_stream(q.device).cuda_stream)
    build.LAUNCHES[name] += 1
    return out


def _launch_sm90(name, entry, lib, q, pools, pos, out, strides, window):
    """One launch of the one-pass bf16 kernel over rings (B, W, KVH, D)."""
    b, s, h, d = q.shape
    hkv = pools[0].shape[2]
    lib.call(entry, q.data_ptr(), *(p.data_ptr() for p in pools),
             pos.data_ptr(), out.data_ptr(), b, s, h, hkv, d, window,
             *strides, n_splits_sm90(b, hkv, window), d ** -0.5,
             torch.cuda.current_stream(q.device).cuda_stream)
    build.LAUNCHES[name] += 1
    return out


def decode_attention(q, k_cache, v_cache, pos):
    """Over rolling caches (B, W, KVH, D): query s of S sees
    ``min(pos - (S-1) + s, W)`` rows of its slot's ring."""
    name = "decode_attention"
    _check_shapes(name, q, k_cache, v_cache, None, pos)
    if q.device.type == "cpu":
        return plain.decode_attention(q, k_cache, v_cache, pos)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {q.device}")
    if q.dtype not in _ENTRY_RING or not (q.dtype == k_cache.dtype
                                          == v_cache.dtype):
        raise ValueError(f"{name}: float32 or bfloat16 q/caches required, "
                         f"got {q.dtype}/{k_cache.dtype}")
    return _launch(name, _ENTRY_RING[q.dtype], q, (k_cache, v_cache), (),
                   None, pos)


def paged_decode_attention(q, k_pool, v_pool, page_table, pos):
    name = "paged_decode_attention"
    _check_shapes(name, q, k_pool, v_pool, page_table, pos)
    if q.device.type == "cpu":
        return plain.paged_decode_attention(q, k_pool, v_pool, page_table, pos)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {q.device}")
    if q.dtype not in _ENTRY or not (q.dtype == k_pool.dtype
                                     == v_pool.dtype):
        raise ValueError(f"{name}: float32 or bfloat16 q/pools required, "
                         f"got {q.dtype}/{k_pool.dtype}")
    return _launch(name, _ENTRY[q.dtype], q, (k_pool, v_pool), (),
                   page_table, pos)


def paged_decode_attention_int8(q, k_pool, v_pool, k_scale, v_scale,
                                page_table, pos):
    """Over int8 pools with float32 scale pools (P, ps, KVH, 1): each
    element is ``(code * scale)`` rounded to q's dtype, then the model-
    dtype kernel's softmax and P V."""
    name = "paged_decode_attention_int8"
    _check_shapes(name, q, k_pool, v_pool, page_table, pos)
    if tuple(k_scale.shape) != tuple(k_pool.shape[:3]) + (1,) \
            or k_scale.shape != v_scale.shape:
        raise ValueError(f"{name}: scale pools must be (P, ps, KVH, 1), "
                         f"got {tuple(k_scale.shape)}, "
                         f"{tuple(v_scale.shape)} for pools "
                         f"{tuple(k_pool.shape)}")
    if q.device.type == "cpu":
        return plain.paged_decode_attention_int8(q, k_pool, v_pool, k_scale,
                                             v_scale, page_table, pos)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {q.device}")
    if q.dtype not in _ENTRY_INT8 or not (
            k_pool.dtype == v_pool.dtype == torch.int8
            and k_scale.dtype == v_scale.dtype == torch.float32):
        raise ValueError(f"{name}: float32 or bfloat16 q, int8 pools and "
                         f"float32 scales required, got {q.dtype}/"
                         f"{k_pool.dtype}/{k_scale.dtype}")
    return _launch(name, _ENTRY_INT8[q.dtype], q, (k_pool, v_pool),
                   (k_scale, v_scale), page_table, pos)
