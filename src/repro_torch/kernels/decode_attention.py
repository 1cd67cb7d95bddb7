"""Paged decode attention: the wrapper of the hand-written Hopper kernel
``csrc/paged_decode_attention.cu`` (the port of TPU kernel 2,
``repro/kernels/decode_attention.py::paged_decode_attention``) beside its
plain version ``layers.paged_decode_attention``.

q (B, S, H, D); k/v_pool (P, ps, KVH, D) in the model layout, read through
their strides (no transpose per call); page_table (B, n_pages) int32;
pos (B,) int32 = tokens written including the S queries. A CPU tensor goes
to the plain version; a CUDA tensor launches the kernel or raises."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.models import layers as L

_ENTRY = {torch.float32: "paged_decode_attention_f32",
          torch.bfloat16: "paged_decode_attention_bf16"}
MAX_ROWS = 32  # G * S query rows per (slot, kv head) block
TILE = 32  # cache slots per tile
TARGET_BLOCKS = 2 * 132  # two blocks for each of the H100's 132 SMs


def n_splits(b: int, hkv: int, window: int) -> int:
    """Blocks each (slot, kv head) pair's context is split across: enough
    pairs x splits to fill the card, never more splits than tiles."""
    return max(1, min(-(-TARGET_BLOCKS // (b * hkv)), -(-window // TILE)))


def paged_decode_attention(q, k_pool, v_pool, page_table, pos):
    if q.dim() != 4 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"paged_decode_attention: want q (B,S,H,D), pools "
                         f"(P,ps,KVH,D); got {tuple(q.shape)}, "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    b, s, h, d = q.shape
    _, ps, hkv, d2 = k_pool.shape
    n_pages = page_table.shape[1]
    if d2 != d or h % hkv or page_table.shape[0] != b \
            or tuple(pos.shape) != (b,):
        raise ValueError("paged_decode_attention: shapes do not match: q "
                         f"{tuple(q.shape)} pool {tuple(k_pool.shape)} "
                         f"table {tuple(page_table.shape)} pos "
                         f"{tuple(pos.shape)}")
    if q.device.type == "cpu":
        return L.paged_decode_attention(q, k_pool, v_pool, page_table, pos)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for {q.device}")
    if q.dtype not in _ENTRY or not (q.dtype == k_pool.dtype
                                     == v_pool.dtype):
        raise ValueError(f"paged_decode_attention: float32 or bfloat16 "
                         f"q/pools required, got {q.dtype}/{k_pool.dtype}")
    if page_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("paged_decode_attention: page_table and pos must "
                         "be int32")
    if d not in (32, 64, 128):
        raise ValueError(f"paged_decode_attention: head_dim {d} not in "
                         f"(32, 64, 128)")
    rows = (h // hkv) * s
    if rows > MAX_ROWS:
        raise ValueError(f"paged_decode_attention: G*S = {rows} query rows "
                         f"per kv head exceeds {MAX_ROWS}")
    vec = 16 // k_pool.element_size()  # the kernel's 16-byte loads
    if (k_pool.stride() != v_pool.stride() or k_pool.stride(3) != 1
            or any(st % vec for st in k_pool.stride()[:3])
            or k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16):
        raise ValueError("paged_decode_attention: pools need equal strides, "
                         "a contiguous head_dim and rows aligned to 16 "
                         "bytes")
    if not (q.is_contiguous() and page_table.is_contiguous()
            and pos.is_contiguous()):
        raise ValueError("paged_decode_attention: q, page_table, pos must "
                         "be contiguous")
    out = torch.empty_like(q)
    window = n_pages * ps
    nsplit = n_splits(b, hkv, window)
    # scratch of the kernel's three launches; freed on return, its memory
    # is reused only by later work on the same stream
    f32 = dict(dtype=torch.float32, device=q.device)
    scores = torch.empty((b, hkv, rows, -(-window // TILE) * TILE), **f32)
    stats = torch.empty((b, hkv, nsplit, rows, 2), **f32)
    partial = torch.empty((b, hkv, nsplit, rows, d), **f32)
    sp, ss, sh, _ = k_pool.stride()
    lib = build.load()
    lib.call(_ENTRY[q.dtype], q.data_ptr(), k_pool.data_ptr(),
             v_pool.data_ptr(), page_table.data_ptr(), pos.data_ptr(),
             out.data_ptr(), scores.data_ptr(), stats.data_ptr(),
             partial.data_ptr(), b, s, h, hkv, d, n_pages, ps, sp, ss, sh,
             nsplit, d ** -0.5,
             torch.cuda.current_stream(q.device).cuda_stream)
    build.LAUNCHES["paged_decode_attention"] += 1
    return out
