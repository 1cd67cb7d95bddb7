"""Weight-only int8 matmul: the wrapper of the hand-written Hopper kernel
``csrc/int8_matmul.cu`` (the port of TPU kernel 5,
``repro/kernels/int8_matmul.py::int8_matmul``) beside its plain version
``plain.int8_matmul``, and ``quantize_int8``, the JAX module's helper.

x (M, K) float32 or bfloat16, any M >= 1; w_q (K, N) int8 in the JAX
orientation; scale (N,) or (1, N) float32, applied per output column after
the float32 dot; the result (M, N) in x's dtype. K and N are multiples of
16. A CPU tensor goes to the plain version; a CUDA tensor launches the
kernel or raises."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import plain

F32 = torch.float32
_ENTRY = {torch.float32: "int8_matmul_f32", torch.bfloat16: "int8_matmul_bf16"}
DECODE_ROWS, PREFILL_ROWS = 16, 128  # rows of x per block
SMS = 132  # the H100's streaming multiprocessors
TARGET_BLOCKS = 4 * SMS  # a decode K split aims at four blocks per SM
MIN_TILES = 8  # and a split leaves each at least 8 tiles of K
DECODE_DEPTH = 64  # K rows per stage of the bf16 decode tile
MAX_CLUSTER = 8  # its K splits of one column tile form one cluster
DECODE_MIN_BLOCKS = 96  # it aims at one block per SM, at least 3/4 of them


def block_rows(m: int, dtype) -> int:
    """Rows of x per block: 16 for float32 x (the FMA tile, planned by
    ``k_splits``) and for bfloat16 decode batches (M <= 32: the decode
    tile, which takes all M rows at once, planned by ``decode_plan``),
    128 for bfloat16 prefill (M > 32, the warpgroup tile)."""
    return DECODE_ROWS if dtype == torch.float32 or m <= 32 \
        else PREFILL_ROWS


def block_cols(bm: int) -> int:
    """Output columns per block: 64 for the prefill tile, 128 otherwise."""
    return 64 if bm == PREFILL_ROWS else 128


def tile_depth(bm: int) -> int:
    """K rows per tile: 64 for the prefill tile, 32 otherwise."""
    return 64 if bm == PREFILL_ROWS else 32


def k_splits(m: int, k: int, n: int, bm: int):
    """(splits, kchunk) of the float32 and prefill tiles: how many blocks
    share one output tile's K, and the K rows each covers (a multiple of
    the tile depth). A call with
    fewer output tiles than SMs splits K: at decode (N / 128 column
    blocks) until about ``TARGET_BLOCKS`` are in flight; at prefill until
    about one block per SM."""
    bk = tile_depth(bm)
    blocks = -(-n // block_cols(bm)) * -(-m // bm)
    tiles = -(-k // bk)
    if blocks >= SMS:
        return 1, tiles * bk
    want = (-(-TARGET_BLOCKS // blocks) if bm == DECODE_ROWS
            else SMS // blocks)
    splits = max(1, min(want, tiles // MIN_TILES))
    per = -(-tiles // splits)
    return -(-tiles // per), per * bk


def decode_plan(m: int, k: int, n: int):
    """(columns per block, splits, kchunk) of the bf16 decode tile
    (M <= 32): the fewest K splits (a power of two up to 8, one
    thread-block cluster) that give at least ``DECODE_MIN_BLOCKS`` blocks
    at 128 or 64 columns per block (the wider on a tie), else 32 columns
    and 8 splits; never more splits than 64-row K tiles. Each split covers
    kchunk K rows (whole tiles; trailing splits may be empty). About one
    block per SM with long K runs measured faster on the H100 than two or
    more per SM with more splits (e.g. 4096x14336: 1 split, 112 blocks,
    against 2 splits, 224 blocks)."""
    k_tiles = -(-k // DECODE_DEPTH)
    best = (32, MAX_CLUSTER)
    for bn in (64, 128):
        tiles, splits = -(-n // bn), 1
        while tiles * splits < DECODE_MIN_BLOCKS and splits < MAX_CLUSTER:
            splits *= 2
        if tiles * splits >= DECODE_MIN_BLOCKS and (
                best[0] == 32 or splits <= best[1]):
            best = (bn, splits)
    bn, splits = best
    splits = min(splits, 1 << (k_tiles.bit_length() - 1))
    return bn, splits, -(-k_tiles // splits) * DECODE_DEPTH


def quantize_int8(w, axis: int = 0):
    """Symmetric per-output-channel int8 quantization of w (K, N), as the
    JAX package's ``kernels/int8_matmul.py::quantize_int8``: returns
    (w_q int8, scale (N,) float32)."""
    amax = torch.amax(torch.abs(w.to(F32)), dim=axis, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    w_q = torch.clamp(torch.round(w.to(F32) / scale), -127, 127)
    return w_q.to(torch.int8), scale.reshape(-1)


def int8_matmul(x, w_q, scale):
    name = "int8_matmul"
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0] \
            or scale.numel() != w_q.shape[1]:
        raise ValueError(f"{name}: want x (M, K), w_q (K, N), scale (N,); "
                         f"got {tuple(x.shape)}, {tuple(w_q.shape)}, "
                         f"{tuple(scale.shape)}")
    if not (x.device == w_q.device == scale.device):
        raise ValueError(f"{name}: x, w_q, scale on different devices")
    if x.device.type in build.PLAIN_DEVICES:
        return plain.int8_matmul(x, w_q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
    build.refuse_grad(name, x, scale)
    if x.dtype not in _ENTRY or w_q.dtype != torch.int8 \
            or scale.dtype != F32:
        raise ValueError(f"{name}: float32 or bfloat16 x, int8 w_q and "
                         f"float32 scale required, got {x.dtype}/"
                         f"{w_q.dtype}/{scale.dtype}")
    m, k = x.shape
    n = w_q.shape[1]
    if k % 16 or n % 16:
        raise ValueError(f"{name}: K = {k} and N = {n} must be multiples "
                         f"of 16 (the kernel's 16-byte loads)")
    if not (x.is_contiguous() and w_q.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError(f"{name}: x, w_q, scale must be contiguous")
    if x.data_ptr() % 16 or w_q.data_ptr() % 16:
        raise ValueError(f"{name}: x and w_q must be 16-byte aligned")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.dtype == torch.bfloat16 and m <= 32:
        bn, splits, kchunk = decode_plan(m, k, n)
        build.load().call("int8_matmul_decode_bf16", x.data_ptr(),
                          w_q.data_ptr(), scale.data_ptr(), y.data_ptr(), m,
                          k, n, bn, splits, kchunk, stream)
        build.LAUNCHES[name] += 1
        return y
    bm = block_rows(m, x.dtype)
    splits, kchunk = k_splits(m, k, n, bm)
    # the K split's float32 partials; freed on return, its memory is
    # reused only by later work on the same stream
    partial = (torch.empty((splits, m, n), dtype=F32, device=x.device)
               if splits > 1 else y)
    build.load().call(_ENTRY[x.dtype], x.data_ptr(), w_q.data_ptr(),
                      scale.data_ptr(), y.data_ptr(), partial.data_ptr(), m,
                      k, n, bm, splits, kchunk, stream)
    # the prefill tile is a kernel of its own and counts apart
    build.LAUNCHES[name + "_prefill" if bm == PREFILL_ROWS else name] += 1
    return y
