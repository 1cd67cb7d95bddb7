"""Decode attention: the wrappers of the hand-written Hopper kernels
``csrc/paged_decode_attention.cu`` (the port of TPU kernel 2,
``repro/kernels/decode_attention.py::paged_decode_attention``),
``csrc/paged_decode_attention_int8.cu`` (TPU kernel 4,
``::paged_decode_attention_int8``) and ``csrc/decode_attention.cu`` (TPU
kernel 6, ``::decode_attention``, over a rolling cache), beside their
plain versions ``plain.paged_decode_attention``,
``plain.paged_decode_attention_int8`` and ``plain.decode_attention``.
bfloat16 calls take one launch of ``csrc/decode_sm90.cuh`` and allocate
only the output: bf16 and int8 pools the twin-order kernel (float32
score chains over d, the row's global max and float64 sum, p rounded to
bf16, then P V summed in float64: the plain version's bits), bf16 rings
the online-softmax kernel on the tensor cores. float32 calls take the three launches of ``csrc/paged_decode.cuh``
and their float32 scratch.

q (B, S, H, D); k/v_pool (P, ps, KVH, D) in the model layout, read through
their strides (no transpose per call); int8 pools come with float32 scale
pools (P, ps, KVH, 1), also read in place; page_table (B, n_pages) int32;
a rolling cache is k/v_cache (B, W, KVH, D), also read through its
strides; pos (B,) int32 = tokens written including the S queries. head_dim
32, 64, 128 or 256. Pools take at most 64 query rows (G * S) per (slot, kv
head); rolling caches any number, in groups of 64 (``ring_plan``): a chunk
of prefill over a linear buffer is G * S rows at once. A CPU tensor goes
to the plain version; a CUDA tensor launches the kernel or raises."""
from __future__ import annotations

import functools

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
MAX_ROWS = 64  # G * S query rows per (slot, kv head) block: a row group
TILE = 32  # cache slots per tile
TARGET_BLOCKS = 2 * 132  # two blocks for each of the H100's 132 SMs
SM90_TILE = 64  # cache rows per tile of the one-launch bf16 kernels
MAX_SPLITS_SM90 = 8  # their splits of one (slot, kv head): one cluster
SM90_MAX_SMEM = 232448  # a block's shared memory on the H100
SM90_MAX_RING = 8  # ring slots of the twin-order kernel
SM90_SM_SMEM = 233472  # an SM's shared memory; each block also takes 1 KB
TWIN_TARGET_BLOCKS = 2 * 8 * 132  # two waves of eight 64-thread blocks


def n_splits(b: int, hkv: int, window: int) -> int:
    """Blocks each (slot, kv head) pair's context is split across by the
    three-launch float32 kernels: enough pairs x splits to fill the card,
    never more splits than tiles."""
    return max(1, min(-(-TARGET_BLOCKS // (b * hkv)), -(-window // TILE)))


def n_splits_sm90(b: int, hkv: int, window: int,
                  target: int = TARGET_BLOCKS) -> int:
    """Splits per (slot, kv head) of the one-launch bf16 kernels, one
    thread-block cluster: the power of two that brings pairs x splits to
    about ``target`` blocks, at most 8 and at most the 64-row tiles (one
    more power of two where the tiles are not one). The online kernel
    aims at ``TARGET_BLOCKS``: at recurrentgemma's 8 slots over 1 kv head
    that is 8 splits, 64 blocks, as 16 or 32 splits merged across
    clusters measured slower on the H100. The twin-order kernel aims at
    ``TWIN_TARGET_BLOCKS``: at docqa's pools 8 splits 0.289 ms, 4 0.328, 2
    0.320 (one ring slot)."""
    want = min(-(-target // (b * hkv)), -(-window // SM90_TILE),
               MAX_SPLITS_SM90)
    return 1 << (max(1, want) - 1).bit_length()


def ring_plan(b: int, hkv: int, window: int, rows: int, bf16: bool):
    """(row groups, splits) of the rolling-cache kernels for ``rows`` =
    G * S query rows per (slot, kv head): groups of ``MAX_ROWS`` rows, each
    group its own blocks (its own cluster in bf16), and the splits of
    ``n_splits_sm90`` (bf16) or ``n_splits`` (float32) over b x groups
    (slot, group) pairs. One group (decode's S <= 16 at G 4) keeps the
    plan of the pairs alone."""
    groups = -(-rows // MAX_ROWS)
    split = n_splits_sm90 if bf16 else n_splits
    return groups, split(b * groups, hkv, window)


def twin_rows(rows: int, d: int):
    """(padded rows, threads) of a twin-order block for ``rows`` = G * S
    query rows at head_dim ``d`` (``csrc/decode_sm90.cuh`` ``twin_rp``,
    ``twin_rt``): 4, 8, 16, 32 or 64 rows in groups of 4 (up to 16 rows)
    or 8 (16 past 32 rows at head_dim 256); 64 threads a group."""
    rp = next(n for n in (4, 8, 16, 32, 64) if rows <= n or n == 64)
    rt = 4 if rp <= 16 else 8 if rp <= 32 or d <= 128 else 16
    return rp, 64 * (rp // rt)


def sm90_smem(d: int, rows: int, per: int, keep: bool, stages: int,
              int8: bool) -> int:
    """Shared-memory bytes of the twin-order kernel (``csrc/decode_sm90.cuh``
    ``twin_smem``): row statistics (the sums float64, the maxima
    float32), then float32 Q, over which ``keep`` puts one V tile's P in
    float64, int8's converted tile, the split's float32 scores of ``per``
    64-row tiles when ``keep`` (else P), and a ring of ``stages`` tiles;
    after them, over all but the statistics, the published O in float64
    (rows padded by 2, twice at head_dim 32, whose P V runs in two key
    groups)."""
    rp, _ = twin_rows(rows, d)
    slot = SM90_TILE * (d + 4) if int8 else SM90_TILE * d * 2
    p_tile = SM90_TILE * rp * 8
    work = (max(rp * d * 4, p_tile if keep else 0)
            + (SM90_TILE * d * 2 if int8 else 0)
            + (rp * per * SM90_TILE * 4 if keep else p_tile)
            + stages * slot)
    groups = 64 // d if d < 64 else 1
    return rp * 24 + max(work, groups * rp * (d + 2) * 8)


def twin_blocks_per_sm(d: int, rows: int, per: int, keep: bool,
                       stages: int, int8: bool) -> int:
    """Twin-order blocks one SM holds by shared memory, threads and the
    registers the kernel's launch bounds leave a thread (64 at 4 rows a
    thread in blocks of more than 64 threads, 128 at 4 rows in 64-thread
    blocks, 168 there over int8 pools, 128 at 8 rows, 255 at 16 and at
    head_dim 256: ``twin_min_blocks``)."""
    rp, threads = twin_rows(rows, d)
    rt = rp * 64 // threads
    regs = (255 if d > 128 or rt > 8 else
            64 if rt == 4 and threads > 64 else
            168 if int8 and threads == 64 else 128)
    return min(SM90_SM_SMEM // (sm90_smem(d, rows, per, keep, stages, int8)
                                + 1024), 2048 // threads, 32,
               max(1, 65536 // (regs * threads)))


@functools.lru_cache(maxsize=None)
def paged_plan_sm90(b: int, hkv: int, window: int, rows: int, d: int,
                    int8: bool):
    """(nsplit, 64-row tiles per split, keep, ring slots) of the
    twin-order kernel over pools of ``window`` rows per slot, ``rows`` =
    G * S query rows: the splits of ``n_splits_sm90`` at
    ``TWIN_TARGET_BLOCKS``; the scores stay in shared memory (``keep``)
    when they fit beside a ring of two tiles, else phase C reads K again
    to recompute them; then one ring slot, and more, up to one per event
    of the split (K tiles, then V tiles, or K and V tiles) and
    ``SM90_MAX_RING``, only while an SM holds as many blocks as at one
    slot: the SM's other blocks hide a block's copies better than its own
    deeper ring (docqa's pools, 8 splits: one slot 0.289 ms, two 0.318,
    three 0.440 on the H100). A pure function of the shapes, cached:
    every layer of every tick asks for the same plan."""
    nsplit = n_splits_sm90(b, hkv, window, TWIN_TARGET_BLOCKS)
    per = -(-(-(-window // SM90_TILE)) // nsplit)
    keep = sm90_smem(d, rows, per, True, 2, int8) <= SM90_MAX_SMEM
    events = (2 if keep else 3) * per
    blocks = twin_blocks_per_sm(d, rows, per, keep, 1, int8)
    stages = 1
    while stages < min(events, SM90_MAX_RING) and twin_blocks_per_sm(
            d, rows, per, keep, stages + 1, int8) == blocks:
        stages += 1
    return nsplit, per, keep, stages


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
    ``entry`` (three kernels on the current stream in float32; one in
    bf16). ``page_table`` None: the pools are rolling caches (B, W, KVH,
    D), one page of W rows per slot, and the entry takes no table."""
    build.refuse_grad(name, q, *pools, *scale_pools)
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
    if not ring and rows > MAX_ROWS:
        raise ValueError(f"{name}: G*S = {rows} query rows per kv head "
                         f"exceeds {MAX_ROWS}")
    if b * -(-rows // MAX_ROWS) > 65535:
        raise ValueError(f"{name}: B x row groups exceeds 65535")
    strides = _strides(name, pools, 16 // pools[0].element_size())
    if scale_pools:
        strides += _strides(name, scale_pools, 1)
    if not (q.is_contiguous() and pos.is_contiguous()
            and (ring or page_table.is_contiguous())):
        raise ValueError(f"{name}: q, page_table, pos must be contiguous")
    out = torch.empty_like(q)
    window = n_pages * ps
    lib = build.load()
    if q.dtype == torch.bfloat16:
        return _launch_sm90(name, entry, lib, q, pools, scale_pools,
                            page_table, pos, out, strides, window)
    nsplit = (ring_plan(b, hkv, window, rows, False)[1] if ring
              else n_splits(b, hkv, window))
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


def _launch_sm90(name, entry, lib, q, pools, scale_pools, page_table, pos,
                 out, strides, window):
    """One launch of a bf16 kernel of ``csrc/decode_sm90.cuh``, writing
    only ``out``: over rings (B, W, KVH, D) the online-softmax kernel,
    over pages the twin-order one with ``paged_plan_sm90``'s plan."""
    b, s, h, d = q.shape
    _, ps, hkv, _ = pools[0].shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = [p.data_ptr() for p in (*pools, *scale_pools)]
    if page_table is None:
        _, nsplit = ring_plan(b, hkv, window, (h // hkv) * s, True)
        lib.call(entry, q.data_ptr(), *ptrs, pos.data_ptr(), out.data_ptr(),
                 b, s, h, hkv, d, window, *strides, nsplit, d ** -0.5,
                 stream)
    else:
        nsplit, _, keep, stages = paged_plan_sm90(
            b, hkv, window, (h // hkv) * s, d, bool(scale_pools))
        lib.call(entry, q.data_ptr(), *ptrs, page_table.data_ptr(),
                 pos.data_ptr(), out.data_ptr(), b, s, h, hkv, d,
                 page_table.shape[1], ps, *strides, nsplit, int(keep),
                 stages, d ** -0.5, stream)
    build.LAUNCHES[name] += 1
    return out


def decode_attention(q, k_cache, v_cache, pos):
    """Over rolling caches (B, W, KVH, D): query s of S sees
    ``min(pos - (S-1) + s, W)`` rows of its slot's ring, at any G * S
    (the engine's chunk and suffix steps run S up to max_seq over one
    linear buffer)."""
    name = "decode_attention"
    _check_shapes(name, q, k_cache, v_cache, None, pos)
    if q.device.type in build.PLAIN_DEVICES:
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
    if q.device.type in build.PLAIN_DEVICES:
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
    if q.device.type in build.PLAIN_DEVICES:
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
