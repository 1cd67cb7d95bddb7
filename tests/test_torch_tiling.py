"""The kernels' launch plans as their wrappers compute them in Python:
the int8 matmul's tile for each M and dtype and its K splits at granite's
projection shapes (wq/wo, wk/wv, w1/w3, w2), for the float32, bf16 decode
and bf16 prefill tiles; the one-pass bf16 rolling decode kernel's
context splits (one thread-block cluster per slot and kv head); the RG-LRU
scan's channel and time tiles; the SSD decode step's tiles of the
state; the sampler's slices of a row over its thread-block cluster; and
the grouped MoE product's row tiles over the experts' sorted rows."""
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import int8_matmul as im
from repro_torch.kernels import moe_grouped as mg
from repro_torch.kernels import rglru_scan as rs
from repro_torch.kernels import ssd_step as ss
from repro_torch.kernels import topk_sample as ts

GRANITE_KN = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))


def _check_splits(m, k, n, bm):
    """Splits of whole tiles that cover K exactly, none empty; returns
    (splits, K rows per split, output blocks)."""
    splits, chunk = im.k_splits(m, k, n, bm)
    blocks = -(-n // im.block_cols(bm)) * -(-m // bm)
    assert chunk % im.tile_depth(bm) == 0
    assert (splits - 1) * chunk < k <= splits * chunk
    if blocks >= im.SMS:
        assert splits == 1
    return splits, chunk, blocks


@pytest.mark.parametrize("m", [33, 64, 128, 256, 512, 1024])
def test_int8_prefill_splits_cover_k_and_fill_the_card(m):
    """Every prefill bucket: no more blocks than SMs once split."""
    bm = im.block_rows(m, torch.bfloat16)
    assert bm == im.PREFILL_ROWS
    for k, n in GRANITE_KN:
        splits, _, blocks = _check_splits(m, k, n, bm)
        if blocks < im.SMS:
            assert blocks * splits <= im.SMS
            assert splits >= min(im.SMS // blocks,
                                 k // im.tile_depth(bm) // im.MIN_TILES)


@pytest.mark.parametrize("m", [1, 8, 16, 32])
def test_int8_decode_splits_cover_k(m):
    """float32 decode batches keep the 16-row FMA tile and split K until
    about ``TARGET_BLOCKS`` are in flight, each split at least
    ``MIN_TILES`` tiles deep (bf16 decode batches: ``decode_plan``)."""
    bm = im.block_rows(m, torch.float32)
    assert bm == im.DECODE_ROWS
    for k, n in GRANITE_KN:
        splits, chunk, blocks = _check_splits(m, k, n, bm)
        if splits > 1:
            assert blocks * (splits - 1) < im.TARGET_BLOCKS
            assert chunk // im.tile_depth(bm) >= im.MIN_TILES


@pytest.mark.parametrize("m", [8, 512])
def test_float32_keeps_the_fma_tile(m):
    """float32 x runs the FMA kernel's 16-row tile at every M."""
    bm = im.block_rows(m, torch.float32)
    assert bm == im.DECODE_ROWS
    for k, n in GRANITE_KN:
        _check_splits(m, k, n, bm)


def _decode_blocks(n, bn, splits):
    return -(-n // bn) * splits


@pytest.mark.parametrize("k,n", GRANITE_KN + ((4112, 1040), (256, 384),
                                              (128, 64)))
@pytest.mark.parametrize("m", [1, 8, 16, 32])
def test_int8_bf16_decode_plan_covers_k_once(m, k, n):
    """The bf16 decode tile's splits are whole 64-row K tiles that cover
    K exactly once (trailing splits may be empty, none overlaps), a power
    of two that one thread-block cluster holds."""
    bn, splits, chunk = im.decode_plan(m, k, n)
    assert bn in (32, 64, 128)
    assert 1 <= splits <= im.MAX_CLUSTER and splits & (splits - 1) == 0
    assert chunk % im.DECODE_DEPTH == 0
    covered = [0] * k
    for z in range(splits):
        for r in range(z * chunk, min(k, (z + 1) * chunk)):
            covered[r] += 1
    assert covered == [1] * k
    assert (splits - 1) * chunk < k or splits == 1


def test_int8_bf16_decode_plan_at_granite_shapes():
    """About one block per SM at every granite projection, with the
    fewest K splits that reach it: 4096x14336 (w1/w3) 112 column tiles
    of 128 and no split; 14336x4096 (w2) and 4096x4096 (wq/wo) 64 tiles
    of 64 columns, 2 splits; 4096x1024 (wk/wv) 16 tiles, 8 splits."""
    plans = {kn: im.decode_plan(8, *kn) for kn in GRANITE_KN}
    assert plans[(4096, 14336)] == (128, 1, 4096)
    assert plans[(14336, 4096)] == (64, 2, 7168)
    assert plans[(4096, 4096)] == (64, 2, 2048)
    assert plans[(4096, 1024)] == (64, 8, 512)
    for (k, n), (bn, splits, _) in plans.items():
        blocks = _decode_blocks(n, bn, splits)
        assert im.DECODE_MIN_BLOCKS <= blocks <= im.SMS
        assert splits == 1 or _decode_blocks(n, bn, splits // 2) \
            < im.DECODE_MIN_BLOCKS


# rolling decode: (slots, kv heads, window) of recurrentgemma's local
# attention, of granite with paged=False, and small ones
RING_SHAPES = ((8, 1, 2048), (8, 8, 1024), (8, 8, 256), (4, 2, 64),
               (1, 1, 2048), (3, 8, 200), (16, 1, 2048))


@pytest.mark.parametrize("b,hkv,window", RING_SHAPES)
def test_rolling_sm90_splits_cover_every_row_once(b, hkv, window):
    """Every valid row of a slot lies in exactly one split, for slots
    holding 1 row, a tile's edge, a split's edge and the whole window."""
    nsplit = da.n_splits_sm90(b, hkv, window)
    for nmax in sorted({1, 63, 64, 65, 255, 256, 257, window - 1, window}):
        if not 1 <= nmax <= window:
            continue
        covered = [0] * nmax
        for z in range(nsplit):
            lo, hi = da.split_rows(nmax, nsplit, z)
            assert lo % da.SM90_TILE == 0 or lo == nmax
            for t in range(lo, hi):
                covered[t] += 1
        assert covered == [1] * nmax


@pytest.mark.parametrize("b,hkv,window", RING_SHAPES)
def test_rolling_sm90_splits_fit_one_cluster(b, hkv, window):
    """The splits of one (slot, kv head) are one thread-block cluster: a
    power of two up to 8, no more than one past the 64-row tiles."""
    nsplit = da.n_splits_sm90(b, hkv, window)
    assert 1 <= nsplit <= da.MAX_SPLITS_SM90
    assert nsplit & (nsplit - 1) == 0
    assert nsplit < 2 * -(-window // da.SM90_TILE)


def test_rolling_sm90_splits_at_the_served_shapes():
    """recurrentgemma's 8 slots over 1 kv head take a full cluster of 8
    splits (64 blocks: more splits, merged across clusters, measured
    slower); granite's 8 slots x 8 kv heads over rings give at least 132
    blocks."""
    assert da.n_splits_sm90(8, 1, 2048) == 8
    for window in (256, 1024):
        assert 8 * 8 * da.n_splits_sm90(8, 8, window) >= im.SMS


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("rows", [1, 4, 16, 32, 64])
@pytest.mark.parametrize("b,hkv,window", RING_SHAPES)
def test_rolling_plan_of_one_row_group_is_unchanged(b, hkv, window, rows,
                                                    bf16):
    """Up to 64 query rows (decode's S <= 16 at G 4) are one row group,
    whose splits are the pairs' own: the plan decode ran before row
    groups existed."""
    split = da.n_splits_sm90 if bf16 else da.n_splits
    assert da.ring_plan(b, hkv, window, rows, bf16) == (
        1, split(b, hkv, window))


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("s", [17, 64, 512, 1024])
def test_rolling_plan_cuts_chunk_rows_into_groups(s, bf16):
    """A chunk or a suffix at granite's width (G 4 over 8 kv heads) over
    one (1, 1024) linear buffer: G * S rows in groups of 64, the splits
    counted over (slot, group) pairs, one cluster of at most 8 in bf16;
    S 64 (a chunk) fills the card with 4 groups x 8 kv heads x 8 splits."""
    groups, nsplit = da.ring_plan(1, 8, 1024, 4 * s, bf16)
    assert groups == -(-4 * s // da.MAX_ROWS)
    assert (groups - 1) * da.MAX_ROWS < 4 * s <= groups * da.MAX_ROWS
    split = da.n_splits_sm90 if bf16 else da.n_splits
    assert nsplit == split(groups, 8, 1024)
    if bf16:
        assert 1 <= nsplit <= da.MAX_SPLITS_SM90
        assert nsplit & (nsplit - 1) == 0
    if s == 64:
        assert groups == 4 and groups * 8 * nsplit >= im.SMS


# paged decode: (slots, kv heads, pages of 16) of granite's served pools
# (chip_smoke's max_seq 1024 and 4096; the chat and docqa cells' 32 slots
# of 2560 and 4096 rows), of the GPU tests' small pools, and a long one
PAGED_SHAPES = ((8, 8, 64), (8, 8, 256), (3, 2, 5), (1, 1, 1), (2, 1, 512),
                (16, 8, 64), (32, 8, 256), (32, 8, 160))


@pytest.mark.parametrize("b,hkv,n_pages", PAGED_SHAPES)
def test_paged_sm90_splits_cover_every_row_once(b, hkv, n_pages):
    """The twin-order kernel's splits: a power of two up to 8 (one
    cluster), at most one power of two past the 64-row tiles, no more
    tiles a split than the plan sized its shared memory for, and every
    valid row of a slot in exactly one split, for slots holding 1 row, a
    page's and a tile's edge, docqa's lengths and the whole pool."""
    window = 16 * n_pages
    nsplit, per, _, _ = da.paged_plan_sm90(b, hkv, window, 4, 128, False)
    assert nsplit == da.n_splits_sm90(b, hkv, window,
                                      da.TWIN_TARGET_BLOCKS)
    assert 1 <= nsplit <= da.MAX_SPLITS_SM90 and nsplit & (nsplit - 1) == 0
    assert nsplit < 2 * -(-window // da.SM90_TILE)
    for nmax in sorted({1, 15, 16, 17, 63, 64, 65, 257, 2047, 2600,
                        window - 1, window}):
        if not 1 <= nmax <= window:
            continue
        covered = [0] * nmax
        for z in range(nsplit):
            lo, hi = da.split_rows(nmax, nsplit, z)
            assert hi - lo <= per * da.SM90_TILE
            for t in range(lo, hi):
                covered[t] += 1
        assert covered == [1] * nmax


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("rows", [1, 4, 16, 17, 32, 33, 64])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_paged_sm90_plan_fits_shared_memory(d, rows, int8):
    """Every plan fits a block's 227 KB at every head_dim and G * S up to
    64, for pools of 16 to 8192 rows per slot: the scores stay in shared
    memory when they fit beside a ring of two tiles, else they are
    recomputed; the ring has one slot, and more only while an SM holds
    as many blocks as at one slot, up to one per event of the split."""
    for b, hkv, n_pages in PAGED_SHAPES:
        for window in (16 * n_pages, 1024, 8192, 960, 2560, 4096):
            nsplit, per, keep, stages = da.paged_plan_sm90(b, hkv, window,
                                                           rows, d, int8)
            assert da.sm90_smem(d, rows, per, keep, stages,
                                int8) <= da.SM90_MAX_SMEM
            assert keep == (da.sm90_smem(d, rows, per, True, 2, int8)
                            <= da.SM90_MAX_SMEM)
            cap = min(da.SM90_MAX_RING, (2 if keep else 3) * per)
            assert 1 <= stages <= cap

            def blocks(n):
                return da.twin_blocks_per_sm(d, rows, per, keep, n, int8)
            assert blocks(stages) == blocks(1) >= 1
            if stages < cap:
                assert blocks(stages + 1) < blocks(1)


def test_paged_sm90_recomputes_only_long_wide_splits():
    """Scores too large for shared memory are recomputed from K: 512
    pages (8192 rows) at G * S 64 take that path; at G * S 4 the same
    pools keep their scores."""
    assert not da.paged_plan_sm90(2, 1, 8192, 64, 128, False)[2]
    assert not da.paged_plan_sm90(2, 1, 8192, 64, 64, True)[2]
    assert da.paged_plan_sm90(2, 1, 8192, 4, 128, False)[2]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("s", [1, 4, 8])
@pytest.mark.parametrize("b,window", [(32, 4096), (32, 2560), (8, 1024)])
def test_paged_sm90_plan_at_granite_served_shape(b, window, s, int8):
    """granite-8b served over 8 kv heads, head_dim 128, G = 4: docqa's and
    chat's 32 slots of 4096 and 2560 rows and chip_smoke's 8 of 1024.
    Enough (slot, kv head, split) blocks for two waves of eight an SM, or
    the full cluster of 8, the scores kept in shared memory; at S 1 (the
    served decode) an SM holds blocks whose rings keep at least 48 KB of K
    and V copies in flight, over bf16 pools 16 warps of them (eight
    64-thread blocks), as it does at every S over chip_smoke's short
    pools."""
    pairs, rows, d = b * 8, 4 * s, 128
    nsplit, per, keep, stages = da.paged_plan_sm90(b, 8, window, rows, d,
                                                   int8)
    assert pairs * nsplit >= min(da.TWIN_TARGET_BLOCKS,
                                 pairs * da.MAX_SPLITS_SM90)
    assert keep
    assert da.sm90_smem(d, rows, per, keep, stages, int8) \
        <= da.SM90_MAX_SMEM
    if s == 1:
        held = da.twin_blocks_per_sm(d, rows, per, keep, stages, int8)
        slot = da.SM90_TILE * (d + 4 if int8 else 2 * d)
        assert held * stages * slot >= 48 * 1024
    if not int8 and (s == 1 or b == 8):
        held = da.twin_blocks_per_sm(d, rows, per, keep, stages, int8)
        assert held * da.twin_rows(rows, d)[1] // 32 >= 16


# the RG-LRU scan: (B, S, L) of recurrentgemma's prefill (L 4096, B 1 at a
# prompt's exact length), the GPU tests' shapes and ragged ones
SCAN_SHAPES = ((1, 2560, 4096), (2, 384, 4096), (1, 1, 4096), (1, 37, 4096),
               (2, 130, 256), (3, 1, 64), (1, 45, 100), (2, 33, 4097),
               (1, 1, 1), (8, 7, 4096))


@pytest.mark.parametrize("b,s,l", SCAN_SHAPES)
def test_scan_plan_covers_every_channel_once(b, s, l):
    """The blocks of a row own disjoint 32-channel tiles that cover every
    channel of every row exactly once (the last block's tail is masked),
    and each block's time tiles cover every step once."""
    plan = rs.scan_plan(b, s, l)
    nbx, rows = plan.grid
    assert rows == b
    covered = [0] * l
    for bx in range(nbx):
        ch = plan.channels(bx)
        assert len(ch) == rs.CHANNELS
        for c in ch:
            if c < l:
                covered[c] += 1
    assert covered == [1] * l
    assert (nbx - 1) * rs.CHANNELS < l
    tiles = -(-s // rs.TIME_TILE)
    assert (tiles - 1) * rs.TIME_TILE < s <= tiles * rs.TIME_TILE
    assert plan.vec == (l % 4 == 0)
    assert rs.scan_plan(b, s, l, aligned=False).vec is False


def test_scan_tile_fits_shared_memory():
    """The kernel's tile fits one block's shared memory (227 KB): the ring
    of a and x tiles and two y tiles, 56 KB of a and x in flight a block,
    and two blocks fit an SM."""
    assert rs.SMEM == (rs.STAGES + 1) * rs.TIME_TILE * rs.CHANNELS * 8
    assert (rs.STAGES - 1) * rs.TIME_TILE * rs.CHANNELS * 8 == 57344
    assert 2 * rs.SMEM <= rs.SMEM_LIMIT


@pytest.mark.parametrize("s", [1, 384, 2500, 2560])
def test_scan_plan_fills_the_card_at_batch_one(s):
    """At B 1, L 4096 the plan puts at least 120 blocks (32 channels
    each) on the 132 SMs, where one block of 64 threads per 64 channels
    gave 64."""
    plan = rs.scan_plan(1, s, 4096)
    blocks = plan.grid[0] * plan.grid[1]
    assert 120 <= blocks <= rs.SMS


# (b, H, P, N): mamba2's widths at 1, 8 and 64 slots, its reduced()
# widths, a P of two row blocks, and ragged P and small N
SSD_SHAPES = [(1, 64, 64, 128), (8, 64, 64, 128), (64, 64, 64, 128),
              (3, 32, 16, 16), (2, 4, 128, 128), (2, 3, 24, 8),
              (1, 2, 5, 4), (1, 2, 100, 64)]


@pytest.mark.parametrize("b,h,p,n", SSD_SHAPES)
def test_ssd_step_plan_covers_the_state_once(b, h, p, n):
    """A (b, h) tile's row blocks and their threads own every 16-byte
    chunk of the state exactly once, within the kernel's limits; a
    thread keeps one column chunk in all its rows, and each row's N / 4
    chunks sit in adjacent lanes of one warp, aligned, so the shuffle
    tree over them sums that row alone."""
    plan = ss.step_plan(b, h, p, n)
    g = n // 4
    assert plan.grid == (b * h, -(-p // plan.rows))
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= ss.THREADS
    assert plan.per in ss.PER and plan.rows * g <= plan.threads * plan.per
    covered = [[0] * g for _ in range(p)]
    for by in range(plan.grid[1]):
        for t in range(plan.threads):
            for row, col in plan.chunks(by, t, p, n):
                assert col == t % g
                covered[row][col] += 1
            for i in range(plan.per):
                idx = t + i * plan.threads
                for o in range(1, g):  # the lanes the tree sums with t
                    u = t ^ o
                    assert u // 32 == t // 32
                    assert (u + i * plan.threads) // g == idx // g
    assert covered == [[1] * g for _ in range(p)]


def test_ssd_step_plan_at_mamba2_width():
    """mamba2-1.3b at the cell's 64 slots: one block of 256 threads per
    (slot, head) tile of 32 KiB, 8 chunks a thread: 4096 blocks."""
    plan = ss.step_plan(64, 64, 64, 128)
    assert plan == ss.StepPlan(rows=64, threads=256, per=8, grid=(4096, 1))
    assert plan.rows * 128 * 4 == 32768


@pytest.mark.parametrize("n", [2, 6, 12, 256])
def test_ssd_step_plan_refuses_rows_a_warp_cannot_hold(n):
    with pytest.raises(ValueError, match="power of two"):
        ss.step_plan(1, 2, 64, n)


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("v", [1, 7, 300, 1000, 4096, 49152, 256000])
def test_sample_plan_slices_cover_the_row_once(v, cluster):
    """The cluster's blocks hold disjoint 16-byte-aligned slices of the
    row that cover it once (a short or empty last slice included)."""
    plan = ts._slices(v, cluster)
    assert plan.cluster == cluster and plan.chunk % 4 == 0
    covered = [0] * v
    for r in range(cluster):
        base = min(r * plan.chunk, v)
        for i in range(base, min(base + plan.chunk, v)):
            covered[i] += 1
    assert covered == [1] * v
    assert plan.chunk < -(-v // cluster) + 4


@pytest.mark.parametrize("cluster", [8, 16])
def test_sample_plan_fits_shared_memory_at_max_vocab(cluster):
    """A block's slice and the kernel's own shared memory fit in 227 KB
    at ``max_vocab``, which holds recurrentgemma's 256000, and one more
    logit does not fit; the weights are kept beside the slice only where
    both fit; the candidate cap is one value a thread of one block."""
    top = ts.max_vocab(cluster)
    assert top >= 256000
    assert ts._slices(top, cluster).smem <= ts.SMEM_LIMIT
    assert not ts._slices(top, cluster).store_w
    assert ts._slices(top + 1, cluster).smem > ts.SMEM_LIMIT
    for v in (1000, 49152, 256000):
        plan = ts._slices(v, cluster)
        assert plan.smem <= ts.SMEM_LIMIT
        assert plan.store_w == (8 * plan.chunk + ts.STATIC_SMEM
                                <= ts.SMEM_LIMIT)
    assert 1 <= ts.CAP <= ts.THREADS
    # rank 0 holds the candidates' value, index, weight and image
    assert 16 * ts.CAP < ts.STATIC_SMEM


@pytest.mark.parametrize("b,v,cluster,store_w", [
    (8, 49152, 8, True), (1, 49152, 8, True), (9, 49152, 8, True),
    (8, 1000, 8, True), (8, 216064, 8, True), (8, 216068, 16, True),
    (8, 256000, 16, True), (1, 256000, 16, True), (16, 256000, 8, False),
    (32, 500000, 16, False)])
def test_sample_plan_at_the_served_shapes(b, v, cluster, store_w):
    """8 blocks a row wherever they keep the weights beside the logits
    (granite's 49152, up to 216064); past that, up to 8 rows take 16
    blocks, which keep recurrentgemma's 256000 weights, and more rows take
    8 without them; a vocabulary 8 blocks cannot hold takes 16 at any
    batch. ``max_vocab()`` is the largest any plan holds."""
    plan = ts.sample_plan(b, v)
    assert (plan.cluster, plan.store_w) == (cluster, store_w)
    assert ts.max_vocab() == ts.max_vocab(16) >= v


def _expert_tiles(counts, bm, tiles):
    """Each launched row tile's (expert, first row, end row) or None, as
    ``csrc/moe_grouped.cu``'s blocks find them: the experts' tiles
    numbered expert by expert, ceil(count / bm) each."""
    out, starts = [], [sum(counts[:i]) for i in range(len(counts))]
    for tile in range(tiles):
        found, t0 = None, 0
        for e, n in enumerate(counts):
            cnt = -(-n // bm)
            if t0 <= tile < t0 + cnt:
                r0 = starts[e] + (tile - t0) * bm
                found = (e, r0, min(starts[e] + n, r0 + bm))
            t0 += cnt
        out.append(found)
    return out


@pytest.mark.parametrize("routing", ["uniform", "one", "ragged"])
@pytest.mark.parametrize("t,k,e", [(1, 10, 72), (37, 10, 72), (512, 10, 72),
                                   (1544, 10, 72), (300, 2, 8), (97, 1, 128)])
def test_grouped_tiles_cover_every_sorted_row_once(t, k, e, routing):
    """Whatever the counts, the row tiles planned from (R, E) alone hold
    every expert's tiles: each sorted row lies in exactly one tile, a tile
    holds rows of one expert only and at most ``bm``."""
    r = t * k
    g = torch.Generator().manual_seed(t + e)
    if routing == "uniform":
        counts = torch.bincount(torch.randint(0, e, (r,), generator=g),
                                minlength=e).tolist()
    elif routing == "one":
        counts = [r] + [0] * (e - 1)
    else:  # every count one past a tile or empty
        counts = [0] * e
        for i in range(0, e, 3):
            counts[i] = 65
        counts[-1] += r - sum(counts)
        if counts[-1] < 0:
            counts = [r] + [0] * (e - 1)
    bm, tiles = mg.grouped_plan(r, e)
    assert bm == (64 if r / e < 96 else 128)
    assert sum(-(-n // bm) for n in counts) <= tiles
    seen = [0] * r
    starts = [sum(counts[:i]) for i in range(e)]
    for found in _expert_tiles(counts, bm, tiles):
        if found is None:
            continue
        ex, r0, r1 = found
        assert 0 < r1 - r0 <= bm
        assert starts[ex] <= r0 and r1 <= starts[ex] + counts[ex]
        for row in range(r0, r1):
            seen[row] += 1
    assert seen == [1] * r


def test_grouped_tile_rows_at_the_served_shapes():
    """granite-4.0-h (E 72, top 10): 512 tokens average 71 rows an expert
    and take tiles of 64; 1544 and 3072 average 214 and 427 and take 128."""
    assert mg.grouped_plan(5120, 72) == (64, 150)
    assert mg.grouped_plan(15440, 72) == (128, 192)
    assert mg.grouped_plan(30720, 72) == (128, 311)
