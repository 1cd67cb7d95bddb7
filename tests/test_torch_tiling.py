"""The int8 matmul's launch tiling as its wrapper computes it in Python:
the tile each M and dtype takes, and the K splits at granite's projection
shapes (wq/wo, wk/wv, w1/w3, w2), for the decode and the prefill tiles."""
import pytest
import torch

from repro_torch.kernels import int8_matmul as im

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
    """Decode batches keep the 16-row tile and split K until about
    ``TARGET_BLOCKS`` are in flight, each split at least ``MIN_TILES``
    tiles deep."""
    bm = im.block_rows(m, torch.bfloat16)
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
