"""The port's hand-written CUDA kernels on a card, against their plain
PyTorch versions at small shapes, and the wrappers' refusals. Every test
here needs a CUDA device and the CUDA toolkit (``nvcc``): marked ``gpu``,
they skip without a card. On the machine with the card:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: the JAX suite's ``tests/conftest.py`` imports jax, which
that machine does not have.)

Tolerances: float32 2e-5 (the reference suite's); bfloat16 2e-2, and 1e-3
absolute for the int8 paged decode kernel; the RG-LRU scan bit for bit
(it rounds as its plain version does, in the same order); sampled tokens
exact, and a repeat call bit-identical."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ops, plain
from repro_torch.kernels.topk_sample import max_vocab
from repro_torch.models import layers as L
from repro_torch.models.blocks import quantize_kv

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the int8 paged decode kernel against its plain version: bfloat16 at 1e-3
# absolute (no relative term), which a kernel that skips rounding each
# dequantized element to q's dtype does not meet (chip_smoke.py)
INT8_DECODE_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-3, 0.0)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    build.load()
    return torch.device("cuda")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _rand(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [16, 40, 160])
def test_flash_attention_kernel_matches_plain(dev, s, dtype):
    gen = torch.Generator(device=dev).manual_seed(s)
    q = _rand(gen, (2, s, 8, 64), dtype, dev)
    k = _rand(gen, (2, s, 2, 64), dtype, dev)
    v = _rand(gen, (2, s, 2, 64), dtype, dev)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=True)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = L.dense_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 4, 8])
def test_paged_decode_kernel_matches_plain(dev, s, dtype):
    gen = torch.Generator(device=dev).manual_seed(s)
    b, ps, n_pages, kvh, h, d = 3, 16, 5, 2, 8, 64
    pool = b * n_pages + 1
    kp = _rand(gen, (pool, ps, kvh, d), dtype, dev)
    vp = _rand(gen, (pool, ps, kvh, d), dtype, dev)
    table = (torch.randperm(pool - 1, generator=gen, device=dev)[
        :b * n_pages] + 1).reshape(b, n_pages).to(torch.int32)
    table[2] = 0  # a released slot on trash page 0
    pos = torch.tensor([max(s, 21), ps * n_pages, s], dtype=torch.int32,
                       device=dev)
    q = _rand(gen, (b, s, h, d), dtype, dev)
    got = ops.paged_decode_attention(q, kp, vp, table, pos)
    want = L.paged_decode_attention(q, kp, vp, table, pos)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("gran", ["page", "token"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 4])
def test_int8_paged_decode_kernel_matches_plain(dev, s, dtype, gran):
    gen = torch.Generator(device=dev).manual_seed(10 + s)
    b, ps, n_pages, kvh, h, d = 3, 16, 5, 2, 8, 64
    pool = b * n_pages + 1
    pools = []
    for _ in range(2):
        raw = _rand(gen, (pool * ps, kvh, d), torch.float32, dev)
        q8, sc = quantize_kv(raw, group=ps if gran == "page" else 0)
        pools += [q8.reshape(pool, ps, kvh, d), sc.reshape(pool, ps, kvh, 1)]
    k8, ks, v8, vs = pools
    table = (torch.randperm(pool - 1, generator=gen, device=dev)[
        :b * n_pages] + 1).reshape(b, n_pages).to(torch.int32)
    table[2] = 0  # a released slot on trash page 0
    pos = torch.tensor([max(s, 21), ps * n_pages, s], dtype=torch.int32,
                       device=dev)
    q = _rand(gen, (b, s, h, d), dtype, dev)
    before = ops.LAUNCHES["paged_decode_attention_int8"]
    got = ops.paged_decode_attention_int8(q, k8, v8, ks, vs, table, pos)
    assert ops.LAUNCHES["paged_decode_attention_int8"] == before + 1
    want = L.paged_decode_attention_int8(q, k8, v8, ks, vs, table, pos)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    atol, rtol = INT8_DECODE_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def _paged_kinds(gen, kind, pool, ps, kvh, d, dev):
    """bf16 pools, or int8 pools with page or token scales, and the
    name of the kernel (its launch counter and wrapper)."""
    if kind == "bf16":
        return "paged_decode_attention", tuple(
            _rand(gen, (pool, ps, kvh, d), torch.bfloat16, dev)
            for _ in range(2))
    pools = []
    for _ in range(2):
        raw = _rand(gen, (pool * ps, kvh, d), torch.float32, dev)
        q8, sc = quantize_kv(raw, group=ps if kind == "int8 page" else 0)
        pools += [q8.reshape(pool, ps, kvh, d), sc.reshape(pool, ps, kvh, 1)]
    return "paged_decode_attention_int8", (pools[0], pools[2], pools[1],
                                           pools[3])


def _twin_order_call(dev, kind, s, b, n_pages, kvh, h, d, pos_list,
                     released, seed):
    """One bf16 call of the twin-order kernel: one launch, a second call
    bit for bit the same, within the standing tolerance of the twin (2e-2
    for bf16 pools; int8 1e-3 absolute, no relative term)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    ps = 16
    pool = b * n_pages + 1
    name, pools = _paged_kinds(gen, kind, pool, ps, kvh, d, dev)
    table = (torch.randperm(pool - 1, generator=gen, device=dev)[
        :b * n_pages] + 1).reshape(b, n_pages).to(torch.int32)
    for i in released:
        table[i] = 0  # a released slot on trash page 0
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    q = _rand(gen, (b, s, h, d), torch.bfloat16, dev)
    fn = getattr(ops, name)
    before = ops.LAUNCHES[name]
    got = fn(q, *pools, table, pos)
    assert ops.LAUNCHES[name] == before + 1
    again = fn(q, *pools, table, pos)
    assert ops.LAUNCHES[name] == before + 2
    want = getattr(L, name)(q, *pools, table, pos)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, again)
    atol, rtol = ((TOL[torch.bfloat16],) * 2 if kind == "bf16"
                  else INT8_DECODE_TOL[torch.bfloat16])
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("kind", ["bf16", "int8 page", "int8 token"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("s", [1, 4, 8])
def test_bf16_paged_decode_twin_order_matches_plain(dev, s, d, kind):
    """The one-launch twin-order kernel over bf16 and int8 pools (4 slots
    of 8 pages, G = 4 over 2 kv heads: 2 splits of 64 rows, one
    cluster): a slot of S rows, one ending inside a page, a full one and
    a released one."""
    from repro_torch.kernels.decode_attention import paged_plan_sm90

    b, n_pages, kvh, h = 4, 8, 2, 8
    assert paged_plan_sm90(b, kvh, 16 * n_pages, 4 * s, d,
                           kind != "bf16")[:3] == (2, 1, True)
    _twin_order_call(dev, kind, s, b, n_pages, kvh, h, d,
                     [s, max(s, 21), 16 * n_pages, s], released=(3,),
                     seed=s * 100 + d)


@pytest.mark.parametrize("kind", ["bf16", "int8 page", "int8 token"])
@pytest.mark.parametrize("d", [64, 128])
def test_bf16_paged_decode_recomputes_long_wide_splits(dev, d, kind):
    """512 pages (8192 rows) a slot at G * S = 64: the scores do not fit
    in shared memory and phase C computes them again from K; a full
    slot, a slot ending inside a page past the middle, a released one."""
    from repro_torch.kernels.decode_attention import paged_plan_sm90

    b, n_pages, kvh, h, s = 3, 512, 1, 16, 4
    nsplit, _, keep, _ = paged_plan_sm90(b, kvh, 16 * n_pages, 16 * s, d,
                                         kind != "bf16")
    assert (nsplit, keep) == (8, False)
    _twin_order_call(dev, kind, s, b, n_pages, kvh, h, d,
                     [16 * n_pages, 4103, s], released=(2,), seed=d)


def test_paged_sm90_smem_matches_the_kernel(dev):
    """The Python plan's shared-memory bytes are the kernel's own."""
    from repro_torch.kernels import decode_attention as da

    lib = build.load()
    for b, hkv, window in ((8, 8, 1024), (3, 2, 80), (2, 1, 8192),
                           (4, 2, 432)):
        for rows in (1, 4, 16, 32, 64):
            for d in (32, 64, 128, 256):
                for int8 in (False, True):
                    nsplit, per, keep, stages = da.paged_plan_sm90(
                        b, hkv, window, rows, d, int8)
                    assert lib.value(
                        "paged_decode_sm90_smem", d, rows, window, nsplit,
                        int(keep), stages, int(int8)) == \
                        da.sm90_smem(d, rows, per, keep, stages, int8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1, 256, 384), (8, 256, 64),
                                   (37, 512, 384), (100, 128, 256),
                                   (8, 4096, 1024)])
def test_int8_matmul_kernel_matches_plain(dev, m, k, n, dtype):
    """Ragged M (masked in the kernel), N not a multiple of the 128-wide
    block, and a decode shape that splits K across blocks."""
    gen = torch.Generator(device=dev).manual_seed(m + n)
    x = _rand(gen, (m, k), dtype, dev)
    w_q, scale = ops.quantize_int8(_rand(gen, (k, n), torch.float32, dev))
    # the prefill tile (bf16, M > 32) counts its launches apart
    key = ("int8_matmul_prefill" if dtype == torch.bfloat16 and m > 32
           else "int8_matmul")
    before = dict(ops.LAUNCHES)
    got = ops.int8_matmul(x, w_q, scale)
    assert ops.LAUNCHES == dict(before, **{key: before[key] + 1})
    want = L.int8_matmul(x, w_q, scale)
    torch.cuda.synchronize()
    assert got.dtype == dtype and tuple(got.shape) == (m, n)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,h,kvh,d,window", [(40, 8, 2, 64, 16),
                                              (200, 16, 1, 256, 64),
                                              (70, 4, 1, 256, 0)])
def test_windowed_and_head_dim_256_prefill_matches_plain(dev, s, h, kvh, d,
                                                         window, dtype):
    """Local attention (keys t > s - window) skips the tiles behind the
    band; head_dim 256 is recurrentgemma's."""
    gen = torch.Generator(device=dev).manual_seed(s + d)
    q = _rand(gen, (1, s, h, d), dtype, dev)
    k = _rand(gen, (1, s, kvh, d), dtype, dev)
    v = _rand(gen, (1, s, kvh, d), dtype, dev)
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    want = L.dense_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("s", [1, 15, 63, 64, 65, 200, 1000])
def test_bf16_prefill_on_tensor_cores_matches_plain(dev, s, d, causal):
    """The one-pass tensor-core kernel at S below, at and past one
    64-row tile, each head_dim, groups of 1, 4 and 16 q heads per kv head
    (q head h reads kv head h // G), causal or not, batch 2."""
    for g, kvh in ((1, 4), (4, 2), (16, 1)):
        gen = torch.Generator(device=dev).manual_seed(s * d + g)
        q = _rand(gen, (2, s, g * kvh, d), torch.bfloat16, dev)
        k = _rand(gen, (2, s, kvh, d), torch.bfloat16, dev)
        v = _rand(gen, (2, s, kvh, d), torch.bfloat16, dev)
        before = ops.LAUNCHES["flash_attention"]
        got = ops.flash_attention(q, k, v, causal=causal)
        assert ops.LAUNCHES["flash_attention"] == before + 1
        want = L.dense_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("s", [65, 200, 1000])
@pytest.mark.parametrize("window", [16, 64, 100])
def test_bf16_windowed_prefill_matches_plain(dev, window, s, d, causal):
    """Local windows narrower than, equal to and not a multiple of the
    64-key tile: tiles wholly behind the band are skipped, the band's
    edge tiles masked."""
    gen = torch.Generator(device=dev).manual_seed(window + s + d)
    q = _rand(gen, (2, s, 8, d), torch.bfloat16, dev)
    k = _rand(gen, (2, s, 2, d), torch.bfloat16, dev)
    v = _rand(gen, (2, s, 2, d), torch.bfloat16, dev)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = L.dense_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("k", [128, 512, 14336])
@pytest.mark.parametrize("n", [64, 384, 4096])
@pytest.mark.parametrize("m", [33, 64, 65, 128, 200, 512, 1024])
def test_int8_matmul_prefill_tiles_match_plain(dev, m, n, k):
    """The pipelined 128 x 128 bf16 tile (every M > 32): ragged M, N
    narrower than a tile and not a multiple of it, K from one 64-deep
    step to granite's 14336, split across blocks where tiles are few."""
    from repro_torch.kernels.int8_matmul import PREFILL_ROWS, block_rows

    assert block_rows(m, torch.bfloat16) == PREFILL_ROWS
    gen = torch.Generator(device=dev).manual_seed(m + n + k)
    x = _rand(gen, (m, k), torch.bfloat16, dev)
    w_q, scale = ops.quantize_int8(_rand(gen, (k, n), torch.float32, dev))
    before = dict(ops.LAUNCHES)
    got = ops.int8_matmul(x, w_q, scale)
    assert ops.LAUNCHES == dict(
        before, int8_matmul_prefill=before["int8_matmul_prefill"] + 1)
    want = L.int8_matmul(x, w_q, scale)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (m, n)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("h,kvh,d", [(16, 1, 256), (8, 2, 64)])
def test_rolling_decode_kernel_matches_plain(dev, s, h, kvh, d, dtype):
    """Rings partly filled, full, and wrapped (pos past W)."""
    gen = torch.Generator(device=dev).manual_seed(20 + s + d)
    b, w = 4, 64
    k = _rand(gen, (b, w, kvh, d), dtype, dev)
    v = _rand(gen, (b, w, kvh, d), dtype, dev)
    pos = torch.tensor([s, 37, w, w + 29], dtype=torch.int32, device=dev)
    q = _rand(gen, (b, s, h, d), dtype, dev)
    before = ops.LAUNCHES["decode_attention"]
    got = ops.decode_attention(q, k, v, pos)
    assert ops.LAUNCHES["decode_attention"] == before + 1
    want = L.decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("window", [64, 2048])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("g", [1, 8, 16])
@pytest.mark.parametrize("s", [1, 2, 4])
def test_bf16_rolling_decode_one_pass_matches_plain(dev, s, g, d, window):
    """The one-pass tensor-core kernel over bf16 rings: 8 slots whose
    positions straddle a 64-row tile's edge, a split's edge (4 tiles a
    split at W 2048), the window, and a wrapped ring (pos past W, pos % W
    != 0); G = 1 over 4 kv heads, G = 8 and 16 over one (8 splits, one
    cluster, at W 2048; one split at W 64). Two calls give bit-identical
    outputs."""
    from repro_torch.kernels.decode_attention import n_splits_sm90

    kvh = 4 if g == 1 else 1
    b = 8
    gen = torch.Generator(device=dev).manual_seed(s * 1000 + g * d + window)
    k = _rand(gen, (b, window, kvh, d), torch.bfloat16, dev)
    v = _rand(gen, (b, window, kvh, d), torch.bfloat16, dev)
    ctx = [1, 63, 64, 65, 257, window - 1, window, window + 777]
    pos = torch.tensor([max(c, s) for c in ctx], dtype=torch.int32,
                       device=dev)
    q = _rand(gen, (b, s, g * kvh, d), torch.bfloat16, dev)
    assert n_splits_sm90(b, kvh, window) == (1 if window == 64 else 8)
    before = ops.LAUNCHES["decode_attention"]
    got = ops.decode_attention(q, k, v, pos)
    again = ops.decode_attention(q, k, v, pos)
    assert ops.LAUNCHES["decode_attention"] == before + 2
    want = L.decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def _ring_units(got, want, q, k, v, pos):
    """max |got - want| in units of 2^-8 x the decode attention of |v|."""
    scale = plain.decode_attention(q.float(), k.float(), v.float().abs(),
                                   pos)
    return ((got.float() - want.float()).abs() / scale).max().item() \
        / 2.0 ** -8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [16, 17, 64, 512])
def test_rolling_decode_row_groups_match_plain(dev, s, dtype):
    """Past 64 query rows, at granite's width (G 4 over 8 kv heads, D 128)
    over two (1024-row) linear buffers: S queries ending at each slot's
    pos, as a chunk or a suffix of prefill leaves them (S 16: one group;
    17: two, the second of 4 rows; 64, a chunk: 4; 512, a suffix: 32).
    bf16 within 4 units of 2^-8 sum p|v| and a repeat call bit-identical;
    float32 within 2e-5."""
    gen = torch.Generator(device=dev).manual_seed(7000 + s)
    b, w, kvh, h, d = 2, 1024, 8, 32, 128
    k = _rand(gen, (b, w, kvh, d), dtype, dev)
    v = _rand(gen, (b, w, kvh, d), dtype, dev)
    pos = torch.tensor([s, min(w, s + 300)], dtype=torch.int32, device=dev)
    q = _rand(gen, (b, s, h, d), dtype, dev)
    before = ops.LAUNCHES["decode_attention"]
    got = ops.decode_attention(q, k, v, pos)
    again = ops.decode_attention(q, k, v, pos)
    assert ops.LAUNCHES["decode_attention"] == before + 2
    want = plain.decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, again)
    if dtype == torch.bfloat16:
        assert _ring_units(got, want, q, k, v, pos) <= 4.0
    else:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_a_row_group_computes_as_a_call_of_its_rows(dev):
    """bf16, G 1 over 8 kv heads, 8 rings of 256 (4 splits for 8 and for
    16 (slot, group) pairs): the second row group of a call of S 128 gives
    the bits of a call of its 64 queries alone at the same pos (query s of
    S sees pos - (S-1) + s rows either way); and at S 4, G 4 (decode's
    shape, one group) the plan is the pairs' own."""
    from repro_torch.kernels.decode_attention import n_splits_sm90, ring_plan

    gen = torch.Generator(device=dev).manual_seed(71)
    b, w, kvh, d = 8, 256, 8, 128
    assert ring_plan(b, kvh, w, 128, True)[1] == n_splits_sm90(b, kvh, w)
    assert ring_plan(b, kvh, w, 16, True) == (1, n_splits_sm90(b, kvh, w))
    k = _rand(gen, (b, w, kvh, d), torch.bfloat16, dev)
    v = _rand(gen, (b, w, kvh, d), torch.bfloat16, dev)
    pos = torch.tensor([128, 130, 150, 190, 200, 255, 256, 256],
                       dtype=torch.int32, device=dev)
    q = _rand(gen, (b, 128, kvh, d), torch.bfloat16, dev)
    whole = ops.decode_attention(q, k, v, pos)
    part = ops.decode_attention(q[:, 64:].contiguous(), k, v, pos)
    torch.cuda.synchronize()
    assert torch.equal(whole[:, 64:], part)


@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 1024), (4096, 14336),
                                 (14336, 4096), (4112, 1040)])
@pytest.mark.parametrize("m", [1, 8, 16, 32])
def test_int8_matmul_decode_tile_matches_plain(dev, m, k, n):
    """The bf16 decode tile (M <= 32) at granite's projection shapes and
    at a K that is not a multiple of the 64-row stage (and an N that is
    not one of 32 columns): one launch, and a second call gives the same
    output."""
    gen = torch.Generator(device=dev).manual_seed(m * 7 + k + n)
    x = _rand(gen, (m, k), torch.bfloat16, dev)
    w_q, scale = ops.quantize_int8(_rand(gen, (k, n), torch.float32, dev))
    before = dict(ops.LAUNCHES)
    got = ops.int8_matmul(x, w_q, scale)
    assert ops.LAUNCHES == dict(before,
                                int8_matmul=before["int8_matmul"] + 1)
    again = ops.int8_matmul(x, w_q, scale)
    want = L.int8_matmul(x, w_q, scale)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (m, n)
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("b,s,l", [(1, 37, 4096), (2, 130, 256),
                                   (3, 1, 64), (1, 2560, 4096),
                                   (2, 384, 4096), (1, 45, 100),
                                   (2, 33, 4097), (1, 1, 1)])
def test_rglru_scan_kernel_matches_plain(dev, b, s, l):
    """Bit for bit: S past, on and off the time tile (32), S 1, L not a
    multiple of the 32-channel tile (100) or of 4 (4097: 4-byte copies);
    a repeat call gives the same bits."""
    gen = torch.Generator(device=dev).manual_seed(s)
    a = torch.rand((b, s, l), generator=gen, device=dev) * 0.2 + 0.8
    x = torch.randn((b, s, l), generator=gen, device=dev)
    h0 = torch.randn((b, l), generator=gen, device=dev)
    before = ops.LAUNCHES["rglru_scan"]
    y, h = ops.rglru_scan(a, x, h0)
    assert ops.LAUNCHES["rglru_scan"] == before + 1
    y_want, h_want = plain.rglru_scan(a, x, h0)
    torch.cuda.synchronize()
    assert torch.equal(y, y_want) and torch.equal(h, h_want)
    y2, h2 = ops.rglru_scan(a, x, h0)
    assert torch.equal(y2, y) and torch.equal(h2, h)


@pytest.mark.parametrize("b,s,l", [(2, 77, 320), (1, 40, 4096),
                                   (3, 5, 64)])
def test_rglru_scan_unaligned_views_match_plain(dev, b, s, l):
    """The 4-byte copies of an unaligned view (a and x start 4 bytes into
    their storage), bit for bit."""
    from repro_torch.kernels.rglru_scan import scan_plan

    gen = torch.Generator(device=dev).manual_seed(b * s + l)
    a = torch.rand((b, s, l), generator=gen, device=dev) * 0.2 + 0.8
    x = torch.randn((b, s, l), generator=gen, device=dev)
    h0 = torch.randn((b, l), generator=gen, device=dev)
    want = plain.rglru_scan(a, x, h0)
    a1 = torch.empty(a.numel() + 1, device=dev)[1:].view(b, s, l)
    x1 = torch.empty(x.numel() + 1, device=dev)[1:].view(b, s, l)
    a1.copy_(a)
    x1.copy_(x)
    assert scan_plan(b, s, l, aligned=False).vec is False
    got = ops.rglru_scan(a1, x1, h0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("v", [256000, 1000])
def test_sampler_kernels_at_a_cluster_wide_vocab(dev, v):
    """A row spread over a cluster of 8 blocks: recurrentgemma's 256000
    and a vocabulary whose last block's slice is short."""
    gen = torch.Generator(device=dev).manual_seed(v)
    b = 8
    logits = torch.randn((b, v), generator=gen, device=dev) * 4
    logits[0, v - 3] = logits[0, 2] = logits[0].max() + 1.0  # tie
    logits[3, v - 1] = logits[3].max() + 2.0  # the last index wins
    greedy = torch.tensor([1, 0, 0, 1, 0, 0, 0, 1], dtype=torch.bool,
                          device=dev)
    temp = torch.tensor([1.0, 0.7, 1.3, 1.0, 0.9, 1.0, 0.5, 1.0],
                        device=dev)
    top_k = torch.tensor([0, 50, 0, 0, 200, 0, 1, 0], dtype=torch.int32,
                         device=dev)
    top_p = torch.tensor([1.0, 1.0, 0.9, 1.0, 0.95, 1.0, 1.0, 1.0],
                         device=dev)
    for _ in range(8):
        u = torch.rand((b,), generator=gen, device=dev)
        got = ops.sample_tokens(logits, greedy, temp, top_k, top_p, u)
        want = L.sample_tokens(logits, greedy, temp, top_k, top_p, u)
        assert torch.equal(got, want)
        assert int(got[0]) == 2 and int(got[3]) == v - 1
    k = torch.randint(1, v + 1, (b,), generator=gen, device=dev,
                      dtype=torch.int32)
    uu = torch.rand((b, v), generator=gen, device=dev)
    assert torch.equal(ops.topk_sample(logits, k, temp, uu),
                       L.topk_sample(logits, k, temp, uu))


def test_sampler_kernels_match_plain_exactly(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    b, v = 6, 4096
    logits = torch.randn((b, v), generator=gen, device=dev) * 3
    logits[0, 5] = logits[0, 9] = logits[0].max() + 1.0
    greedy = torch.tensor([1, 0, 0, 0, 1, 0], dtype=torch.bool, device=dev)
    temp = torch.tensor([1.0, 0.8, 1.2, 0.5, 1.0, 1.0], device=dev)
    top_k = torch.tensor([0, 10, 0, 40, 0, 1], dtype=torch.int32,
                         device=dev)
    top_p = torch.tensor([1.0, 1.0, 0.8, 0.9, 1.0, 1.0], device=dev)
    for _ in range(8):
        u = torch.rand((b,), generator=gen, device=dev)
        got = ops.sample_tokens(logits, greedy, temp, top_k, top_p, u)
        want = L.sample_tokens(logits, greedy, temp, top_k, top_p, u)
        assert torch.equal(got, want)
        assert int(got[0]) == 5
    k = torch.randint(1, v + 1, (b,), generator=gen, device=dev,
                      dtype=torch.int32)
    uu = torch.rand((b, v), generator=gen, device=dev)
    assert torch.equal(ops.topk_sample(logits, k, temp, uu),
                       L.topk_sample(logits, k, temp, uu))


def _from_image(u):
    """float32 values whose order-isomorphic uint32 images are ``u``."""
    u = np.asarray(u, dtype=np.uint64)
    bits = np.where(u >= 2 ** 31, u - 2 ** 31, ~u & 0xFFFFFFFF)
    return bits.astype(np.uint32).view(np.float32)


def _sampler_case(case, v):
    """(logits, greedy, temperature, top_k, top_p) of 8 rows as numpy
    arrays, and the rows each path of the kernel should serve."""
    from repro_torch.kernels.topk_sample import CAP

    rng = np.random.default_rng(v + len(case))
    b = 8
    x = rng.standard_normal((b, v)).astype(np.float32)
    greedy = np.zeros(b, bool)
    temp = np.ones(b, np.float32)
    k = np.zeros(b, np.int32)
    p = np.ones(b, np.float32)
    if case == "digit ties":
        # 3 values at image hi and 4 at hi - 1, above every normal draw;
        # hi - 1 differs from hi in the digit holding bit s and every
        # digit below it; k 5 cuts inside the group of 4, p 0.5 / 0.4 put
        # the nucleus boundary on it / on the group of 3
        shifts = (0, 8, 16, 24, 8, 24, 16, 0)
        k[:] = (5, 5, 5, 5, 0, 0, CAP + 2, 0)
        p[:] = (1.0, 0.5, 0.4, 0.5, 0.5, 0.4, 0.5, 1.0)
        greedy[7] = True
        for r, s in enumerate(shifts):
            hi = 0xC2000000 if s == 24 else 0xC1000000 + (1 << s)
            at = rng.choice(v, 7, replace=False)
            x[r, at] = _from_image([hi] * 3 + [hi - 1] * 4)
        paths = dict(greedy=1, candidates=4, mass_radix=3, whole_row=0)
    elif case == "top_k over V":
        k[:] = (v, v + 7, 2 ** 31 - 1, v, v + 1, v, 0, 1)
        p[:] = (1.0, 1.0, 1.0, 0.9, 0.8, 0.3, 1.0, 1.0)
        big = v > CAP
        paths = dict(greedy=0, candidates=1 if big else 8,
                     mass_radix=3 if big else 0, whole_row=4 if big else 0)
    elif case == "equal logits":
        x[:] = 0.25
        greedy[0] = True
        k[:] = (0, 0, 0, 10, 10, 1, 0, v)
        p[:] = (1.0, 1.0, 0.9, 1.0, 0.9, 0.5, 0.999, 0.5)
        big = v > CAP
        paths = dict(greedy=1, candidates=0 if big else 7,
                     mass_radix=5 if big else 0, whole_row=2 if big else 0)
    elif case == "-inf entries":
        x[rng.random((b, v)) < 0.3] = -np.inf
        x[5, :] = -np.inf
        x[5, v // 2] = 1.5  # one finite value
        greedy[0] = True
        k[:] = (0, 0, 0, 50, v, v - 10, 0, 3)
        p[:] = (1.0, 1.0, 0.9, 0.95, 1.0, 0.8, 0.9, 0.6)
        big = v > CAP
        paths = dict(greedy=1, candidates=2 if big else 7,
                     mass_radix=3 if big else 0, whole_row=2 if big else 0)
    elif case == "over the cap":
        # distinct logits: k CAP keeps CAP, k CAP + 1 one more; rows 3 and
        # 4 tie the k-th value with the next, so CAP - 1 and CAP keep one
        # more than k
        k[:] = (CAP, CAP + 1, CAP + 1, CAP - 1, CAP, CAP, 50, CAP + 1)
        p[:] = (1.0, 1.0, 0.9, 0.9, 0.9, 0.9, 0.95, 0.999)
        order = np.argsort(-x, axis=1)
        for r, kk in ((3, CAP - 1), (4, CAP)):
            x[r, order[r, kk]] = x[r, order[r, kk - 1]]
        paths = dict(greedy=0, candidates=4, mass_radix=3, whole_row=1)
    elif case == "nucleus tie":
        # 2 values at 6.0 and 10 at 5.0 above normals shifted by -2; p
        # halfway into the group at 5.0 puts the boundary on the tie
        x -= 2.0
        for r in range(b):
            at = rng.choice(v, 12, replace=False)
            x[r, at[:2]], x[r, at[2:]] = 6.0, 5.0
        e = np.exp(x.astype(np.float64) - 6.0)
        m6, m5 = 2.0, 10.0 * np.exp(-1.0)
        mid = (m6 + 0.5 * m5) / e.sum(1)
        k[:] = (0, 20, CAP + 5, 0, 20, 12, 11, 0)
        p[:] = mid.astype(np.float32)
        p[5:7] = 0.999  # the tie at the k-th value alone
        paths = dict(greedy=0, candidates=4, mass_radix=4, whole_row=0)
    else:  # the burst's mix: 4 greedy rows, then T 0.8, k 50, p 0.95
        greedy[:4] = True
        temp[4:], k[4:], p[4:] = 0.8, 50, 0.95
        paths = dict(greedy=4, candidates=4, mass_radix=0, whole_row=0)
    return (x, greedy, temp, k, p), paths


SAMPLER_CASES = [("digit ties", 4096), ("top_k over V", 300),
                 ("top_k over V", 4096), ("equal logits", 300),
                 ("equal logits", 4096), ("-inf entries", 300),
                 ("-inf entries", 4096), ("over the cap", 4096),
                 ("nucleus tie", 4096), ("burst", 1000), ("burst", 49152),
                 ("burst", 256000), ("digit ties", 256000),
                 ("over the cap", 256000)]


@pytest.mark.parametrize("cluster,store_w", [(None, None), (8, None),
                                             (8, False), (16, None),
                                             (16, False)])
@pytest.mark.parametrize("case,v", SAMPLER_CASES)
def test_sampler_paths_match_plain(dev, case, v, cluster, store_w):
    """Each path of the kernel against the plain sampler, token for
    token, at uniforms 0, 1 - 2^-24 and random ones, under the served
    plan (``sample_plan``) and each other: clusters of 8 and 16 blocks,
    with the weights kept beside the logits (where they fit) and
    recomputed; each row counted on the path it should take; a repeat
    call bit-identical."""
    from repro_torch.kernels import topk_sample as ts

    plan = None if cluster is None else ts._slices(v, cluster, store_w)
    (x, greedy, temp, k, p), paths = _sampler_case(case, v)
    logits = torch.from_numpy(x).to(dev)
    args = [torch.from_numpy(a).to(dev) for a in (greedy, temp, k, p)]
    gen = torch.Generator(device=dev).manual_seed(v)
    draws = [torch.zeros(8, device=dev),
             torch.full((8,), 1.0 - 2 ** -24, device=dev)]
    draws += [torch.rand((8,), generator=gen, device=dev) for _ in range(6)]
    for u in draws:
        ops.reset_launches()
        got = ts.sample_tokens(logits, *args, u, _plan=plan)
        assert ops.path_rows() == paths
        want = L.sample_tokens(logits, *args, u)
        assert torch.equal(got, want), (got.tolist(), want.tolist())
        assert torch.equal(ts.sample_tokens(logits, *args, u, _plan=plan),
                           got)


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("case,v", [("digit ties", 4096),
                                    ("equal logits", 4096),
                                    ("over the cap", 256000)])
def test_topk_sample_radix_matches_plain(dev, case, v, cluster):
    """The Pallas semantics over the digit radix: k of 1, CAP, V and past
    V, on ties at the k-th value."""
    from repro_torch.kernels import topk_sample as ts

    (x, _, temp, _, _), _ = _sampler_case(case, v)
    logits = torch.from_numpy(x).to(dev)
    temp = torch.from_numpy(temp).to(dev)
    k = torch.tensor([1, 5, 511, 512, 513, v, v + 5, 3], dtype=torch.int32,
                     device=dev)
    uu = torch.rand((8, v), generator=torch.Generator(device=dev)
                    .manual_seed(1), device=dev)
    got = ts.topk_sample(logits, k, temp, uu, _cluster=cluster)
    assert torch.equal(got, L.topk_sample(logits, k, temp, uu))
    again = ts.topk_sample(logits, k, temp, uu, _cluster=cluster)
    assert torch.equal(again, got)


def test_sampler_static_smem_within_the_plan(dev):
    """The kernel's own shared memory stays inside the bound the wrapper
    adds to the slice, and each plan that fits a block at vocab 256000
    fits a cluster on the card (how many at once chip_smoke.py prints)."""
    from repro_torch.kernels import topk_sample as ts

    lib = build.load()
    for cluster in (8, 16):
        static = lib.value("sample_tokens_static_smem", cluster)
        assert 0 < static <= ts.STATIC_SMEM
        for store_w in (False, True):
            if ts._slices(256000, cluster, store_w).smem \
                    <= ts.SMEM_LIMIT:
                assert lib.value("sample_tokens_max_clusters", 256000,
                                 cluster, int(store_w)) >= 1


def test_wrappers_raise_on_cuda_inputs_they_cannot_take(dev):
    q = torch.zeros((1, 16, 4, 48), device=dev)  # head_dim 48
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros((1, 16, 4, 64), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.flash_attention(q, q[:, :, :2].contiguous(),
                            q[:, :, :2].contiguous())
    pool = torch.zeros((3, 16, 1, 64), device=dev)
    table = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    pos = torch.ones((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="exceeds"):  # G * S = 72 rows
        ops.paged_decode_attention(torch.zeros((1, 9, 8, 64), device=dev),
                                   pool, pool, table, pos)
    with pytest.raises(ValueError, match="int32"):
        ops.paged_decode_attention(torch.zeros((1, 1, 4, 64), device=dev),
                                   pool, pool, table.long(), pos)
    ring = torch.zeros((1, 16, 1, 48), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        ops.decode_attention(torch.zeros((1, 1, 4, 48), device=dev), ring,
                             ring, pos)
    a = torch.zeros((1, 8, 64), device=dev)
    with pytest.raises(ValueError, match="float32"):
        ops.rglru_scan(a.bfloat16(), a.bfloat16(), a[:, 0].bfloat16())
    pool8 = torch.zeros((3, 16, 1, 64), device=dev, dtype=torch.int8)
    sc = torch.zeros((3, 16, 1, 1), device=dev)
    q = torch.zeros((1, 1, 4, 64), device=dev)
    with pytest.raises(ValueError, match="int8 pools"):  # float64 scales
        ops.paged_decode_attention_int8(q, pool8, pool8, sc.double(),
                                        sc.double(), table, pos)
    with pytest.raises(ValueError, match="int8 pools"):  # model-dtype pools
        ops.paged_decode_attention_int8(q, pool, pool, sc, sc, table, pos)
    x = torch.zeros((4, 64), device=dev, dtype=torch.bfloat16)
    w8 = torch.zeros((64, 32), device=dev, dtype=torch.int8)
    one = torch.ones((32,), device=dev)
    with pytest.raises(ValueError, match="float32 or bfloat16 x"):
        ops.int8_matmul(x.half(), w8, one)
    with pytest.raises(ValueError, match="float32 or bfloat16 x"):
        ops.int8_matmul(x, w8.float(), one)
    with pytest.raises(ValueError, match="multiples of 16"):
        ops.int8_matmul(x[:, :40].contiguous(), w8[:40], one)
    with pytest.raises(ValueError, match="contiguous"):
        ops.int8_matmul(x, w8.t().contiguous().t(), one)
    big = max_vocab() + 1
    logits = torch.zeros((1, big), device=dev)
    one = torch.ones((1,), device=dev)
    with pytest.raises(ValueError, match="does not fit"):
        ops.sample_tokens(logits, one.bool(), one, one.int(), one, one)


@pytest.mark.parametrize("precision", [
    dict(), dict(kv_cache_dtype="int8", weight_dtype="int8"),
    dict(kv_cache_dtype="int8", kv_scale_granularity="token")])
def test_engine_streams_on_cuda_match_the_cpu(dev, precision):
    import dataclasses

    from repro_torch import serving as ts
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config("granite-8b").reduced(),
                              num_kv_heads=2)
    p_cpu = init_params(cfg, seed=0, device="cpu")
    p_gpu = _to(p_cpu, dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 23, 40, 17)]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs = []
        for params, device in ((p_gpu, dev), (p_cpu, "cpu")):
            eng = ts.ServingEngine(
                cfg, params, ts.EngineConfig(
                    slots=3, max_seq=128,
                    precision=ts.PrecisionConfig(**precision)),
                device=device)
            reqs = [ts.Request(rid=i, prompt=p, max_new_tokens=12,
                               sampling=(ts.SamplingParams(
                                   temperature=0.8, top_k=20, top_p=0.9,
                                   seed=1000 + i) if i % 2
                                   else ts.SamplingParams()))
                    for i, p in enumerate(prompts)]
            for r in reqs:
                eng.submit(r, 0.0)
            t = 0.0
            while sum(r.done for r in reqs) < len(reqs) and t < 500:
                t += 1.0
                eng.step(t)
            eng.drain(t)
            outs.append([r.output for r in reqs])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert outs[0] == outs[1]


@pytest.mark.parametrize("arch", ["granite-8b", "recurrentgemma-9b"])
def test_rolling_engine_streams_on_cuda_match_the_cpu(dev, arch):
    """Rolling caches: granite with paged=False (rings of 32 that wrap),
    recurrentgemma cut to 5 layers (rings of 64, prompts past them)."""
    import dataclasses

    from repro_torch import serving as ts
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    base = get_config(arch).reduced()
    if arch == "granite-8b":
        cfg = dataclasses.replace(base, num_kv_heads=2)
        engine, lens = dict(paged=False, window=32), (5, 23, 32, 17)
    else:
        cfg = dataclasses.replace(base, num_layers=5)
        engine, lens = {}, (100, 5, 64, 23)
    p_cpu = init_params(cfg, seed=0, device="cpu")
    p_gpu = _to(p_cpu, dev)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    outs = []
    for params, device in ((p_gpu, dev), (p_cpu, "cpu")):
        eng = ts.ServingEngine(cfg, params,
                               ts.EngineConfig(slots=3, **engine),
                               device=device)
        assert not eng.paged
        reqs = [ts.Request(rid=i, prompt=p, max_new_tokens=12,
                           sampling=(ts.SamplingParams(
                               temperature=0.8, top_k=20, top_p=0.9,
                               seed=1000 + i) if i % 2
                               else ts.SamplingParams()))
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r, 0.0)
        t = 0.0
        while sum(r.done for r in reqs) < len(reqs) and t < 500:
            t += 1.0
            eng.step(t)
        eng.drain(t)
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


def _reduced_granite(dev):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config("granite-8b").reduced(),
                              num_kv_heads=2)
    p_cpu = init_params(cfg, seed=0, device="cpu")
    return cfg, p_cpu, _to(p_cpu, dev)


# arrival tick, prompt length, new tokens: arrivals between windows force
# single ticks (and flushes) between the fused windows
STAGGER = [(0, 5, 14), (0, 23, 9), (2, 40, 12), (5, 17, 10), (9, 9, 11)]


def _staggered_round(ts, eng, seed=0):
    rng = np.random.default_rng(seed)
    reqs = [ts.Request(rid=i, prompt=rng.integers(
                0, 500, n).astype(np.int32), max_new_tokens=new,
                       sampling=(ts.SamplingParams(
                           temperature=0.8, top_k=20, top_p=0.9,
                           seed=1000 + i) if i % 2 else ts.SamplingParams()))
            for i, (_, n, new) in enumerate(STAGGER)]
    t, pending = 0.0, list(zip(STAGGER, reqs))
    while pending or not all(r.done for r in reqs):
        while pending and pending[0][0][0] <= t:
            eng.submit(pending.pop(0)[1], t)
        eng.step(t)
        t += 1.0
        assert t < 500
    eng.drain(t)
    return [r.output for r in reqs]


@pytest.mark.parametrize("sync_every", [1, 3, 8])
def test_graphed_streams_match_the_cpu_under_staggered_arrivals(
        dev, sync_every):
    """Decode ticks, fused windows and bucketed prefill replay captured
    graphs on the card: the float32 streams equal the CPU engine's (an
    aliased per-tick output or a rebound carry would not), one capture per
    key and at most two decode keys; a second round after ``reset()``
    captures nothing and gives the same streams."""
    from repro_torch import serving as ts

    cfg, p_cpu, p_gpu = _reduced_granite(dev)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs = {}
        for params, device in ((p_gpu, dev), (p_cpu, "cpu")):
            eng = ts.ServingEngine(cfg, params, ts.EngineConfig(
                slots=3, max_seq=128, sync_every=sync_every), device=device)
            outs[str(device)] = _staggered_round(ts, eng)
            if device == "cpu":
                continue
            g = eng.graphs
            assert g.captures == eng.prefill_traces + eng.decode_traces
            assert eng.decode_traces <= (2 if sync_every > 1 else 1)
            assert g.replays > 0
            captures, probes = g.captures, (eng.prefill_traces,
                                            eng.decode_traces)
            eng.reset()
            assert _staggered_round(ts, eng) == outs[str(device)]
            assert g.captures == captures
            assert (eng.prefill_traces, eng.decode_traces) == probes
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert outs[str(dev)] == outs["cpu"]


def _prefix_round(ts, eng):
    """A 64-token template (chunked), then, arriving together, a hit with
    a 5-token suffix (one suffix step), a hit with a 40-token suffix
    (chunks after the gather) and a cold 90-token prompt (chunks)."""
    rng = np.random.default_rng(5)
    tpl = rng.integers(0, 500, 64).astype(np.int32)
    waves = [[tpl], [np.concatenate([tpl, rng.integers(0, 500, n)])
                     .astype(np.int32) for n in (5, 40)]
             + [rng.integers(0, 500, 90).astype(np.int32)]]
    out, t, rid = [], 0.0, 0
    for wave in waves:
        reqs = []
        for p in wave:
            reqs.append(ts.Request(rid=rid, prompt=p, max_new_tokens=9,
                                   sampling=(ts.SamplingParams(
                                       temperature=0.8, top_k=20,
                                       seed=300 + rid) if rid % 2
                                       else ts.SamplingParams())))
            eng.submit(reqs[-1], t)
            rid += 1
        while not all(r.done for r in reqs):
            t += 1.0
            eng.step(t)
            assert t < 500
        eng.drain(t)
        out += [(r.output, r.prefix_hit_tokens) for r in reqs]
    return out


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_chunk_and_suffix_graphs_match_the_cpu(dev, kv_dtype):
    """Chunk steps, a hit's suffix step (gather, suffix and scatter in one
    graph), a chunked hit's gather and the activations' scatters replay
    captured graphs on the card: the float32 streams equal the CPU
    engine's eager steps, model-dtype and int8 pages; after ``reset()`` a
    second round captures nothing and gives the same streams."""
    from repro_torch import serving as ts

    cfg, p_cpu, p_gpu = _reduced_granite(dev)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs = {}
        for params, device in ((p_gpu, dev), (p_cpu, "cpu")):
            eng = ts.ServingEngine(cfg, params, ts.EngineConfig(
                slots=3, max_seq=256, sync_every=3, chunk_prefill=16,
                prefix_cache=True, precision=ts.PrecisionConfig(
                    kv_cache_dtype=kv_dtype)), device=device)
            outs[str(device)] = _prefix_round(ts, eng)
            if device == "cpu":
                continue
            keys = {(kind, name) for kind, name, _ in eng.graphs.keys}
            assert {("aux", "chunk"), ("prefill", "suffix"), ("aux", "seed"),
                    ("aux", "insert")} <= keys
            assert eng.compile_events["prefill/chunk16"] == 1
            captures = eng.graphs.captures
            assert captures == len(eng.graphs.keys)
            eng.reset()
            assert _prefix_round(ts, eng) == outs[str(device)]
            assert eng.graphs.captures == captures
            assert eng.allocator.pages_in_use == eng.prefix_index.cached_pages
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert outs[str(dev)] == outs["cpu"]
    assert [h for _, h in outs["cpu"]] == [0, 64, 64, 0]


def test_replays_credit_one_eager_ticks_launches(dev):
    """A replay calls no wrapper: the step cache credits each replay with
    the launches the capture recorded, so N replays count N times one
    eager tick, kernel by kernel; the sampler's device row counts advance
    in the replays themselves."""
    from repro_torch import serving as ts

    cfg, _, p_gpu = _reduced_granite(dev)
    eng = ts.ServingEngine(cfg, p_gpu, ts.EngineConfig(
        slots=3, max_seq=128, sync_every=1), device=dev)
    rng = np.random.default_rng(0)
    for i in range(3):
        eng.submit(ts.Request(rid=i, prompt=rng.integers(
            0, 500, 9 + 7 * i).astype(np.int32), max_new_tokens=64), 0.0)
    eng._ensure_headroom(20)
    ops.reset_launches()
    eng._tick()
    torch.cuda.synchronize()
    eager = {k: v for k, v in ops.LAUNCHES.items() if v}
    assert eager["sample_tokens"] == 1 and eager["paged_decode_attention"] > 0
    ops.reset_launches()
    eng.graphs.run("decode", "tick", 1, eng._tick)  # eager run + capture
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == eager
    ops.reset_launches()
    n = 7
    for _ in range(n):
        eng.graphs.run("decode", "tick", 1, eng._tick)
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
        k: n * v for k, v in eager.items()}
    assert sum(ops.path_rows().values()) == n * eng.slots
    assert eng.decode_traces == 1
    assert eng.graphs.captures == eng.prefill_traces + eng.decode_traces


def test_a_failed_capture_raises_and_never_serves_eagerly(dev):
    """A step whose capture fails raises from ``run``, every time: the key
    is neither counted nor cached, so no later call is served by the eager
    path in its place."""
    from repro_torch.serving.graphs import StepGraphs

    g = StepGraphs(dev)
    x = torch.zeros(4, device=dev)

    def step():
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("forced capture failure")
        x.add_(1)

    for _ in range(2):
        with pytest.raises(RuntimeError, match="forced capture failure"):
            g.run("decode", "tick", 1, step)
    torch.cuda.synchronize()
    assert x.tolist() == [2.0] * 4  # the two first-call runs, nothing else
    assert (g.captures, g.decode_traces, g.keys) == (0, 0, [])
    g.run("decode", "tick", 2, lambda: x.add_(1))  # the cache still works
    g.run("decode", "tick", 2, lambda: x.add_(1))
    torch.cuda.synchronize()
    assert x.tolist() == [4.0] * 4 and g.captures == 1 and g.replays == 1


@pytest.mark.parametrize("policy", ["round-robin", "predicted"])
def test_cluster_streams_on_cuda_match_the_cpu(dev, policy):
    """Two reduced granite replicas from one set of weights behind the
    cluster frontend, span tracing on, one replica killed mid-decode in
    the second round: the card's streams, routes and failovers equal the
    CPU's, each round's streams equal one engine's, no capture follows
    the first round, and the traces export and validate."""
    from repro_torch import serving as ts

    cfg, p_cpu, p_gpu = _reduced_granite(dev)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 500, n).astype(np.int32)
               for n in (5, 23, 40, 17, 64, 9)]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False

    def reqs():
        return [ts.Request(rid=i, prompt=p, max_new_tokens=12,
                           sampling=(ts.SamplingParams(
                               temperature=0.8, top_k=20, top_p=0.9,
                               seed=1000 + i) if i % 2
                               else ts.SamplingParams()))
                for i, p in enumerate(prompts)]

    def drive(server, rs, inj=None):
        for r in rs:
            server.submit(r, 0.0)
        t = 0.0
        while not all(r.done for r in rs):
            t += 1.0
            if inj is not None:
                inj.tick(t)
            server.step(t)
            assert t < 500
        server.drain(t)
        return [r.output for r in rs]

    try:
        seen = {}
        for params, device in ((p_gpu, dev), (p_cpu, "cpu")):
            config = ts.EngineConfig(slots=2, max_seq=128, sync_every=4,
                                     tracing=True)
            e0 = ts.ServingEngine(cfg, params, config, device=device)
            e1 = ts.ServingEngine(cfg, e0.params, config, device=device)
            single = drive(e0, reqs())
            e1_warm = drive(e1, reqs())
            captures = (e0.graphs.captures, e1.graphs.captures)
            out = []
            for kill in (False, True):
                for e in (e0, e1):
                    e.reset()
                proxies = [ts.FaultyEngine(e) for e in (e0, e1)]
                fe = ts.ClusterFrontend(proxies, policy=policy, seed=0,
                                        tracing=True)
                inj = ts.FaultInjector({fe.instances[1].name: proxies[1]})
                if kill:
                    inj.schedule(4.0, fe.instances[1].name, "kill")
                rs = reqs()
                streams = drive(fe, rs, inj)
                assert streams == single == e1_warm
                doc = ts.chrome_trace(ts.request_traces(rs))
                assert ts.validate_chrome_trace(doc) == []
                out.append((streams, [r.routed_to for r in rs],
                            fe.merged_metrics().failed_over,
                            [i.name for i in fe.failed]))
            assert (e0.graphs.captures, e1.graphs.captures) == captures
            assert out[1][2] > 0 and out[1][3] == ["pool/e1"]
            seen[str(device)] = out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert seen[str(dev)] == seen["cpu"]


def test_a_dropped_engine_gives_back_its_device_memory(dev):
    """Every engine's first (eager) runs share one stream per card, since
    cuBLAS keeps a workspace for each stream it has run on for the life of
    the process: an engine that captured its steps and is then dropped (a
    retired or rebuilt replica) leaves no device memory behind."""
    import gc

    from repro_torch import serving as ts

    cfg, _, p_gpu = _reduced_granite(dev)

    def served():
        eng = ts.ServingEngine(cfg, p_gpu, ts.EngineConfig(
            slots=2, max_seq=128, sync_every=4), device=dev)
        _staggered_round(ts, eng)
        return eng

    first = served()  # pays the process's one-time allocations
    side = first.graphs._side
    del first
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    eng = served()
    assert eng.graphs._side is side
    assert eng.graphs.captures > 0
    del eng
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == base
