"""The port's kernel dispatch points (repro_torch.kernels.ops) on the CPU,
where each runs its plain PyTorch version, against the JAX package: its
model twins (repro.models.layers), its Pallas kernels run in interpret mode
(repro.kernels.ops, as tests/test_kernels.py runs them) and its oracles
(repro.kernels.ref). The same numpy inputs go through both packages.

Tolerances: float32 2e-5 (tests/test_kernels.py); bfloat16 inputs 2e-2
(one bf16 ulp at |x| ~ 2, the reference suite's); sampled tokens exact.

The CUDA kernels themselves cannot build here (no nvcc): the last tests
check that the C entry points ``kernels/build.py`` binds exist in the
sources with the arity it declares. tests/test_torch_gpu.py and
``chip_smoke.py`` run the kernels on a card."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro_torch.kernels import build, ops, ref
from repro_torch.models import layers as TL

torch.set_num_threads(2)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DT = {"float32": (torch.float32, jnp.float32),
      "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _pair(a, dtype):
    tdt, jdt = DT[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(jdt)


def _close(t, j, dtype):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


# -- prefill attention ---------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [16, 40, 128])
def test_flash_attention_plain_matches_jax(s, dtype):
    """The engine's buckets (16, 32, ...) and a ragged length through the
    port's dispatch point, against the JAX twin; S = 128 (one Pallas
    block) also against the Pallas kernel and the oracle."""
    rng = np.random.default_rng(s)
    b, h, kv, d = 2, 4, 2, 32
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))
    (tq, jq), (tk, jk), (tv, jv) = (_pair(a, dtype) for a in (q, k, v))
    before = dict(ops.LAUNCHES)
    got = ops.flash_attention(tq, tk, tv, causal=True)
    assert ops.LAUNCHES == before  # a CPU tensor launches no kernel
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, JL.dense_attention(jq, jk, jv, causal=True), dtype)
    if s % 128 == 0:
        _close(got, jops.flash_attention(jq, jk, jv, causal=True,
                                         interpret=True), dtype)
    # the port's oracle against the JAX package's, on (BH, S, D) heads
    qq, kk, vv = (x.transpose(0, 2, 1, 3).reshape(-1, s, d)
                  for x in (q, np.repeat(k, h // kv, 2),
                            np.repeat(v, h // kv, 2)))
    (tqq, jqq), (tkk, jkk), (tvv, jvv) = (_pair(a, dtype)
                                          for a in (qq, kk, vv))
    _close(ref.ref_attention(tqq, tkk, tvv),
           jref.ref_attention(jqq, jkk, jvv), dtype)


def test_flash_attention_non_causal_and_bad_shapes():
    rng = np.random.default_rng(9)
    q = rng.standard_normal((1, 20, 4, 32)).astype(np.float32)
    k = rng.standard_normal((1, 20, 2, 32)).astype(np.float32)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(k), causal=False)
    _close(got, JL.dense_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(k), causal=False), "float32")
    with pytest.raises(ValueError, match="do not match"):
        ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k[:, :10]),
                            torch.from_numpy(k[:, :10]))
    with pytest.raises(ValueError, match="do not match"):  # H % KVH != 0
        ops.flash_attention(torch.from_numpy(q[:, :, :3]),
                            torch.from_numpy(k), torch.from_numpy(k))


# -- paged decode attention ------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq", [1, 4, 8])
def test_paged_decode_attention_plain_matches_jax(sq, dtype):
    """Pages scattered through the pool, a partial page, a full table, and
    a released slot whose row points at trash page 0, against the JAX
    twin, the Pallas kernel (interpret) and the oracle."""
    rng = np.random.default_rng(10 + sq)
    b, h, kv, d, ps, n_pages = 3, 4, 2, 32, 16, 4
    pool = b * n_pages + 1
    kp = rng.standard_normal((pool, ps, kv, d)).astype(np.float32)
    vp = rng.standard_normal((pool, ps, kv, d)).astype(np.float32)
    table = (rng.permutation(pool - 1)[:b * n_pages] + 1).reshape(
        b, n_pages).astype(np.int32)
    table[2] = 0
    pos = np.array([ps + 5, ps * n_pages, sq], np.int32)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    (tq, jq), (tk, jk), (tv, jv) = (_pair(a, dtype) for a in (q, kp, vp))
    tt, jt = torch.from_numpy(table), jnp.asarray(table)
    tp, jp = torch.from_numpy(pos), jnp.asarray(pos)
    before = dict(ops.LAUNCHES)
    got = ops.paged_decode_attention(tq, tk, tv, tt, tp)
    assert ops.LAUNCHES == before
    _close(got, JL.paged_decode_attention(jq, jk, jv, jt, jp), dtype)
    _close(got, jops.paged_decode_attention(jq, jk, jv, jt, jp,
                                            interpret=True), dtype)
    _close(ref.ref_paged_decode_attention(tq, tk, tv, tt, tp),
           jref.ref_paged_decode_attention(jq, jk, jv, jt, jp), dtype)


def test_paged_decode_context_splits_fill_the_card():
    """Slots x kv heads x splits reach two blocks per SM of the H100
    without more splits than 32-slot tiles."""
    from repro_torch.kernels.decode_attention import n_splits

    assert n_splits(8, 8, 1024) == 5  # the engine's batch: 320 blocks
    assert n_splits(1, 8, 1024) == 32  # one slot: one split per tile
    assert n_splits(1, 8, 64) == 2
    assert n_splits(64, 8, 1024) == 1


def test_paged_decode_attention_bad_shapes():
    q = torch.zeros((2, 1, 4, 32))
    pool = torch.zeros((5, 16, 2, 32))
    with pytest.raises(ValueError, match="do not match"):
        ops.paged_decode_attention(q, pool, pool,
                                   torch.zeros((3, 2), dtype=torch.int32),
                                   torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="want q"):
        ops.paged_decode_attention(q[0], pool, pool,
                                   torch.zeros((2, 2), dtype=torch.int32),
                                   torch.ones(2, dtype=torch.int32))


# -- sampler ---------------------------------------------------------------------


@pytest.mark.parametrize("v", [128, 500])
@pytest.mark.parametrize("seed", [0, 1])
def test_topk_sample_plain_matches_the_pallas_kernel(v, seed):
    """The Pallas kernel's own semantics (Gumbel argmax over (B, V)
    uniforms): exact tokens against the kernel in interpret mode and
    against both packages' sort-based oracles."""
    b = 6
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    logits[0, 5] = logits[0, 9] = logits[0].max() + 1.0  # a tie at the top
    k = rng.integers(1, v + 1, b).astype(np.int32)
    k[0] = 1
    temp = rng.uniform(0.2, 2.0, b).astype(np.float32)
    u = rng.uniform(0, 1, (b, v)).astype(np.float32)
    targs = [torch.from_numpy(a) for a in (logits, k, temp, u)]
    jargs = [jnp.asarray(a) for a in (logits, k, temp, u)]
    got = ops.topk_sample(*targs).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jops.topk_sample(*jargs, interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(jref.ref_topk_sample(
        *jargs)))
    np.testing.assert_array_equal(got, ref.ref_topk_sample(*targs).numpy())
    assert got[0] in (5, 9)  # k = 1 keeps both tied maxima, only them


def test_sample_tokens_dispatch_is_the_plain_sampler():
    """The engine's entry point on the CPU is the twin of
    layers.sample_tokens (held against JAX in test_torch_layers.py);
    greedy rows take the lowest index of a tied maximum."""
    rng = np.random.default_rng(2)
    b, v = 5, 300
    logits = torch.from_numpy((rng.standard_normal((b, v)) * 2).astype(
        np.float32))
    logits[0, 3] = logits[0, 8] = logits[0].max() + 1.0
    greedy = torch.tensor([True, False, False, True, False])
    temp = torch.tensor([1.0, 0.8, 1.2, 1.0, 0.6])
    top_k = torch.tensor([0, 10, 0, 0, 1], dtype=torch.int32)
    top_p = torch.tensor([1.0, 0.9, 0.7, 1.0, 1.0])
    u = torch.from_numpy(rng.uniform(0, 1, b).astype(np.float32))
    got = ops.sample_tokens(logits, greedy, temp, top_k, top_p, u)
    want = TL.sample_tokens(logits, greedy, temp, top_k, top_p, u)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert int(got[0]) == 3
    assert int(got[4]) == int(torch.argmax(logits[4]))  # top_k = 1
    with pytest.raises(ValueError, match="does not match"):
        ops.sample_tokens(logits, greedy[:3], temp, top_k, top_p, u)


# -- the CUDA sources and their bindings -----------------------------------------

_ENTRY = re.compile(r'extern "C" int (\w+)\(([^)]*)\)', re.S)


def test_every_bound_entry_point_is_in_its_source():
    found = {}
    for name in build.SOURCES:
        src = (build.CSRC / f"{name}.cu").read_text()
        for fn, params in _ENTRY.findall(src):
            found[fn] = (name, len(params.split(",")))
    for fn, (lib, argtypes) in build.SIGNATURES.items():
        assert found.get(fn) == (lib, len(argtypes)), fn


def test_source_hash_covers_every_source_and_header():
    h = build.source_hash()
    assert len(h) == 16 and h == build.source_hash()
    names = {p.name for p in build.CSRC.iterdir()}
    assert {f"{s}.cu" for s in build.SOURCES} <= names
    assert "common.cuh" in names
