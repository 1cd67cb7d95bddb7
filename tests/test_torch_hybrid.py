"""The PyTorch port's hybrid pieces against the JAX package's, at reduced
sizes with inputs from numpy seeds: the plain versions of the RG-LRU scan
and of rolling-cache decode attention against the Pallas kernels (run in
interpret mode) and the oracles, windowed prefill attention, the RG-LRU
gates, scan and step, and both hybrid block types (and the dense block
over a ring) in prefill and decode.

Tolerances: the reference suite's, float32 2e-5 and bfloat16 2e-2 for
attention, 1e-4 for the scan (``tests/test_kernels.py``). The RG-LRU
pieces and the blocks are float32 on both sides; the reference combines
the recurrence by associative scan and the port walks time, so sums run
in another order (and the gates' 256-wide products too): 1e-5 for the
gates, the steps and a block's output, 1e-4 for the long scans."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import blocks as jb
from repro.models import layers as jl
from repro.models import rglru as jr
from repro_torch.configs import get_config as torch_config
from repro_torch.kernels import ops, plain
from repro_torch.models import blocks as tb
from repro_torch.models import layers as tl
from repro_torch.models import rglru as tr

torch.set_num_threads(2)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _cfgs(num_layers=5):
    jc = dataclasses.replace(jax_config("recurrentgemma-9b").reduced(),
                             num_layers=num_layers)
    tc = dataclasses.replace(torch_config("recurrentgemma-9b").reduced(),
                             num_layers=num_layers)
    return jc, tc


def _t(tree):
    """A JAX tree of arrays -> the same tree of CPU torch tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=0)


@pytest.mark.parametrize("s,l", [(128, 128), (128, 256), (384, 128),
                                 (384, 256)])
def test_rglru_scan_plain_matches_the_pallas_kernel_and_oracle(s, l):
    rng = np.random.default_rng(s + l)
    a = rng.uniform(0.5, 0.999, (2, s, l)).astype(np.float32)
    x = rng.standard_normal((2, s, l)).astype(np.float32)
    h0 = rng.standard_normal((2, l)).astype(np.float32)
    y, h = ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(x),
                          torch.from_numpy(h0))
    args = (jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0))
    for want_y, want_h in (jops.rglru_scan(*args, interpret=True),
                           jref.ref_rglru_scan(*args)):
        _close(y, want_y, 1e-4)
        _close(h, want_h, 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 4])
def test_rolling_decode_plain_matches_the_pallas_kernel(s, dtype):
    """MQA (4 q heads over 1 kv head); rings partly filled, exactly full,
    and wrapped (pos past W). The port follows the reference's model twin
    ``layers.decode_attention`` everywhere: query i sees min(pos - (S-1) +
    i, W) rows. The Pallas kernel's wrapper caps first, min(pos, W) -
    (S-1) + i, which differs only for S > 1 on a wrapped ring (a prefill
    chunk written past the window, which the reference's engine never
    runs), so that slot is held to the twin alone."""
    rng = np.random.default_rng(7 + s)
    b, w, h, kvh, d = 4, 64, 4, 1, 32
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, w, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, w, kvh, d)).astype(np.float32)
    pos = np.array([s + 1, 37, w, w + 29], np.int32)
    jdt = getattr(jnp, dtype)
    jargs = [jnp.asarray(t, jdt) for t in (q, k, v)]
    tdt = getattr(torch, dtype)
    got = ops.decode_attention(*(torch.from_numpy(t).to(tdt)
                                 for t in (q, k, v)), torch.from_numpy(pos))
    assert got.dtype == tdt
    _close(got, jl.decode_attention(*jargs, jnp.asarray(pos)), TOL[dtype])
    want = jops.decode_attention(*jargs, jnp.asarray(pos), interpret=True)
    same = slice(None) if s == 1 else slice(0, 3)  # slot 3 is wrapped
    _close(got[same], np.asarray(want, np.float32)[same], TOL[dtype])


@pytest.mark.parametrize("window", [0, 16, 64])
@pytest.mark.parametrize("s", [40, 100])
def test_windowed_dense_attention_matches_jax(s, window):
    rng = np.random.default_rng(s + window)
    q = rng.standard_normal((2, s, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, s, 1, 32)).astype(np.float32)
    v = rng.standard_normal((2, s, 1, 32)).astype(np.float32)
    got = ops.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                              causal=True, window=window)
    want = jl.dense_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=True, window=window)
    _close(got, want, TOL["float32"])


@pytest.fixture(scope="module")
def mixer():
    jc, tc = _cfgs()
    jp = jr.init_rglru(jc, jax.random.key(3), jnp.float32)
    return jc, tc, jp, _t(jp)


def test_rglru_gates_scan_and_step_match_jax(mixer):
    jc, tc, jp, tp = mixer
    rng = np.random.default_rng(0)
    lw = tc.resolved_lru_width
    u = rng.standard_normal((2, 48, lw)).astype(np.float32)
    h0 = rng.standard_normal((2, lw)).astype(np.float32)
    ju, tu = jnp.asarray(u), torch.from_numpy(u)
    ja, jx = jr._rglru_gates(jp, ju)
    ta, tx = tr._rglru_gates(tp, tu)
    _close(ta, ja, 1e-5)
    _close(tx, jx, 1e-5)
    jy, jh = jr.rglru_scan(jp, ju, jnp.asarray(h0))
    ty, th = tr.rglru_scan(tp, tu, torch.from_numpy(h0))
    _close(ty, jy, 1e-5)
    _close(th, jh, 1e-5)
    jy1, jh1 = jr.rglru_step(jp, ju[:, :1], jnp.asarray(h0))
    ty1, th1 = tr.rglru_step(tp, tu[:, :1], torch.from_numpy(h0))
    _close(ty1, jy1, 1e-5)
    _close(th1, jh1, 1e-5)


def test_rglru_block_prefill_then_steps_match_jax(mixer):
    jc, tc, jp, tp = mixer
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 30, tc.d_model)).astype(np.float32)
    jcache = jr.init_rglru_cache(jc, 2, jnp.float32)
    tcache = tr.init_rglru_cache(tc, 2, torch.float32, "cpu")
    jy, jcache = jr.apply_rglru_block(jc, jp, jnp.asarray(x), cache=jcache)
    ty = tr.apply_rglru_block(tc, tp, torch.from_numpy(x), cache=tcache)
    _close(ty, jy, 1e-5)
    for _ in range(3):
        x1 = rng.standard_normal((2, 1, tc.d_model)).astype(np.float32)
        jy, jcache = jr.apply_rglru_block(jc, jp, jnp.asarray(x1),
                                          cache=jcache)
        ty = tr.apply_rglru_block(tc, tp, torch.from_numpy(x1),
                                  cache=tcache)
        _close(ty, jy, 1e-5)
        _close(tcache["conv"], jcache["conv"], 1e-5)
        _close(tcache["state"], jcache["state"], 1e-5)
    # no cache: a prefill from nothing, as the reference's None cache
    jy, _ = jr.apply_rglru_block(jc, jp, jnp.asarray(x))
    _close(tr.apply_rglru_block(tc, tp, torch.from_numpy(x)), jy, 1e-5)


def _rope(cfg, pos0, b, s):
    pos = np.arange(pos0, pos0 + s, dtype=np.int32)[None].repeat(b, 0)
    return (tl.rope_table(cfg, torch.from_numpy(pos).long()),
            jnp.asarray(pos))


@pytest.mark.parametrize("btype,s", [("local_attn", 40), ("local_attn", 64),
                                     ("rglru", 40), ("dense", 40)])
def test_blocks_prefill_and_decode_match_jax(btype, s):
    """A prompt of S tokens fills a fresh rolling cache (ring of
    W = min(96, 64) rows for local attention, 96 for dense), then three
    decode steps; outputs and caches agree with the reference's."""
    jc, tc = _cfgs()
    jp = jb.init_block(jc, btype, jax.random.key(5), jnp.float32)
    tp = _t(jp)
    b, window = 2, 96
    rng = np.random.default_rng(s)
    x = rng.standard_normal((b, s, tc.d_model)).astype(np.float32)
    jcache = jb.init_block_cache(jc, btype, b, window, jnp.float32)
    tcache = tb.init_block_cache(tc, btype, b, window, torch.float32, "cpu")
    trope, jpos = _rope(tc, 0, b, s)
    jy, jcache, _ = jb.apply_block(jc, btype, jp, jnp.asarray(x), jpos,
                                   mode="prefill", cache=jcache, pos=0)
    ty, _, _ = tb.apply_block(tc, btype, tp, torch.from_numpy(x), trope,
                              mode="prefill", cache=tcache)
    _close(ty, jy, 1e-5)
    pos = np.full((b,), s, np.int32)
    for _ in range(3):
        x1 = rng.standard_normal((b, 1, tc.d_model)).astype(np.float32)
        trope, jpos = _rope(tc, int(pos[0]), b, 1)
        jy, jcache, _ = jb.apply_block(jc, btype, jp, jnp.asarray(x1), jpos,
                                       mode="decode", cache=jcache,
                                       pos=jnp.asarray(pos))
        ty, _, _ = tb.apply_block(tc, btype, tp, torch.from_numpy(x1),
                                  trope, mode="decode", cache=tcache,
                                  pos=torch.from_numpy(pos))
        _close(ty, jy, 1e-5)
        pos = pos + 1
    for name in tcache:
        _close(tcache[name], jcache[name], 1e-5)


def test_ring_fill_puts_token_t_at_row_t_mod_w():
    """A prompt longer than the ring (S = 100, W = 64): the last 64 keys
    land at rows t % 64, where decode's writes expect them. (The reference
    stores them at rows 0..63: ROADMAP.md queue 3.)"""
    cache = {"k": torch.zeros((1, 64, 1, 2)), "v": torch.zeros((1, 64, 1, 2))}
    t = torch.arange(100, dtype=torch.float32)
    kv = t[None, :, None, None].expand(1, 100, 1, 2)
    tb.ring_fill(cache, kv, -kv)
    rows = cache["k"][0, :, 0, 0]
    # tokens 36..63 at rows 36..63, tokens 64..99 at rows 0..35
    want = torch.tensor([float(64 + r if r < 36 else r) for r in range(64)])
    torch.testing.assert_close(rows, want, atol=0, rtol=0)
    torch.testing.assert_close(cache["v"], -cache["k"], atol=0, rtol=0)
    short = {"k": torch.zeros((1, 64, 1, 2)), "v": torch.zeros((1, 64, 1, 2))}
    tb.ring_fill(short, kv[:, :40], kv[:, :40])
    torch.testing.assert_close(short["k"][0, :40, 0, 0], t[:40])
    assert bool((short["k"][0, 40:] == 0).all())


def test_plain_scan_is_the_kernels_recurrence():
    """``plain.rglru_scan`` walks h = a h + x in time order from h0."""
    a = torch.tensor([[[0.5, 2.0], [0.25, 1.0], [1.0, 0.5]]])
    x = torch.tensor([[[1.0, 0.0], [2.0, 1.0], [0.0, -1.0]]])
    h0 = torch.tensor([[4.0, 1.0]])
    y, h = plain.rglru_scan(a, x, h0)
    want = torch.tensor([[[3.0, 2.0], [2.75, 3.0], [2.75, 0.5]]])
    torch.testing.assert_close(y, want, atol=0, rtol=0)
    torch.testing.assert_close(h, want[:, -1], atol=0, rtol=0)
