"""The PyTorch port's layer functions (repro_torch.models.layers) against
the JAX package's (repro.models.layers): the same numpy inputs go through
both. Tolerance: float32 2e-5 per function (the reference suite's, see
tests/test_kernels.py); sampled tokens must be equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import layers as JL
from repro_torch.configs import get_config as torch_config
from repro_torch.kernels import plain as TP
from repro_torch.models import layers as TL
from repro_torch.models.blocks import apply_mlp
from repro_torch.serving import prng

torch.set_num_threads(2)
TOL = 2e-5


def _cfgs():
    jc = dataclasses.replace(jax_config("granite-8b").reduced(),
                             num_kv_heads=2)
    tc = dataclasses.replace(torch_config("granite-8b").reduced(),
                             num_kv_heads=2)
    return jc, tc


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=tol, rtol=tol)


def test_rmsnorm_and_rope():
    jc, tc = _cfgs()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    scale = rng.standard_normal((32,)).astype(np.float32) * 0.1
    _close(TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)),
           JL.rmsnorm(jnp.asarray(x), jnp.asarray(scale)))
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    # granite's theta is 1e7: the recipe is exp(-log(theta) i / d) in f32.
    # XLA's and torch's float32 exp differ by up to one ulp, so an angle
    # (pos * freq) may differ by one ulp of the frequency times pos.
    ang_t = TL._rope_angles(torch.from_numpy(pos), 16, tc.rope_theta)
    ang_j = np.array(JL._rope_angles(jnp.asarray(pos), 16, jc.rope_theta))
    np.testing.assert_allclose(ang_t.numpy(), ang_j, rtol=2.5e-7, atol=0)
    # the rotation itself, on the same angles, agrees to the f32 tolerance
    ang = jnp.asarray(ang_j)[:, :, None, :]
    _close(TL._rotate(torch.from_numpy(x), torch.from_numpy(ang_j)[:, :, None]),
           JL._rotate(jnp.asarray(x), ang))
    # end to end: |x| <= 5 times an angle error of pos * 2.5e-7 rad
    got = TL.apply_rope(tc, torch.from_numpy(x), torch.from_numpy(pos))
    want = JL.apply_rope(jc, jnp.asarray(x), jnp.asarray(pos))
    _close(got, want, 5 * 4000 * 2.5e-7)


def test_mlp_swiglu():
    jc, tc = _cfgs()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 256)).astype(np.float32)
    p = {k: (rng.standard_normal(s) * 0.05).astype(np.float32)
         for k, s in (("w_gate", (256, 512)), ("w_up", (256, 512)),
                      ("w_down", (512, 256)))}
    got = apply_mlp(tc, {k: torch.from_numpy(v) for k, v in p.items()},
                    torch.from_numpy(x))
    want = JL.apply_mlp(jc, {k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x))
    _close(got, want, 1e-4)  # 512-term float32 sums in another order


@pytest.mark.parametrize("s", [16, 48])
def test_dense_attention(s):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, s, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, s, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, s, 2, 32)).astype(np.float32)
    got = TL.dense_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=True)
    want = JL.dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True)
    _close(got, want)


def test_dense_attention_bf16_casts_probs_like_the_twin():
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((1, 32, 4, 32), (1, 32, 2, 32), (1, 32, 2, 32)))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    got = TL.dense_attention(tq, tk, tv, causal=True).float()
    want = JL.dense_attention(jq, jk, jv, causal=True).astype(jnp.float32)
    _close(got, want, 2e-2)


@pytest.mark.parametrize("sq", [1, 4])
def test_paged_decode_attention(sq):
    rng = np.random.default_rng(4)
    b, ps, n_pages, hkv, h, d = 3, 4, 5, 2, 4, 32
    n_pool = b * n_pages + 1
    kp = rng.standard_normal((n_pool, ps, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((n_pool, ps, hkv, d)).astype(np.float32)
    table = (rng.permutation(n_pool - 1)[:b * n_pages] + 1).reshape(
        b, n_pages).astype(np.int32)
    table[2] = 0  # a released slot on the trash page
    pos = np.array([7, 20, sq], np.int32)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    got = TL.paged_decode_attention(*(torch.from_numpy(a) for a in
                                      (q, kp, vp, table, pos)))
    want = JL.paged_decode_attention(*(jnp.asarray(a) for a in
                                       (q, kp, vp, table, pos)))
    _close(got, want)


def test_float_bits_and_radix_threshold():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    # +0.0 and -0.0 map alike (denormals are left out: XLA on the CPU
    # flushes them to zero, torch and the CUDA kernel keep them)
    x[0, :2] = [0.0, -0.0]
    got = TP._float_bits_descending(torch.from_numpy(x))
    want = np.asarray(JL._float_bits_descending(jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    k = np.array([1, 5, 64], np.float32)
    t = TP._radix_threshold(torch.ones(3, 64), got, torch.from_numpy(k))
    j = JL._radix_threshold(jnp.ones((3, 64)), jnp.asarray(want),
                            jnp.asarray(k))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(np.int64))


def test_process_logits_masks():
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((4, 96)) * 3).astype(np.float32)
    temp = np.array([0.7, 1.0, 1.5, 1.0], np.float32)
    top_k = np.array([0, 5, 20, 1], np.int32)
    top_p = np.array([0.9, 1.0, 0.5, 1.0], np.float32)
    got = TL.process_logits(*(torch.from_numpy(a) for a in
                              (x, temp, top_k, top_p)))
    want = JL.process_logits(*(jnp.asarray(a) for a in
                               (x, temp, top_k, top_p)))
    np.testing.assert_array_equal(np.isinf(got.numpy()),
                                  np.isinf(np.asarray(want)))


def test_sample_tokens_matches_the_jax_sampler():
    """Same logits and per-slot state; the port draws its uniform from
    its threefry in the installed jax's partitionable mode."""
    rng = np.random.default_rng(7)
    b, v = 6, 256
    logits = (rng.standard_normal((b, v)) * 2).astype(np.float32)
    greedy = np.array([1, 0, 0, 0, 1, 0], bool)
    temp = np.array([1.0, 0.8, 1.2, 0.5, 1.0, 1.0], np.float32)
    top_k = np.array([0, 10, 0, 40, 0, 1], np.int32)
    top_p = np.array([1.0, 1.0, 0.8, 0.9, 1.0, 1.0], np.float32)
    seeds = [11, 12, 13, 14, 15, 16]
    keys = np.stack([np.asarray(jax.random.PRNGKey(s), np.uint32)
                     for s in seeds])
    part = bool(jax.config.jax_threefry_partitionable)
    for step in range(5):
        pos = np.full((b,), 30 + step, np.int32)
        samp = {"greedy": jnp.asarray(greedy),
                "temperature": jnp.asarray(temp),
                "top_k": jnp.asarray(top_k), "top_p": jnp.asarray(top_p),
                "key": jnp.asarray(keys)}
        want = np.asarray(JL.sample_tokens(jnp.asarray(logits), samp,
                                           jnp.asarray(pos)))
        tkeys = torch.tensor([prng.prng_key(s) for s in seeds])
        u = prng.uniform(prng.fold_in(tkeys, torch.from_numpy(pos)), part)
        got = TL.sample_tokens(torch.from_numpy(logits),
                               torch.from_numpy(greedy),
                               torch.from_numpy(temp),
                               torch.from_numpy(top_k),
                               torch.from_numpy(top_p), u)
        np.testing.assert_array_equal(got.numpy(), want)
