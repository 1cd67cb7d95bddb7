"""The PyTorch port's model (repro_torch.models) against the JAX package's
(repro.models) on granite-8b ``reduced()`` with two kv heads (G = 2), on
the same weights: the JAX pytree converted by ``params_from_jax``.

Compared: prefill logits at the engine's buckets 16 and 64, and paged
decode logits for S = 1 (a decode tick) and S = 4 (a multi-token step)
after a prompt was scattered into pages, with a released slot riding on
trash page 0.

Tolerance for whole-model logits: 1e-4 absolute. Both packages compute in
float32; the port's sums run in another order (PyTorch's CPU matmul and
einsum against XLA's), a relative error of a few float32 ulps per
product, carried through 2 blocks of 256-wide sums to logits of up to
about 4. The largest gap seen at these shapes is about 6e-6; 1e-4 leaves
room for the order of summation and nothing else."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import get_config as jax_config
from repro.serving import engine as je
from repro_torch import models as tm
from repro_torch.configs import get_config as torch_config
from repro_torch.serving import engine as te

torch.set_num_threads(2)
TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    jc = dataclasses.replace(jax_config("granite-8b").reduced(),
                             num_kv_heads=2)
    tc = dataclasses.replace(torch_config("granite-8b").reduced(),
                             num_kv_heads=2)
    jp = jm.init_params(jc, jax.random.key(0))
    tp = tm.params_from_jax(tc, jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=tol, rtol=0)


def test_params_from_jax_unstacks_the_scanned_body(setup):
    jc, tc, jp, tp = setup
    assert len(tp["layers"]) == tc.num_layers == len(tm.layer_types(tc))
    for r, layer in enumerate(tp["layers"]):
        # (in, out) orientation kept: wq is (d_model, heads * head_dim)
        assert tuple(layer["attn"]["wq"].shape) == (
            tc.d_model, tc.num_heads * tc.resolved_head_dim)
        np.testing.assert_array_equal(
            layer["mlp"]["w_down"].numpy(),
            np.asarray(jp["body"][0]["mlp"]["w_down"][r]))
    np.testing.assert_array_equal(tp["embed"].numpy(),
                                  np.asarray(jp["embed"]))


def test_params_from_jax_keeps_bfloat16_bits():
    cfg = torch_config("granite-8b").reduced()
    a = np.asarray(jnp.asarray([[1.5, -2.25e-3]], jnp.bfloat16))
    tree = {"body": [], "tail": [], "final_norm": {"scale": a[0]},
            "embed": a}
    got = tm.params_from_jax(dataclasses.replace(cfg, num_layers=0), tree,
                             "cpu")
    assert got["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["embed"].float().numpy(),
                                  a.astype(np.float32))


@pytest.mark.parametrize("bucket,true_len", [(16, 11), (64, 40)])
def test_prefill_logits_match_jax(setup, bucket, true_len):
    jc, tc, jp, tp = setup
    rng = np.random.default_rng(bucket)
    toks = np.zeros((2, bucket), np.int32)
    toks[:, :true_len] = rng.integers(0, jc.vocab_size, (2, true_len))
    want, _, _ = jm.forward(jc, jp, {"tokens": jnp.asarray(toks)},
                            mode="prefill")
    got, kv = tm.forward(tc, tp, torch.from_numpy(toks), want_kv=True)
    _close(got, want)
    assert len(kv) == tc.num_layers
    assert tuple(kv[0][0].shape) == (2, bucket, 2, tc.resolved_head_dim)
    # the engine's prefill step: logits at the last TRUE token only
    tok, last, _ = te.paged_prefill_step(tc, tp, torch.from_numpy(toks[:1]),
                                         true_len)
    jtok, jlast, _ = je.paged_prefill_step(
        jc, jp, {"tokens": jnp.asarray(toks[:1])}, true_len)
    _close(last, jlast)
    assert int(tok[0]) == int(jtok[0])


@pytest.mark.parametrize("s", [1, 4])
def test_paged_decode_logits_match_jax(setup, s):
    """Slot 0 holds a 21-token prompt in pages 3 and 5; slot 1 is released
    (its row on trash page 0, position 0). Three decode steps of S tokens
    through both packages' page tables."""
    jc, tc, jp, tp = setup
    ps, n_pool, max_pages, plen = 16, 8, 4, 21
    rng = np.random.default_rng(s)
    prompt = np.zeros((1, 32), np.int32)
    prompt[0, :plen] = rng.integers(0, jc.vocab_size, plen)
    pages = np.array([3, 5], np.int32)

    _, _, lin = je.paged_prefill_step(jc, jp, {"tokens": jnp.asarray(prompt)},
                                      plen)
    jcache = jm.init_paged_cache(jc, 2, n_pool, ps, max_pages)
    jcache = je.pages_insert(jcache, lin, jnp.asarray(pages), 0, plen)
    jcache = je.page_table_append(jcache, 0, 2, 6)

    _, _, kv = te.paged_prefill_step(tc, tp, torch.from_numpy(prompt), plen)
    tcache = tm.init_paged_cache(tc, 2, n_pool, ps, max_pages, device="cpu")
    te.pages_insert(tcache, kv, torch.from_numpy(pages).long(), 0, plen)
    te.page_table_append(tcache, 0, 2, 6)

    for step in range(3):
        toks = rng.integers(0, jc.vocab_size, (2, s)).astype(np.int32)
        want, jcache = jm.decode_step(jc, jp, jcache,
                                      {"tokens": jnp.asarray(toks)})
        got = tm.decode_step(tc, tp, tcache, torch.from_numpy(toks))
        _close(got, want)
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
    np.testing.assert_array_equal(tcache["page_table"].numpy(),
                                  np.asarray(jcache["page_table"]))
    # the written pages agree too (page 0, the trash page, takes the
    # released slot's writes in both)
    for layer, r in zip(tcache["layers"], range(tc.num_layers)):
        _close(layer["k"], jcache["body"][0]["k"][r])


def test_paged_cache_is_zero_filled_and_cuda_needs_a_card():
    cfg = dataclasses.replace(torch_config("granite-8b").reduced(),
                              num_kv_heads=2)
    cache = tm.init_paged_cache(cfg, 3, 5, 16, 2, device="cpu")
    assert all(bool((c[n] == 0).all()) for c in cache["layers"]
               for n in ("k", "v"))
    assert tuple(cache["layers"][0]["k"].shape) == (5, 16, 2, 32)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_paged_cache(cfg, 3, 5, 16, 2)
