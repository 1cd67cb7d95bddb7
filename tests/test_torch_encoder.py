"""The encoder-only family of the port (hubert-xlarge: bidirectional
``encoder`` blocks over precomputed frame embeddings, no token embedding)
against the JAX package, on the CPU in float32: logits of the reduced
config in train and prefill modes, and with 4 heads of 80 (hubert's own
head_dim, which the flash kernel instantiates for it), at 2e-5; the
plain non-causal attention at 16 heads of 80 against the reference's
``layers.attention`` at 2e-5 (float32) and 2e-2 (bfloat16, the reference
suite's tolerances); the config, the registry and the refusals."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro import models as jm
from repro.models import layers as jl
from repro_torch import configs as tcfg
from repro_torch import models as tm
from repro_torch import serving as ts
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.tree import flatten

torch.set_num_threads(2)

TOL = 2e-5
HEAD_80 = dict(num_heads=4, num_kv_heads=4, head_dim=80)


def _pair(change):
    jc = dataclasses.replace(jcfg.get_config("hubert-xlarge").reduced(),
                             **change)
    tc = dataclasses.replace(tcfg.get_config("hubert-xlarge").reduced(),
                             **change)
    jp = jm.init_params(jc, jax.random.key(0))
    return jc, tc, jp, tm.params_from_jax(tc, jax.tree.map(np.asarray, jp),
                                          "cpu")


@pytest.mark.parametrize("change", [{}, HEAD_80], ids=["reduced", "hd80"])
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_logits_match_jax(change, mode):
    jc, tc, jp, tp = _pair(change)
    frames = np.random.default_rng(1).standard_normal(
        (2, 40, jc.d_model)).astype(np.float32)
    want, want_aux, _ = jm.forward(jc, jp, {"frames": jnp.asarray(frames)},
                                   mode=mode)
    if mode == "train":
        got, aux = tm.forward(tc, tp, torch.from_numpy(frames), mode="train")
        assert float(aux) == float(want_aux) == 0.0
    else:
        got, _ = tm.forward(tc, tp, torch.from_numpy(frames))
    assert got.shape == (2, 40, jc.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [64, 100])
def test_noncausal_attention_at_head_dim_80_matches_jax(dtype, s):
    rng = np.random.default_rng(s)
    q, k, v = (rng.standard_normal((2, s, 16, 80)).astype(np.float32)
               for _ in range(3))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jl.attention(*(jnp.asarray(t, jdt) for t in (q, k, v)),
                        causal=False)
    got = ops.flash_attention(*(torch.from_numpy(t).to(tdt)
                                for t in (q, k, v)), causal=False)
    assert got.dtype == tdt
    tol = TOL if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_config_and_registry_match_the_reference():
    tc, jc = tcfg.get_config("hubert-xlarge"), jcfg.get_config(
        "hubert-xlarge")
    assert tcfg.reference_view(tc) == dataclasses.asdict(jc)
    assert tc.param_count() == jc.param_count()
    assert tcfg.reference_view(tc.reduced()) == dataclasses.asdict(
        jc.reduced())
    assert (tc.num_layers, tc.d_model, tc.num_heads, tc.num_kv_heads,
            tc.d_ff, tc.vocab_size) == (48, 1280, 16, 16, 5120, 504)
    assert tc.resolved_head_dim == 80 and not tc.causal and tc.is_encoder
    mine, theirs = tcfg.all_configs(), jcfg.all_configs()
    assert list(mine) == list(theirs)
    for name in theirs:
        assert tcfg.reference_view(mine[name]) == dataclasses.asdict(
            theirs[name])
    shapes = [s.name for s in tcfg.applicable_shapes(tc)]
    assert shapes == [s.name for s in jcfg.applicable_shapes(jc)]
    assert "decode_32k" not in shapes and "long_500k" not in shapes


def test_serving_refuses_the_encoder():
    tc = tcfg.get_config("hubert-xlarge")
    with pytest.raises(SystemExit, match="encoder-only arch: no "
                       "autoregressive serving"):
        tserve.main(["--arch", "hubert-xlarge", "--reduced", "--device",
                     "cpu"])
    with pytest.raises(ValueError, match="encoder-only arch"):
        ts.EngineConfig().validate(tc)


def test_params_from_jax_takes_the_audio_tree():
    jc, tc, jp, tp = _pair({})
    assert "embed" not in jp and "embed" not in tp
    mine = tm.init_params(tc, seed=0, device="cpu")
    assert {k: (tuple(t.shape), t.dtype) for k, t in flatten(mine)} == \
        {k: (tuple(t.shape), t.dtype) for k, t in flatten(tp)}
    assert tm.layer_types(tc) == ["encoder"] * tc.num_layers
    body = jax.tree.map(np.asarray, jp["body"][0])
    for r, layer in enumerate(tp["layers"]):
        np.testing.assert_array_equal(layer["attn"]["wq"].numpy(),
                                      body["attn"]["wq"][r])
    # gradients carry across the same way: every leaf's path matches
    grads = jax.grad(lambda p: jm.forward(jc, p, {"frames": jnp.ones(
        (1, 8, jc.d_model))})[0].sum())(jp)
    tg = tm.params_from_jax(tc, jax.tree.map(np.asarray, grads), "cpu")
    assert [k for k, _ in flatten(tg)] == [k for k, _ in flatten(tp)]
