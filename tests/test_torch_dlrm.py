"""The port's DLRM (``repro_torch.core.simd``) against the JAX package's:
the config field for field, ``dlrm_forward`` to 2e-5 in float32 on
weights carried over by ``dlrm_params_from_jax`` and its gradients to
``jax.grad``'s, ``lookup_traffic_bytes``, and the offload plan
(``zipf_hit_rate``, ``effective_bandwidth``, ``plan_offload``) at the
reference's bandwidths; the scale-out estimate of the
``distributed_inference`` twin against ``benchmarks/fig7_dlrm.py`` at the
reference's chip, and the twin run to its end on the CPU."""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import hardware as jhw
from repro.core.simd import embedding as jemb
from repro.core.simd import offload as joff
from repro_torch.configs import get_config as torch_config
from repro_torch.core import hardware as thw
from repro_torch.core.simd import embedding as temb
from repro_torch.core.simd import offload as toff
from repro_torch.examples import distributed_inference
from repro_torch.models import dlrm_params_from_jax

torch.set_num_threads(2)

TOL = 2e-5
REL = 1e-12


def _small(cfgs, **kw):
    return dataclasses.replace(
        cfgs("dlrm"), **{**dict(num_tables=6, rows_per_table=300,
                                embed_dim=16, bottom_mlp=(32, 16),
                                top_mlp=(64, 32, 1), multi_hot=3), **kw})


def _batch(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return {"dense": rng.standard_normal(
                (b, cfg.num_dense_features)).astype(np.float32),
            "sparse": rng.integers(0, cfg.rows_per_table,
                                   (b, cfg.num_tables, cfg.multi_hot)
                                   ).astype(np.int32)}


def test_config_matches_jax():
    tc, jc = torch_config("dlrm"), jax_config("dlrm")
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.param_count() == jc.param_count()
    assert tc.embedding_params() == jc.embedding_params()
    assert tc.mlp_params() == jc.mlp_params()


@pytest.mark.parametrize("kw", [{}, dict(num_tables=3, multi_hot=1),
                                dict(embed_dim=8, bottom_mlp=(8,))])
def test_forward_and_gradients_match_jax(kw):
    jc, tc = _small(jax_config, **kw), _small(torch_config, **kw)
    jp = jemb.init_dlrm(jc, jax.random.key(3))
    tp = dlrm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    batch = _batch(jc, 17, seed=len(kw))
    want = jemb.dlrm_forward(jc, jp, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = temb.dlrm_forward(tc, tp, tb)
    assert got.shape == (17,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)

    # gradients of a BCE-style loss against jax.grad, every leaf
    labels = np.random.default_rng(9).integers(0, 2, 17).astype(np.float32)

    def jloss(p):
        z = jemb.dlrm_forward(jc, p, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        return jnp.mean(jax.nn.softplus(z) - labels * z)

    jgrad = jax.tree.map(np.asarray, jax.grad(jloss)(jp))
    leaves = [tp["tables"]] + [t for layer in tp["bottom"] + tp["top"]
                               for t in (layer["w"], layer["b"])]
    for t in leaves:
        t.requires_grad_(True)
    z = temb.dlrm_forward(tc, tp, tb)
    loss = torch.mean(torch.nn.functional.softplus(z)
                      - torch.from_numpy(labels) * z)
    loss.backward()
    np.testing.assert_allclose(tp["tables"].grad.numpy(), jgrad["tables"],
                               atol=TOL, rtol=TOL)
    for part in ("bottom", "top"):
        for got_l, want_l in zip(tp[part], jgrad[part]):
            for name in ("w", "b"):
                np.testing.assert_allclose(got_l[name].grad.numpy(),
                                           want_l[name], atol=TOL, rtol=TOL)


def test_init_and_lookup():
    cfg = _small(torch_config)
    p = temb.init_dlrm(cfg, 5, "cpu")
    q = temb.init_dlrm(cfg, torch.Generator().manual_seed(5), "cpu")
    assert torch.equal(p["tables"], q["tables"])
    assert p["tables"].shape == (6, 300, 16)
    assert abs(float(p["tables"].std()) - 0.01) < 1e-3
    assert [tuple(l["w"].shape) for l in p["bottom"]] == [(13, 32), (32, 16)]
    assert [tuple(l["w"].shape) for l in p["top"]] == \
        [(16 + 21, 64), (64, 32), (32, 1)]
    assert sum(t.numel() for layer in p["bottom"] + p["top"]
               for t in layer.values()) == cfg.mlp_params()
    # multi-hot lookups: each table's rows summed, as a loop would
    sparse = torch.from_numpy(_batch(cfg, 4, seed=1)["sparse"])
    emb = temb.lookup(p["tables"], sparse)
    want = torch.stack([torch.stack([p["tables"][t, sparse[b, t]].sum(0)
                                     for t in range(cfg.num_tables)])
                        for b in range(4)])
    torch.testing.assert_close(emb, want, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="embed_dim"):
        temb.init_dlrm(dataclasses.replace(cfg, bottom_mlp=(32, 8)), 0,
                       "cpu")


def test_traffic_and_offload_match_jax():
    tc, jc = torch_config("dlrm"), jax_config("dlrm")
    for b in (1, 128, 2048):
        assert temb.lookup_traffic_bytes(tc, b) == \
            jemb.lookup_traffic_bytes(jc, b)
    # B 2048 reads 218 MB of rows
    assert temb.lookup_traffic_bytes(tc, 2048) == 2048 * 26 * 8 * 128 * 4
    assert toff.HBM_BW == thw.H100_SXM.hbm_bw == 3.35e12
    assert toff.HOST_BW == joff.HOST_BW
    rows = tc.num_tables * tc.rows_per_table
    for alpha in (0.8, 1.0, 1.05):
        # no cached row hits nothing (the reference's approximation is
        # negative or raises at 0)
        assert toff.zipf_hit_rate(0, rows, alpha) == 0.0
        for cache in (1, 1000, rows // 3, rows):
            assert toff.zipf_hit_rate(cache, rows, alpha) == pytest.approx(
                joff.zipf_hit_rate(cache, rows, alpha), rel=REL)
        for frac in (0.01, 0.2, 1.0):
            for cold in (joff.HOST_BW, joff.SSD_BW):
                assert toff.effective_bandwidth(
                    frac, rows, alpha, cold, hbm_bw=joff.HBM_BW) == \
                    pytest.approx(joff.effective_bandwidth(
                        frac, rows, alpha, cold), rel=REL)
        for budget in (512.0, 8e9, 0.5 * jhw.TPU_V5E.hbm_bytes, 1e12):
            got = toff.plan_offload(rows, 512, budget, alpha,
                                    hbm_bw=joff.HBM_BW)
            want = joff.plan_offload(rows, 512, budget, alpha)
            assert (got.hbm_rows, got.host_rows) == \
                (want.hbm_rows, want.host_rows)
            for name in ("hit_rate", "effective_bw", "slowdown_vs_hbm"):
                assert getattr(got, name) == pytest.approx(
                    getattr(want, name), rel=REL)
    # at the H100's own numbers: the port's defaults
    plan = toff.plan_offload(rows, 512, 40e9, 1.05)
    assert plan.slowdown_vs_hbm == pytest.approx(
        3.35e12 / plan.effective_bw, rel=REL)
    # nothing on the card: every row comes over the host link
    plan = toff.plan_offload(rows, 512, 0.0)
    assert (plan.hbm_rows, plan.hit_rate) == (0, 0.0)
    assert plan.effective_bw == pytest.approx(toff.HOST_BW, rel=REL)


def test_scale_out_estimate_matches_fig7():
    root = os.path.join(os.path.dirname(__file__), "..")
    sys.path.insert(0, root)
    try:
        from benchmarks.fig7_dlrm import scale_out_estimate
    finally:
        sys.path.remove(root)
    tpu = thw.Chip(**dataclasses.asdict(jhw.TPU_V5E))
    for n in (1, 2, 4, 8, 16, 32, 64):
        got = distributed_inference.scale_out_estimate(n, chip=tpu)
        want = scale_out_estimate(n)
        assert got["fits"] == want["fits"]
        for k in ("latency_s", "comm_share"):
            assert got[k] == pytest.approx(want[k], rel=REL)
    # one H100 (80 GB) does not hold the 133 GB of tables; four do
    assert not distributed_inference.scale_out_estimate(1)["fits"]
    assert distributed_inference.scale_out_estimate(4)["fits"]


def test_distributed_inference_twin_runs(capsys):
    distributed_inference.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "batch=64 -> logits (64,)" in out
    assert "133 GB of embeddings (26 tables x 10,000,000 rows)" in out
    assert out.count("nodes=") == 4


def test_serve_cli_refuses_dlrm(capsys):
    from repro_torch.launch import serve

    with pytest.raises(SystemExit):
        serve.main(["--arch", "dlrm", "--device", "cpu"])
    assert "not a language model" in capsys.readouterr().err
