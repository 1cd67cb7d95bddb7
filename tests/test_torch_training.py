"""The port's training path (``repro_torch.training``, the train CLI and
the ``train_lm`` example) against the JAX package's, on the CPU in
float32, at the reduced configs, on the same converted weights and the
same numpy batches.

Tolerances: the optimizer arithmetic 1e-6 relative to each leaf's
largest value (the same float32 operations in the same order; an
element where b1 m and (1 - b1) g cancel keeps only its absolute
error); losses 2e-5; gradients atol 1e-4 / rtol
1e-3, the reference suite's own (``tests/test_training.py``); params
after two ``train_step``s 2e-5 absolute: the normalized AdamW update
m/(sqrt(v) + eps) is bounded by 1, and a gradient within float noise of
zero may take either sign, so each step can move a param by at most
2 lr (lr 3e-6 and 6e-6 at steps 1 and 2 of the default warm-up), 1.8e-5
over both. The reference's ``train_step`` is run as its three parts
(``grads_fn``, ``adamw_update``, ``cast_params``), each jitted once, so
the file stays within about 90 s."""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro import training as jt
from repro.configs import get_config as jax_config
from repro.configs import get_shape as jax_shape
from repro.training import optimizer as jopt
from repro_torch import models as tm
from repro_torch import training as tt
from repro_torch.configs import get_config as torch_config
from repro_torch.configs import get_shape
from repro_torch.examples import train_lm
from repro_torch.launch import train as ttrain
from repro_torch.training import optimizer as topt
from repro_torch.tree import flatten

torch.set_num_threads(2)

ARCHS = ["granite-8b", "chatglm3-6b", "qwen2-vl-7b", "grok-1-314b",
         "recurrentgemma-9b", "mamba2-1.3b", "hubert-xlarge"]
LOSS_TOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3
PARAM_TOL = 2e-5
B, S, P = 4, 16, 4  # batch, sequence, qwen2-vl's patches


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, seed=0):
    """A numpy batch of cfg's modality with a few labels masked (-100);
    qwen2-vl also gets patches ahead of its tokens and (3, B, P + S)
    positions."""
    rng = np.random.default_rng(seed)
    if cfg.modality == "audio":
        nb = {"frames": rng.standard_normal((B, S, cfg.d_model))
              .astype(np.float32)}
    else:
        nb = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
              .astype(np.int32)}
    nb["labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    nb["labels"][0, :3] = -100
    if cfg.modality == "vision_text":
        nb["patches"] = rng.standard_normal((B, P, cfg.d_model)) \
            .astype(np.float32)
        nb["positions"] = np.broadcast_to(
            np.arange(P + S, dtype=np.int32), (3, B, P + S)).copy()
    return nb


def _grads_close(got, want_tree, tc):
    want = tm.params_from_jax(tc, _np(want_tree), "cpu")
    got, want = flatten(got), flatten(want)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=k)


@pytest.fixture(scope="module")
def jax_update():
    return jax.jit(jopt.adamw_update)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_and_train_steps_match_jax(arch, jax_update):
    jc, tc = jax_config(arch).reduced(), torch_config(arch).reduced()
    jp = jax.jit(jm.init_params, static_argnums=0)(jc, jax.random.key(0))
    tp = tm.params_from_jax(tc, _np(jp), "cpu")
    nb = _batch(tc)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}

    jl, (jce, jaux) = jax.jit(functools.partial(jt.loss_fn, jc))(jp, jb)
    loss, (ce, aux) = tt.loss_fn(tc, tp, tb)
    for got, want in ((loss, jl), (ce, jce), (aux, jaux)):
        assert float(got) == pytest.approx(float(want), abs=LOSS_TOL)
    if tc.arch_type == "moe":
        assert float(aux) > 0  # the Switch term is on the loss

    grads_1 = jax.jit(functools.partial(jt.grads_fn, jc, accum=1))
    for accum in (1, 2):
        fn = grads_1 if accum == 1 else jax.jit(
            functools.partial(jt.grads_fn, jc, accum=accum))
        jl, jce, jg = fn(jp, jb)
        loss, ce, grads = tt.grads_fn(tc, tp, tb, accum=accum)
        assert float(loss) == pytest.approx(float(jl), abs=LOSS_TOL)
        assert float(ce) == pytest.approx(float(jce), abs=LOSS_TOL)
        _grads_close(grads, jg, tc)
        # every float leaf gets a gradient
        for k, g in flatten(grads):
            assert bool((g != 0).any()), k

    jo, to = jt.init_adamw(jp), tt.init_adamw(tp)
    for _ in range(2):
        jl, _, jg = grads_1(jp, jb)
        jo, jgn = jax_update(jo, jg)
        jp = jopt.cast_params(jo, jp)
        tp, to, m = tt.train_step(tc, tp, to, tb)
        assert float(m["loss"]) == pytest.approx(float(jl), abs=LOSS_TOL)
        assert float(m["grad_norm"]) == pytest.approx(float(jgn),
                                                      rel=GRAD_RTOL)
    assert int(to.step) == int(jo.step) == 2
    want = flatten(tm.params_from_jax(tc, _np(jp), "cpu"))
    for (k, a), (_, w) in zip(flatten(tp), want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=PARAM_TOL,
                                   rtol=0, err_msg=k)


def test_cosine_schedule_and_adamw_match_jax():
    for step in (0, 1, 7, 10, 55, 100, 120):
        got = topt.cosine_schedule(torch.tensor(step), peak_lr=1.0,
                                   warmup=10, total=100)
        want = jopt.cosine_schedule(jnp.asarray(step), peak_lr=1.0,
                                    warmup=10, total=100)
        assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-9)
    rng = np.random.default_rng(3)
    shapes = {"a": (5, 3), "b": [(7,), (2, 2, 4)]}
    tree = {"a": rng.standard_normal(shapes["a"]).astype(np.float32),
            "b": [rng.standard_normal(s).astype(np.float32)
                  for s in shapes["b"]]}
    jstate = jopt.init_adamw(jax.tree.map(jnp.asarray, tree))
    tstate = topt.init_adamw(jax.tree.map(torch.from_numpy, tree))
    for i, scale in enumerate((1e-3, 1.0, 50.0)):  # the last one clips
        g = jax.tree.map(lambda x, i=i: (x * scale + i).astype(np.float32),
                         tree)
        jstate, jgn = jopt.adamw_update(jstate, jax.tree.map(jnp.asarray, g),
                                        warmup=2, total=5)
        tstate, tgn = topt.adamw_update(tstate, jax.tree.map(
            torch.from_numpy, g), warmup=2, total=5)
        assert float(tgn) == pytest.approx(float(jgn), rel=1e-6)
        for name in ("master", "m", "v"):
            for a, w in zip(jax.tree.leaves(_np(getattr(jstate, name))),
                            [t.numpy() for _, t in
                             flatten(getattr(tstate, name))]):
                # relative to the leaf's largest value: m's b1 m + (1 -
                # b1) g cancels, so an element's own scale can be ulps
                np.testing.assert_allclose(
                    w, a, rtol=0, atol=1e-6 * np.abs(a).max())
    assert tstate.step.dtype == torch.int32 and int(tstate.step) == 3
    like = jax.tree.map(lambda x: torch.from_numpy(x).bfloat16(), tree)
    cast = topt.cast_params(tstate, like)
    assert all(t.dtype == torch.bfloat16 for _, t in flatten(cast))


def test_pipeline_and_synthetic_batches_match_jax():
    jpipe = jt.TokenPipeline(512, 40, 3, seed=7)
    tpipe = tt.TokenPipeline(512, 40, 3, seed=7)
    for start in (0, 5):
        for _, (jb, tb) in zip(range(2), zip(jpipe.batches(start),
                                             tpipe.batches(start))):
            assert jb.keys() == tb.keys()
            for k in jb:
                np.testing.assert_array_equal(tb[k], jb[k])
                assert tb[k].dtype == jb[k].dtype
    shape = dataclasses.replace(get_shape("train_4k"), seq_len=24,
                                global_batch=2)
    jshape = dataclasses.replace(jax_shape("train_4k"), seq_len=24,
                                 global_batch=2)
    for arch in ("granite-8b", "hubert-xlarge", "qwen2-vl-7b"):
        tb = tt.synthetic_batch(torch_config(arch),
                                shape, np.random.default_rng(1))
        jb = jt.synthetic_batch(jax_config(arch), jshape,
                                np.random.default_rng(1))
        assert tb.keys() == jb.keys()
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])
            assert tb[k].dtype == jb[k].dtype


def test_checkpoint_roundtrip_with_opt_state_is_bit_exact(tmp_path):
    cfg = dataclasses.replace(torch_config("granite-8b").reduced(),
                              dtype="bfloat16")
    params = tm.init_params(cfg, seed=0, device="cpu")
    opt = tt.init_adamw(params)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(v) for k, v in
             tt.synthetic_batch(cfg, dataclasses.replace(
                 get_shape("train_4k"), seq_len=16, global_batch=2),
                 rng).items()}
    params, opt, _ = tt.train_step(cfg, params, opt, batch)
    d = str(tmp_path / "ck")
    assert tt.latest_step(d) == -1
    tt.save_checkpoint(d, 7, params, opt, extra={"arch": cfg.name})
    assert tt.latest_step(d) == 7
    r = tt.restore_into(d, 7, params)
    ro = tt.restore_into(d, 7, tt.init_adamw(params), opt=True)
    for tree, want in ((r, params), (ro, opt)):
        for (k, a), (_, w) in zip(flatten(tree), flatten(want)):
            assert a.dtype == w.dtype and torch.equal(a, w), k
    assert int(ro.step) == 1
    assert any(t.dtype == torch.bfloat16 for _, t in flatten(r))
    small = tm.init_params(dataclasses.replace(cfg, d_ff=64), seed=0,
                           device="cpu")
    with pytest.raises(ValueError, match="the template"):
        tt.restore_into(d, 7, small)


def test_grad_accum_equivalence():
    cfg = torch_config("granite-8b").reduced()
    params = tm.init_params(cfg, seed=0, device="cpu")
    nb = _batch(cfg, seed=1)
    nb["labels"][0, :3] = 1  # none masked: each microbatch counts alike
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    l1, _, g1 = tt.grads_fn(cfg, params, batch, accum=1)
    l2, _, g2 = tt.grads_fn(cfg, params, batch, accum=2)
    assert abs(float(l1) - float(l2)) < 1e-4
    for (k, a), (_, b) in zip(flatten(g1), flatten(g2)):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4,
                                   rtol=1e-3, err_msg=k)
    with pytest.raises(ValueError, match="microbatches"):
        tt.grads_fn(cfg, params, batch, accum=3)


def test_loss_decreases_on_structured_data():
    cfg = torch_config("chatglm3-6b").reduced()
    params = tm.init_params(cfg, seed=0, device="cpu")
    opt = tt.init_adamw(params)
    pipe = tt.TokenPipeline(cfg.vocab_size, 32, 8, seed=1)
    losses = []
    for i, batch in enumerate(pipe.batches()):
        if i >= 30:
            break
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        params, opt, m = tt.train_step(cfg, params, opt, batch,
                                       peak_lr=1e-3, total_steps=40)
        losses.append(float(m["ce"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1


def test_vlm_loss_masks_patch_prefix():
    cfg = torch_config("qwen2-vl-7b").reduced()
    params = tm.init_params(cfg, seed=0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    loss, (ce, aux) = tt.loss_fn(cfg, params, batch)
    assert float(loss) > 0 and not np.isnan(float(loss))
    # the patch prefix carries no labels: masking every text label
    # leaves nothing to predict
    batch["labels"] = torch.full_like(batch["labels"], -100)
    _, (ce, _) = tt.loss_fn(cfg, params, batch)
    assert float(ce) == 0.0


def test_train_cli_resumes_from_its_checkpoint(tmp_path, capsys):
    base = ["--arch", "granite-8b", "--reduced", "--device", "cpu"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    ttrain.main(base + ["--steps", "3", "--ckpt", a])
    out = capsys.readouterr().out
    assert "step     0" in out and "done: ce" in out
    assert tt.latest_step(a) == 3
    ttrain.main(base + ["--steps", "5", "--ckpt", a])
    out = capsys.readouterr().out
    assert "restored step 3" in out and "step     3" not in out.split(
        "restored step 3")[0]
    # params and optimizer state both restored: the resumed run lands
    # where an uninterrupted one does. Restarting from the fresh master
    # copy (the reference's restore) would move every param by about the
    # three lost steps' lr, 1.8e-5; float order (the restored arrays'
    # alignment picks the CPU's matmul kernels) moves them by ~1e-10
    ttrain.main(base + ["--steps", "5", "--ckpt", b])
    capsys.readouterr()
    cfg = torch_config("granite-8b").reduced()
    like = tm.init_params(cfg, seed=0, device="cpu")
    for (k, x), (_, y) in zip(flatten(tt.restore_into(a, 5, like)),
                              flatten(tt.restore_into(b, 5, like))):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    with pytest.raises(SystemExit):
        ttrain.main(["--arch", "hubert-xlarge", "--reduced", "--device",
                     "cpu"])
    assert "audio arch takes frame embeddings" in capsys.readouterr().err


def test_train_lm_example_runs(tmp_path, capsys):
    ck = str(tmp_path / "lm")
    train_lm.main(["--steps", "2", "--batch", "2", "--seq", "16",
                   "--device", "cpu", "--ckpt", ck])
    out = capsys.readouterr().out
    assert "checkpoint restore verified" in out
    assert os.path.exists(os.path.join(ck, "params_2.npz"))
