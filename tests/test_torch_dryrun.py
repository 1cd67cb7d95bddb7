"""The port's dry run (``repro_torch.launch.specs``, ``launch.dryrun``) and
``parallel_block`` against the JAX package's.

``specs.input_specs`` / ``decode_cache_specs`` / ``opt_state_specs`` on
the meta device must give the reference's ``ShapeDtypeStruct`` trees
leaf for leaf (shapes and dtypes) for every arch and each of its
applicable shapes (the reference's scanned body unstacked per layer, as
``models/convert.py`` unstacks weights); ``dryrun.sharded_bytes`` must
equal the reference's ``sharded_bytes`` on the same specs over a
stand-in mesh; the FLOPs the dry run counts for reduced granite must
equal a closed-form count, on one card and over 2 shards (where every
shard runs the whole _ROW products); ``parallel_block`` must match the
JAX ``apply_block`` under ``sharding_hints(opts={"parallel_block"})``
within the JAX suite's tolerance (``tests/test_perf_levers.py``)."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs as jax_all_configs
from repro.configs import applicable_shapes as jax_applicable
from repro.configs import get_config as jax_config
from repro.core.simd import sharding as jsh
from repro.launch import specs as jspecs
from repro.launch.mesh import make_local_mesh as jax_local_mesh
from repro.models import model as jmodel
from repro.util import sharding_hints
from repro_torch.configs import get_config as torch_config
from repro_torch.configs.base import get_shape
from repro_torch.core.hardware import Chip
from repro_torch.core.simd import sharding as tsh
from repro_torch.launch import dryrun, specs
from repro_torch.models import layers as L
from repro_torch.models import model as tmodel
from repro_torch.models import param_count_tree
from repro_torch.models.blocks import apply_block as t_apply_block

torch.set_num_threads(2)

ARCHS = sorted(n for n, c in jax_all_configs().items()
               if hasattr(c, "num_layers"))


class FakeMesh:
    """Axis names and a device array's shape: all either package's rules
    and ``sharded_bytes`` read of a mesh."""

    axis_names = ("data", "model")

    def __init__(self, data, model):
        self.devices = np.empty((data, model))


def _sds(t):
    return (tuple(t.shape), str(t.dtype).replace("torch.", ""))


def _jsds(x):
    return (tuple(x.shape), str(jnp.dtype(x.dtype)))


def _unstack(cfg, jtree, f):
    """The reference's {"body", "tail", ...} tree as the port's
    {"layers": [...], ...}, with ``f`` of each leaf (the body's layer
    axis dropped)."""
    pattern, n_repeat, _ = jmodel.block_program(cfg)
    body = jax.tree.map(lambda x: f(jax.ShapeDtypeStruct(x.shape[1:],
                                                         x.dtype)),
                        jtree["body"])
    out = {k: jax.tree.map(f, v) for k, v in jtree.items()
           if k not in ("body", "tail")}
    out["layers"] = [body[j] for _ in range(n_repeat)
                     for j in range(len(pattern))] + [
        jax.tree.map(f, t) for t in jtree["tail"]]
    return out


def _tmap(tree):
    return jax.tree.map(_sds, tree, is_leaf=lambda x: isinstance(
        x, torch.Tensor))


@pytest.mark.parametrize("name", ARCHS)
def test_specs_match_the_references(name):
    """Every applicable shape's batch and decode cache, and the AdamW
    state of the params, leaf for leaf."""
    jc, tc = jax_config(name), torch_config(name)
    for shape in jax_applicable(jc):
        tshape = get_shape(shape.name)
        got = _tmap(specs.input_specs(tc, tshape))
        want = jax.tree.map(_jsds, jspecs.input_specs(jc, shape))
        assert got == want, shape.name
        if shape.kind == "decode":
            assert specs.decode_window(tc, shape.seq_len) == \
                jspecs.decode_window(jc, shape.seq_len)
            for kv in ("", "int8"):
                if kv and not tmodel.paged_ok(tc):
                    continue
                got = _tmap(specs.decode_cache_specs(tc, tshape, kv))
                jcache = jspecs.decode_cache_specs(jc, shape, kv)
                want = _unstack(jc, jcache, _jsds)
                assert got == want, (shape.name, kv)
    tp = tmodel.param_specs(tc)
    topt = specs.opt_state_specs(tc, tp)
    jopt = jspecs.opt_state_specs(jc, jmodel.param_specs(jc))
    assert _sds(topt.step) == _jsds(jopt.step)
    for field in ("master", "m", "v"):
        assert _tmap(getattr(topt, field)) == _unstack(
            jc, getattr(jopt, field), _jsds)
    assert param_count_tree(tp) == jmodel.param_count_tree(
        jmodel.param_specs(jc))


def _jax_sharded_bytes():
    """The reference's ``sharded_bytes``, imported with the process's
    XLA flags as they were (its module asks for 512 host devices, which
    must not reach a backend the suite shares)."""
    jax.devices()
    flags = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import sharded_bytes
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    return sharded_bytes


@pytest.mark.parametrize("name", ["granite-8b", "grok-1-314b",
                                  "recurrentgemma-9b", "mamba2-1.3b",
                                  "qwen2-vl-7b"])
def test_sharded_bytes_match_the_references(name):
    """Params, the AdamW state, every shape's batch and the decode cache
    under ``make_policy`` (the reference's TPU constants) on (16, 16)
    and (2, 4) stand-in meshes: the same bytes per device."""
    jbytes = _jax_sharded_bytes()
    from repro.core.hardware import TPU_V5E

    tpu = Chip(**dataclasses.asdict(TPU_V5E))
    jc, tc = jax_config(name), torch_config(name)
    tparams, jparams = tmodel.param_specs(tc), jmodel.param_specs(jc)
    topt = specs.opt_state_specs(tc, tparams)
    jopt = jspecs.opt_state_specs(jc, jparams)
    for shape in ((16, 16), (2, 4)):
        mesh = FakeMesh(*shape)
        tpol, jpol = tsh.make_policy(tc, mesh, chip=tpu), \
            jsh.make_policy(jc, mesh)
        pairs = [((tparams, tsh.param_pspecs(tc, tparams, tpol)),
                  (jparams, jsh.param_pspecs(jc, jparams, jpol))),
                 ((topt, tsh.opt_pspecs(tc, topt, tpol)),
                  (jopt, jsh.opt_pspecs(jc, jopt, jpol)))]
        for s in jax_applicable(jc):
            tb, jb = specs.input_specs(tc, get_shape(s.name)), \
                jspecs.input_specs(jc, s)
            pairs.append(((tb, tsh.batch_pspecs(tc, tb, tpol, mesh)),
                          (jb, jsh.batch_pspecs(jc, jb, jpol, mesh))))
            if s.kind == "decode":
                tcache = specs.decode_cache_specs(tc, get_shape(s.name))
                jcache = jspecs.decode_cache_specs(jc, s)
                pairs.append(
                    ((tcache, tsh.cache_pspecs(tc, tcache, tpol, mesh)),
                     (jcache, jsh.cache_pspecs(jc, jcache, jpol, mesh))))
        for (tt, ts_), (jt, js_) in pairs:
            got = dryrun.sharded_bytes(tt, ts_, mesh)
            want = jbytes(jt, js_, mesh)
            assert got == pytest.approx(want, rel=1e-12, abs=0.0)


def _granite_flops(cfg, b, w, tp):
    """Closed form of a decode step's counted FLOPs (matmuls and the
    float32 decode attention's two einsums over the whole ring): per
    layer the q, k, v and gate / up column blocks (which add up to the
    whole products over the shards), the whole ``wo`` and ``w_down`` on
    each of the tp shards, attention over W rows; the lm head's vocab
    blocks."""
    d, hd, h, kv = (cfg.d_model, cfg.resolved_head_dim, cfg.num_heads,
                    cfg.num_kv_heads)
    ff, v, n = cfg.d_ff, cfg.vocab_size, cfg.num_layers
    per_layer = (2 * b * d * (h + 2 * kv) * hd + tp * 2 * b * h * hd * d
                 + 2 * b * d * 2 * ff + tp * 2 * b * ff * d
                 + 2 * 2 * b * h * hd * w)
    return n * per_layer + 2 * b * d * v


@pytest.mark.parametrize("tp", [1, 2])
def test_dryrun_flops_match_the_closed_form(tp, tmp_path):
    """Reduced granite at ``decode_32k`` (128 slots over rings of 32768),
    on one card and over 2 shards; the record lands in ``--out``."""
    cfg = torch_config("granite-8b").reduced()
    rec = dryrun.run_one("granite-8b", "decode_32k", tp=tp, reduced=True,
                         out_dir=str(tmp_path))
    assert rec["flops"] == _granite_flops(cfg, 128, 32768, tp)
    assert rec["count"] == ("one card" if tp == 1 else "sharded forward")
    assert (rec["gathered_bytes_per_device"] is None) == (tp == 1)
    if tp == 2:
        assert rec["gathered_bytes_per_device"] > 0
    saved = json.loads((tmp_path / f"granite-8b__decode_32k__dp1_tp{tp}"
                                   f"__reduced.json").read_text())
    assert saved["flops"] == rec["flops"]


def test_dryrun_cli_prints_bytes_flops_and_gathers(capsys, tmp_path):
    """``--arch granite-8b --shape decode_32k --dp 2 --tp 2 --reduced``
    with no GPU: per-device bytes, FLOPs and gathered bytes; an unknown
    lever is refused with the levers the dry run takes."""
    assert dryrun.main(["--arch", "granite-8b", "--shape", "decode_32k",
                        "--dp", "2", "--tp", "2", "--reduced", "--out",
                        str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "[ok]" in out and "arg/dev=" in out and "flops=" in out
    assert "gathered/dev=" in out and "(sharded forward)" in out
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "granite-8b", "--shape", "decode_32k",
                     "--opt", "attn_carry", "--out", str(tmp_path)])
    assert "no PyTorch counterpart" in capsys.readouterr().err


def test_parallel_block_matches_the_references():
    """``apply_block(..., parallel_block=True)`` against the JAX block
    under the lever's hint (train mode, the reference's B 2 x S 32 on
    reduced granite), atol 1e-4 / rtol 1e-3 as ``test_perf_levers``."""
    from repro.models.blocks import apply_block as j_apply_block
    from repro.models.blocks import init_block as j_init_block

    jc = jax_config("granite-8b").reduced()
    tc = torch_config("granite-8b").reduced()
    b, s = 2, 32
    jp = j_init_block(jc, "dense", jax.random.key(3), jnp.float32)
    x = jax.random.normal(jax.random.key(4), (b, s, jc.d_model))
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
    with jax_local_mesh(), sharding_hints(
            opts=frozenset({"parallel_block"}), batch_div=1):
        want, _, _ = j_apply_block(jc, "dense", jp, x, pos, mode="train",
                                   cache=None, pos=jnp.zeros((), jnp.int32))
    # the dense block's leaves have the port's names and orientation
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    rope = L.rope_table(tc, torch.arange(s)[None].expand(b, s))
    got, _, _ = t_apply_block(tc, "dense", tp,
                              torch.from_numpy(np.array(x)), rope,
                              mode="train", parallel_block=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-3)
    plain, _, _ = t_apply_block(tc, "dense", tp,
                                torch.from_numpy(np.array(x)), rope,
                                mode="train")
    assert not torch.allclose(plain, got, atol=1e-4)


def test_parallel_block_through_forward_and_train_step():
    """The option reaches every layer through ``forward`` (prefill and
    train modes) and ``train_step``; int8 weight leaves and MoE blocks
    keep the unfused path."""
    from repro_torch.models import quantize_weights
    from repro_torch.training import init_adamw, train_step

    tc = torch_config("granite-8b").reduced()
    params = tmodel.init_params(tc, 0, "cpu")
    toks = torch.randint(0, 100, (2, 16))
    a, _ = tmodel.forward(tc, params, toks)
    b, _ = tmodel.forward(tc, params, toks, parallel_block=True)
    assert not torch.allclose(a, b)
    q8 = quantize_weights(tc, params)
    c, _ = tmodel.forward(tc, q8, toks)
    d, _ = tmodel.forward(tc, q8, toks, parallel_block=True)
    assert torch.equal(c, d)
    moe = torch_config("grok-1-314b").reduced()  # every layer a MoE block
    mp = tmodel.init_params(moe, 0, "cpu")
    e, _ = tmodel.forward(moe, mp, toks)
    f, _ = tmodel.forward(moe, mp, toks, parallel_block=True)
    assert torch.equal(e, f)
    batch = {"tokens": toks, "labels": toks}
    _, _, m1 = train_step(tc, params, init_adamw(params), batch)
    _, _, m2 = train_step(tc, params, init_adamw(params), batch,
                          parallel_block=True)
    assert float(m1["loss"]) != float(m2["loss"])
