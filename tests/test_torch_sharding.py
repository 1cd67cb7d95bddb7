"""The port's sharding rules (``repro_torch.core.simd.sharding``) against
the JAX package's, without engines: ``param_pspecs``, ``opt_pspecs``,
``batch_pspecs``, ``cache_pspecs`` and ``paged_cache_pspecs`` on the
port's meta-device ``param_specs`` / ``cache_specs`` must equal the
reference's specs on its ``ShapeDtypeStruct`` trees, for every assigned
arch at full size, under ``serving_policy`` on (1, 2), (1, 4) and (1, 8)
meshes and ``make_policy`` on a fake (16, 16) and (1, 4) mesh at the
reference's TPU constants. The reference stacks scanned layers behind a
leading axis (``"body"``); its specs are unstacked per layer (the leading
entry dropped) the way ``models/convert.py`` unstacks weights. Also
DLRM's ``shard_specs`` / ``batch_specs``, placement by ``place``, and
the local mesh's refusal of more cards than the host has."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import all_configs as jax_all_configs
from repro.configs import get_config as jax_config
from repro.core.hardware import TPU_V5E
from repro.core.simd import embedding as jemb
from repro.core.simd import sharding as jsh
from repro.models import model as jmodel
from repro.training import optimizer as jopt
from repro_torch.configs import get_config as torch_config
from repro_torch.core.hardware import Chip
from repro_torch.core.simd import embedding as temb
from repro_torch.core.simd import sharding as tsh
from repro_torch.launch.mesh import make_local_mesh, make_serving_mesh
from repro_torch.models import model as tmodel
from repro_torch.serving import DeviceTopology
from repro_torch.training.optimizer import AdamWState

torch.set_num_threads(2)

ARCHS = sorted(n for n, c in jax_all_configs().items()
               if hasattr(c, "num_layers"))
#: archs with a decode cache (not the encoder), and those that can page
CACHED = [n for n in ARCHS if not torch_config(n).is_encoder]
PAGED = [n for n in CACHED if tmodel.paged_ok(torch_config(n))]
TPU = Chip(**dataclasses.asdict(TPU_V5E))


class FakeMesh:
    """What both packages' rules read of a mesh: axis names and a device
    array's shape (the reference suite's fake mesh)."""

    axis_names = ("data", "model")

    def __init__(self, data, model):
        self.devices = np.empty((data, model))


def _jspecs(tree):
    """A reference spec tree with each ``PartitionSpec`` as a tuple."""
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


def _unstack(cfg, jtree):
    """The reference's {"body", "tail", ...} spec tree as the port's
    {"layers": [...], ...}: body specs per repeat, the layer entry
    dropped."""
    pattern, n_repeat, _ = jmodel.block_program(cfg)
    drop = jax.tree.map(lambda s: s[1:], jtree["body"],
                        is_leaf=lambda x: isinstance(x, tuple))
    layers = [drop[j] for _ in range(n_repeat) for j in range(len(pattern))]
    out = {k: v for k, v in jtree.items() if k not in ("body", "tail")}
    out["layers"] = layers + list(jtree["tail"])
    return out


def _policies(name):
    """(port policy, reference policy, fake mesh) pairs: the serving
    profile over 2, 4 and 8 shards, and ``make_policy`` at (16, 16) and
    (1, 4) with the reference's HBM."""
    tc, jc = torch_config(name), jax_config(name)
    out = []
    for n in (2, 4, 8):
        m = FakeMesh(1, n)
        out.append((tsh.serving_policy(tc, m), jsh.serving_policy(jc, m), m))
    for shape in ((16, 16), (1, 4)):
        m = FakeMesh(*shape)
        out.append((tsh.make_policy(tc, m, chip=TPU),
                    jsh.make_policy(jc, m), m))
    return out


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    name = request.param
    tc, jc = torch_config(name), jax_config(name)
    return (name, tc, jc, tmodel.param_specs(tc), jmodel.param_specs(jc))


def test_policies_match(arch):
    name = arch[0]
    for tpol, jpol, _ in _policies(name):
        assert dataclasses.asdict(tpol) == dataclasses.asdict(jpol)


def test_param_specs_have_the_references_shapes(arch):
    name, tc, jc, tp, jp = arch
    pattern, n_repeat, _ = jmodel.block_program(jc)
    shape = lambda t: tuple(t.shape)  # noqa: E731
    got = jax.tree.map(shape, tp)
    for i, layer in enumerate(got["layers"]):
        if i < n_repeat * len(pattern):  # the body's layer axis dropped
            ref = jax.tree.map(lambda s: tuple(s.shape[1:]),
                               jp["body"][i % len(pattern)])
        else:
            ref = jax.tree.map(shape, jp["tail"][i - n_repeat
                                                 * len(pattern)])
        assert layer == ref
    for k in jp:
        if k not in ("body", "tail"):
            assert got[k] == jax.tree.map(shape, jp[k])
    assert all(t.device.type == "meta" for t in jax.tree.leaves(tp))


def test_param_and_opt_pspecs_match(arch):
    name, tc, jc, tp, jp = arch
    jopt_tree = jax.eval_shape(jopt.init_adamw, jp)
    topt = AdamWState(torch.zeros((), dtype=torch.int32, device="meta"),
                      tp, tp, tp)
    for tpol, jpol, _ in _policies(name):
        got = tsh.param_pspecs(tc, tp, tpol)
        assert got == _unstack(jc, _jspecs(jsh.param_pspecs(jc, jp, jpol)))
        jo = _jspecs(jsh.opt_pspecs(jc, jopt_tree, jpol))
        to = tsh.opt_pspecs(tc, topt, tpol)
        assert to.step == jo.step == ()
        for field in ("master", "m", "v"):
            assert getattr(to, field) == _unstack(jc, getattr(jo, field))


@pytest.mark.parametrize("name", CACHED)
def test_cache_pspecs_match(name):
    tc, jc = torch_config(name), jax_config(name)
    for kv_dtype in ("", "int8") if tmodel.paged_ok(tc) else ("",):
        tcache = tmodel.cache_specs(tc, 8, 1024, kv_dtype=kv_dtype)
        jcache = jmodel.cache_specs(jc, 8, 1024, kv_dtype=kv_dtype)
        for tpol, jpol, mesh in _policies(name):
            got = tsh.cache_pspecs(tc, tcache, tpol, mesh)
            want = _unstack(jc, _jspecs(jsh.cache_pspecs(jc, jcache, jpol,
                                                         mesh)))
            assert got == want


@pytest.mark.parametrize("name", PAGED)
def test_paged_cache_pspecs_match(name):
    tc, jc = torch_config(name), jax_config(name)
    for kv_dtype in ("", "int8"):
        tcache = tmodel.init_paged_cache(tc, 8, 513, 16, 64, device="meta",
                                         kv_dtype=kv_dtype)
        jcache = jax.eval_shape(lambda: jmodel.init_paged_cache(
            jc, 8, 513, 16, 64, kv_dtype=kv_dtype))
        for tpol, jpol, mesh in _policies(name):
            got = tsh.paged_cache_pspecs(tc, tcache, tpol, mesh)
            want = _unstack(jc, _jspecs(jsh.paged_cache_pspecs(
                jc, jcache, jpol, mesh)))
            assert got == want


@pytest.mark.parametrize("name", ["granite-8b", "qwen2-vl-7b"])
def test_batch_pspecs_match(name):
    tc, jc = torch_config(name), jax_config(name)
    shapes = {"tokens": (8, 128), "labels": (8, 128),
              "positions": (3, 8, 128), "pos": (8,), "odd": (3, 5)}
    tb = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    jb = {k: jax.ShapeDtypeStruct(s, np.int32) for k, s in shapes.items()}
    for tpol, jpol, mesh in _policies(name):
        assert tsh.batch_pspecs(tc, tb, tpol, mesh) == _jspecs(
            jsh.batch_pspecs(jc, jb, jpol, mesh))


def test_dlrm_specs_match():
    tc, jc = torch_config("dlrm"), jax_config("dlrm")
    assert temb.shard_specs(tc) == _jspecs(jemb.shard_specs(jc))
    assert temb.batch_specs(tc) == _jspecs(jemb.batch_specs(jc))


def test_place_gives_each_shard_its_block():
    """Shard j of a (1, 4) grid holds block j of every split dimension; on
    the leaf's own device a block is a view of it (a whole leaf is the
    leaf), and a meta leaf becomes zeros of the block's shape."""
    mesh = make_local_mesh(model=4, devices=["cpu"] * 4)
    t = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    tree = {"col": t, "row": t, "whole": t,
            "meta": torch.empty((8, 12), device="meta")}
    specs = {"col": tsh.Spec(None, "model"), "row": tsh.Spec("model", None),
             "whole": tsh.Spec(None, None), "meta": tsh.Spec(None, "model")}
    shards = tsh.place(tree, specs, mesh)
    for j, sh in enumerate(shards):
        assert torch.equal(sh["col"], t[:, 3 * j:3 * j + 3])
        assert sh["col"].untyped_storage().data_ptr() == \
            t.untyped_storage().data_ptr()
        assert torch.equal(sh["row"], t[2 * j:2 * j + 2])
        assert sh["whole"] is t
        assert sh["meta"].shape == (8, 3) and not sh["meta"].any()


def test_local_mesh_refuses_more_cards_than_the_host_has():
    need = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=r"devices=") as e:
        make_local_mesh(model=need)
    assert f"needs {need} devices" in str(e.value)
    with pytest.raises(ValueError, match=r"devices="):
        make_serving_mesh(DeviceTopology(tp=need))
    mesh = make_serving_mesh(DeviceTopology(tp=2), devices=["cpu", "cpu"])
    assert mesh.shape == {"data": 1, "model": 2}
    assert [str(d) for d in mesh.flat] == ["cpu", "cpu"]
    assert mesh.distinct == 1 and mesh.coords(1) == {"data": 0, "model": 1}
    with pytest.raises(ValueError, match="needs 2 devices, got 3"):
        make_local_mesh(model=2, devices=["cpu"] * 3)
