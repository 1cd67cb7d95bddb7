"""The data axis of a sharded replica (``DeviceTopology(dp=M, tp=N)``):
each data row decodes its block of the slots through its model group,
paged pools stay whole (one tensor per model shard, shared by the rows
on a device), rolling rings and states split by slot, a MoE block routes
the whole batch. The streams on ``device=["cpu"] * (M * N)`` must equal
the port's one-device engine's and the JAX package's one-chip engine's,
token for token, greedy and seeded (the reference's suite has no dp
test: its contract for a sharded replica is equality with one chip).

Reduced float32 configs with weights from ``repro.models.init_params``
through ``params_from_jax``; both packages at the reference's chip
constants for chunk interleave. Cases: granite over pages, the prefix
cache and rolling caches at dp 2 and dp 2 x tp 2; chatglm3's head_dim-
split pools at dp 2 x tp 4; recurrentgemma (5
layers: rglru and local attention) with its rings and states split by
slot; slots that the rows do not divide (every row runs the whole batch);
grok under "drop" with a capacity that binds; the layout by shard; the
refusal of paged pools over rows on different devices; the trace probes
and ``load_report``'s axis fields; the serve CLI."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import models as jm
from repro import serving as js
from repro.configs import get_config as jax_config
from repro.core import costmodel as jcost
from repro.core.hardware import TPU_V5E
from repro.core.misd.scheduler import ChunkedPrefillPolicy as JaxPolicy
from repro_torch import models as tm
from repro_torch import serving as ts
from repro_torch.configs import get_config as torch_config
from repro_torch.core import costmodel as tcost
from repro_torch.core.hardware import Chip
from repro_torch.core.misd.scheduler import ChunkedPrefillPolicy
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import make_local_mesh

torch.set_num_threads(2)

TPU = Chip(**dataclasses.asdict(TPU_V5E))
CHUNK = 16
PART = bool(jax.config.jax_threefry_partitionable)


def _pair(name, **kw):
    jc = dataclasses.replace(jax_config(name).reduced(), **kw)
    tc = dataclasses.replace(torch_config(name).reduced(), **kw)
    jp = jm.init_params(jc, jax.random.key(0))
    return jc, tc, jp, tm.params_from_jax(tc, jax.tree.map(np.asarray, jp),
                                          "cpu")


@pytest.fixture(scope="module")
def granite():
    return _pair("granite-8b", num_heads=4, num_kv_heads=2)


@pytest.fixture(scope="module")
def hybrid():
    """recurrentgemma cut to 5 layers: rglru, rglru, local_attn in the
    body, two rglru in the tail; 1 kv head (its rings stay whole on every
    shard of a model group)."""
    return _pair("recurrentgemma-9b", num_layers=5)


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, 500, n).astype(np.int32)


def _workload(pkg, n, *, max_new=6, long=False):
    """Greedy and seeded streams interleaved; ``long``: prompts past the
    chunk, the later ones sharing a 32-token prefix."""
    def prompt(i):
        own = _prompt(8 + (17 if long else 2) * i, seed=i)
        if long and i:
            return np.concatenate([_prompt(32, seed=99), own])
        return own
    return [pkg.Request(rid=i, prompt=prompt(i), max_new_tokens=max_new,
                        sampling=(pkg.SamplingParams() if i % 2 == 0 else
                                  pkg.SamplingParams(temperature=0.8,
                                                     top_k=40, seed=100 + i)))
            for i in range(n)]


def _serve(eng, reqs):
    t = 0.0
    for r in reqs:
        eng.submit(r, t)
    while not all(r.done for r in reqs):
        t += 1.0
        eng.step(t)
    eng.drain(t + 1.0)
    return [tuple(r.output) for r in reqs]


def _engine(pkg, cfg, params, dp=1, tp=1, slots=4, **kw):
    if pkg is js:
        return js.ServingEngine(cfg, params, js.EngineConfig(
            slots=slots, window=128, prefill_policy=JaxPolicy(chunk=CHUNK),
            **kw))
    return ts.ServingEngine(cfg, params, ts.EngineConfig(
        slots=slots, window=128, topology=ts.DeviceTopology(dp=dp, tp=tp),
        prefill_policy=ChunkedPrefillPolicy(chunk=CHUNK, chip=TPU), **kw),
        device=["cpu"] * (dp * tp) if dp * tp > 1 else "cpu",
        threefry_partitionable=PART)


def _three_way(setup, grids, n=5, long=True, slots=4, jax_too=True, **kw):
    """The JAX engine's streams (None without ``jax_too``), the port's
    one-device engine's, and each (dp, tp) grid's, with the port's
    engines."""
    jc, tc, jp, tparams = setup
    want = (_serve(_engine(js, jc, jp, slots=slots, **kw),
                   _workload(js, n, long=long)) if jax_too else None)
    base = _engine(ts, tc, tparams, slots=slots, **kw)
    got1 = _serve(base, _workload(ts, n, long=long))
    engines, got = [], []
    for dp, tp in grids:
        eng = _engine(ts, tc, tparams, dp, tp, slots=slots, **kw)
        got.append(_serve(eng, _workload(ts, n, long=long)))
        engines.append(eng)
    return want, got1, got, base, engines


_PATHS = {"paged": dict(paged=True), "prefix_cache": dict(prefix_cache=True),
          "rolling": dict(paged=False)}


@pytest.mark.parametrize("path", list(_PATHS))
def test_dp_streams_equal_one_device_and_jax(granite, path):
    """dp 2 and dp 2 x tp 2: 5 requests on 4 slots (each row 2 of them),
    chunked prompts, prefix hits of a shared prefix across rows."""
    want, got1, got, base, engines = _three_way(
        granite, [(2, 1), (2, 2)], **_PATHS[path])
    assert got1 == want
    assert got == [want, want]  # EQUAL, token for token
    for eng in engines:
        assert eng.metrics.prefill_chunks == base.metrics.prefill_chunks > 0
        assert (eng.prefill_traces, eng.decode_traces) == (
            base.prefill_traces, base.decode_traces)
        if path == "prefix_cache":
            assert eng.metrics.prefix_hits == base.metrics.prefix_hits > 0
        if path != "rolling":
            assert eng.allocator.pages_in_use == base.allocator.pages_in_use


def test_dp_head_dim_split_pools_chatglm3():
    """chatglm3's 2 kv heads at dp 2 x tp 4: each row's pools split on
    head_dim and shared with the other row; a prompt's K/V scattered by
    every shard of both rows at its model coordinate's block."""
    setup = _pair("chatglm3-6b", num_kv_heads=2)
    want, got1, got, _, engines = _three_way(setup, [(2, 4)])
    assert got1 == want and got == [want]
    hd = setup[1].resolved_head_dim
    c = engines[0].cache
    assert c[5]["layers"][0]["k"].shape[2:] == (2, hd // 4)
    assert c[5]["layers"][0]["k"].data_ptr() == c[1]["layers"][0][
        "k"].data_ptr()


def test_dp_rolling_hybrid_rings_and_states_split_by_slot(hybrid):
    """recurrentgemma at dp 2 and dp 2 x tp 2: each row holds its 2 of
    the 4 slots' rings and RG-LRU states. Prompts within the local window
    against the JAX engine too; prompts past it (up to 108 tokens over
    rings of 64) against the port's one-device engine only, since the
    reference's ring fill misreads them (ROADMAP.md queue 3)."""
    want, got1, got, _, _ = _three_way(hybrid, [(2, 1), (2, 2)], long=False)
    assert got1 == want
    assert got == [want, want]
    _, got1, got, _, engines = _three_way(hybrid, [(2, 2)], long=True,
                                          jax_too=False)
    assert got == [got1]
    tc = hybrid[1]
    for eng in engines:
        for c in eng.cache:
            for layer, bt in zip(c["layers"], tm.layer_types(tc)):
                lead = layer["k" if bt == "local_attn" else "state"]
                assert lead.shape[0] == 2  # 4 slots over 2 rows
            assert c["pos"].shape == (4,)  # positions whole on every shard


def test_dp_slots_the_rows_do_not_divide(granite, hybrid):
    """3 slots over 2 rows: the batch stays whole, every row runs all of
    it (the reference's ``_batch_dim_spec`` returns None); the streams
    equal the one-device engine's (which the other cases hold to the JAX
    engine's)."""
    for setup in (granite, hybrid):
        _, got1, got, _, engines = _three_way(setup, [(2, 1)], slots=3,
                                              long=False, jax_too=False)
        assert got == [got1]
    # the second row's RG-LRU states: all 3 slots
    assert engines[0].cache[1]["layers"][0]["state"].shape[0] == 3


def test_dp_moe_drop_routes_the_whole_batch():
    """grok under "drop" with capacity factor 1.0 (tokens do drop: the
    streams differ from "strict"'s): at dp 2 the rows' tokens route as
    one group, so the streams equal one device's and the JAX engine's."""
    setup = _pair("grok-1-314b", moe_capacity_factor=1.0)
    want, got1, got, _, engines = _three_way(
        setup, [(2, 1)], n=5, long=False, moe_capacity_policy="drop")
    assert got1 == want
    assert got == [want]
    assert all(e.moe_capacity_policy == "drop" for e in engines)
    strict = _serve(_engine(ts, setup[1], setup[3],
                            moe_capacity_policy="strict"),
                    _workload(ts, 5))
    assert strict != want


def test_dp_layout_pools_shared_rings_split(granite):
    """Paged: the rows at one model coordinate share one pool tensor (they
    must all see every write), page tables and positions are copies;
    params at one model coordinate are the same blocks. Rolling: each
    row's ring is its own block of the slots."""
    _, tc, _, tparams = granite
    eng = _engine(ts, tc, tparams, 2, 2)
    c = eng.cache
    for m in range(2):
        a, b = c[m]["layers"][0], c[2 + m]["layers"][0]
        assert a["k"].data_ptr() == b["k"].data_ptr()
        assert c[m]["page_table"].data_ptr() != c[2 + m][
            "page_table"].data_ptr()
        assert (eng.params[m]["layers"][0]["attn"]["wq"].data_ptr()
                == eng.params[2 + m]["layers"][0]["attn"]["wq"].data_ptr())
    assert c[0]["layers"][0]["k"].data_ptr() != c[1]["layers"][0][
        "k"].data_ptr()
    roll = _engine(ts, tc, tparams, 2, 2, paged=False)
    assert roll.cache[0]["layers"][0]["k"].shape[0] == 2
    assert roll.cache[0]["layers"][0]["k"].data_ptr() != roll.cache[2][
        "layers"][0]["k"].data_ptr()


def test_paged_pools_over_rows_on_different_devices_are_refused(granite):
    """Rows of one model shard on different devices would each hold a copy
    of the pools and miss the other rows' writes: refused before any pool
    is placed, naming the ROADMAP.md item."""
    _, tc, _, _ = granite
    mesh = make_local_mesh(data=2, devices=["cpu", "meta"])
    meta = tm.init_paged_cache(tc, 4, 9, 16, 2, device="meta")
    with pytest.raises(ValueError, match="different devices.*4c"):
        tm.shard_cache(tc, meta, mesh, paged=True)
    roll = tm.shard_cache(tc, tm.init_cache(tc, 4, 32, device="meta"), mesh,
                          paged=False)
    assert [c["layers"][0]["k"].device.type for c in roll] == ["cpu",
                                                              "meta"]


def test_dp_load_report_axis_fields(granite):
    """The mesh axes carry data; the data axis moves nothing a tick (the
    reference's cost model: its collective bytes per axis, the same)."""
    _, tc, _, tparams = granite
    rep = _engine(ts, tc, tparams, 2, 2).load_report()
    assert rep.n_chips == 4
    assert dict(rep.mesh_axes) == {"data": 2, "model": 2}
    cs = dict(rep.axis_collective_s)
    assert cs["data"] == 0.0 and cs["model"] > 0.0
    axes = (("data", 2), ("model", 2))
    assert tcost.collective_bytes_per_axis(tc, 4, mesh_axes=axes) == \
        jcost.collective_bytes_per_axis(granite[0], 4, mesh_axes=axes)
    assert ts.LoadReport.from_dict(rep.to_dict()) == rep


def test_serve_cli_dp_tp_hybrid(capsys):
    """``--dp 2 --tp 2`` on recurrentgemma through the serve CLI gives
    the one-device streams; the banner prints the grid's rows."""
    common = ["--arch", "recurrentgemma-9b", "--reduced", "--device", "cpu",
              "--requests", "4", "--slots", "2", "--rate", "1000",
              "--max-new", "5", "--temperature", "0.8", "--top-k", "20"]
    one = tserve.main(common)
    capsys.readouterr()
    grid = tserve.main(common + ["--dp", "2", "--tp", "2", "--devices",
                                 "cpu,cpu,cpu,cpu"])
    out = capsys.readouterr().out
    assert "mesh {'data': 2, 'model': 2}" in out
    assert "data rows [cpu, cpu; cpu, cpu]" in out
    assert [r.output for r in grid] == [r.output for r in one]
