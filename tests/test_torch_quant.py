"""The PyTorch port's quantized serving path (int8 KV pages, weight-only
int8) against the JAX package's, on granite-8b ``reduced()`` with two kv
heads and the same converted weights; inputs from numpy seeds.

Compared: ``quantize_kv`` and ``quantize_weights`` codes and scales bit
for bit; the plain versions of the int8 matmul and the int8 paged decode
(the kernels' CPU dispatch) against the JAX twins, the Pallas kernels in
interpret mode and the oracles; whole-model logits under each precision;
the engine's page scatter under the "page" scale granularity; the
capacity arithmetic; ``EngineConfig.validate``'s precision rules; and
engine streams, greedy and seeded, under every precision and granularity.

Tolerances: float32 2e-5 and bfloat16 2e-2 per function
(tests/test_kernels.py). Whole-model logits: 1e-4 absolute, as in
tests/test_torch_model.py (float32 sums in another order, through 2
blocks). That bound holds while every int8 code of the KV pools agrees.
The two packages' K/V differ by a few float32 ulps before quantization,
so a value that close to a rounding boundary (code + 0.5) can round to
neighbouring codes, one quantization step (max|k| / 127, about 0.02 here)
apart. Where codes differ, the test checks that each differs by one and,
for the prefill's codes, that the port's input lies within 1e-5 of its
vector's max magnitude of the boundary; the logits are then held to
5e-3: one step of one K or V element moves one attention score by about
|q| * 0.02 / sqrt(32), which reached 1.2e-3 in the logits here, while a
wrong scale, code or page moves them by 0.1 or more."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro import serving as js
from repro.configs import get_config as jax_config
from repro.core.costmodel import kv_bytes_per_token as jax_kv_bytes
from repro.core.misd.batching import plan_admission as jax_plan
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro.models.blocks import dequantize_kv as jax_dequantize_kv
from repro.models.blocks import quantize_kv as jax_quantize_kv
from repro.serving import engine as je
from repro.util import sharding_hints
from repro_torch import models as tm
from repro_torch import serving as ts
from repro_torch.configs import get_config as torch_config
from repro_torch.core.costmodel import kv_bytes_per_token
from repro_torch.core.misd.batching import plan_admission
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as TL
from repro_torch.models.blocks import dequantize_kv, linear, quantize_kv
from repro_torch.serving import engine as te

torch.set_num_threads(2)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LOGITS_TOL = 1e-4
FLIP_TOL = 5e-3  # logits once the packages' int8 KV codes differ
DT = {"float32": (torch.float32, jnp.float32),
      "bfloat16": (torch.bfloat16, jnp.bfloat16)}
PS = 16


def _pair(a, dtype):
    tdt, jdt = DT[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(jdt)


def _close(t, j, dtype="float32"):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _bits(t):
    return t.contiguous().view(torch.int32).numpy()


def _jbits(j):
    return np.asarray(j, np.float32).view(np.int32)


def _cfgs(dtype="float32"):
    jc = dataclasses.replace(jax_config("granite-8b").reduced(),
                             num_kv_heads=2, dtype=dtype)
    tc = dataclasses.replace(torch_config("granite-8b").reduced(),
                             num_kv_heads=2, dtype=dtype)
    return jc, tc


@pytest.fixture(scope="module")
def setup():
    jc, tc = _cfgs()
    jp = jm.init_params(jc, jax.random.key(0))
    tp = tm.params_from_jax(tc, jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


# -- quantization: bit for bit ------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [0, PS, 20])
def test_quantize_kv_is_bit_identical_to_jax(group, dtype):
    """Per token (0), per page (16 divides S = 48) and a group that does
    not divide S (20: per-token fallback); with an all-zero vector (the
    1e-8 scale floor) and exact .5 ties (round half to even)."""
    rng = np.random.default_rng(group)
    a = (rng.standard_normal((2, 48, 2, 32)) * 3).astype(np.float32)
    a[0, 5, 1] = 0.0
    a[1, 3, 0] = np.arange(32) - 15.5  # scale 16.5/127: ties after / scale
    a[1, 3, 0, 0] = 127.0  # scale 1: x.5 values tie exactly
    a[1, 3, 0, 1:6] = [0.5, 1.5, 2.5, -0.5, -2.5]
    (tt, jt) = _pair(a, dtype)
    q8, sc = quantize_kv(tt, group=group)
    jq8, jsc = jax_quantize_kv(jt, group=group)
    assert q8.dtype == torch.int8 and tuple(sc.shape) == (2, 48, 2, 1)
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(_bits(sc), _jbits(jsc))
    if dtype == "float32" and group == 0:
        assert q8[1, 3, 0, 1:6].tolist() == [0, 2, 2, 0, -2]
    tdt, jdt = DT[dtype]
    np.testing.assert_array_equal(
        dequantize_kv(q8, sc, tdt).float().numpy(),
        np.asarray(jax_dequantize_kv(jq8, jsc, jdt), np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weights_is_bit_identical_to_jax(dtype):
    """The port's quantize_weights on converted weights against the JAX
    package's on the same weights, carried across as a quantized tree
    (``params_from_jax`` unstacks the (n_repeat, 1, N) body scales)."""
    jc, tc = _cfgs(dtype)
    jp = jm.init_params(jc, jax.random.key(1))
    got = tm.quantize_weights(
        tc, tm.params_from_jax(tc, jax.tree.map(np.asarray, jp), "cpu"))
    want = tm.params_from_jax(
        tc, jax.tree.map(np.asarray, jm.quantize_weights(jc, jp)), "cpu")
    n_quant = 0
    for g, w in zip(got["layers"], want["layers"]):
        for sub in ("attn", "mlp"):
            assert set(g[sub]) == set(w[sub])
            for key, leaf in w[sub].items():
                if key not in tm.QUANT_WEIGHT_KEYS:
                    assert torch.equal(g[sub][key], leaf)
                    continue
                n_quant += 1
                q, s = g[sub][key]["w_q"], g[sub][key]["scale"]
                assert q.dtype == torch.int8 and s.dtype == torch.float32
                assert tuple(s.shape) == (1, q.shape[1])
                assert torch.equal(q, leaf["w_q"])
                np.testing.assert_array_equal(_bits(s), _bits(leaf["scale"]))
        assert torch.equal(g["norm1"]["scale"], w["norm1"]["scale"])
    assert n_quant == 7 * tc.num_layers
    assert got["embed"].dtype == DT[dtype][0]
    assert torch.equal(got["embed"], want["embed"])


def test_quantize_int8_is_bit_identical_to_jax():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((96, 48)).astype(np.float32)
    w[:, 7] = 0.0
    q, s = ops.quantize_int8(torch.from_numpy(w))
    jq, js_ = jops.quantize_int8(jnp.asarray(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(s), _jbits(js_))


# -- the int8 matmul's plain version ------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 8, 37])
def test_int8_matmul_plain_matches_jax_linear(m, dtype):
    """The dispatch point on the CPU against the JAX ``layers.linear``
    dict path (scale after the dot, one cast), and ``blocks.linear``'s
    own dict path through it with leading dims flattened."""
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, 256)).astype(np.float32)
    w = rng.standard_normal((256, 384)).astype(np.float32)
    q, s = ops.quantize_int8(torch.from_numpy(w))
    tx, jx = _pair(x, dtype)
    jw = {"w_q": jnp.asarray(q.numpy()), "scale": jnp.asarray(s.numpy())[None]}
    tw = {"w_q": q, "scale": s[None]}
    before = dict(ops.LAUNCHES)
    got = ops.int8_matmul(tx, q, s)
    assert ops.LAUNCHES == before  # a CPU tensor launches no kernel
    assert got.dtype == tx.dtype and tuple(got.shape) == (m, 384)
    _close(got, JL.linear(jx, jw, "...d,df->...f"), dtype)
    lin = linear(tx.reshape(1, m, 256), tw)
    assert tuple(lin.shape) == (1, m, 384)
    assert torch.equal(lin[0], got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(128, 256, 128), (256, 128, 384)])
def test_int8_matmul_matches_the_pallas_kernel(m, k, n, dtype):
    """At the shapes the Pallas kernel takes (multiples of its 128
    blocks), run in interpret mode as tests/test_kernels.py runs it; and
    the port's looser oracle (weight scaled first) against the JAX one."""
    rng = np.random.default_rng(k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    q, s = ops.quantize_int8(torch.from_numpy(w))
    tx, jx = _pair(x, dtype)
    jq, js_ = jnp.asarray(q.numpy()), jnp.asarray(s.numpy())
    got = ops.int8_matmul(tx, q, s)
    _close(got, jops.int8_matmul(jx, jq, js_, interpret=True), dtype)
    _close(ref.ref_int8_matmul(tx, q, s), jref.ref_int8_matmul(jx, jq, js_),
           dtype)


def test_int8_matmul_k_split_fills_the_card():
    """Decode shapes (M = 8 slots) split K until about four blocks per SM
    of the H100 are in flight, each split at least 8 tiles deep and none
    empty; prefill shapes (M = 512, 128 x 64 tiles 64 deep) split only
    where the tiles are fewer than the SMs (wk/wv, N 1024)."""
    from repro_torch.kernels.int8_matmul import block_rows, k_splits

    assert block_rows(8, torch.bfloat16) == 16
    assert block_rows(32, torch.bfloat16) == 16
    assert block_rows(33, torch.bfloat16) == 128
    assert block_rows(512, torch.bfloat16) == 128
    assert block_rows(512, torch.float32) == 16
    assert k_splits(8, 4096, 14336, 16) == (5, 832)
    assert k_splits(8, 4096, 1024, 16) == (16, 256)
    assert k_splits(8, 14336, 4096, 16) == (17, 864)
    assert k_splits(512, 4096, 4096, 128) == (1, 4096)
    assert k_splits(512, 14336, 4096, 128) == (1, 14336)
    assert k_splits(512, 4096, 1024, 128) == (2, 2048)
    for m, k, n in ((1, 256, 384), (8, 4096, 4096), (37, 512, 64)):
        splits, chunk = k_splits(m, k, n, 16)
        assert chunk % 32 == 0 and (splits - 1) * chunk < k <= splits * chunk


def test_int8_matmul_bad_shapes():
    x = torch.zeros((4, 32))
    q = torch.zeros((32, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="want x"):
        ops.int8_matmul(x, q[:16], torch.ones(16))
    with pytest.raises(ValueError, match="want x"):
        ops.int8_matmul(x, q, torch.ones(8))


# -- int8 paged decode attention's plain version ------------------------------


def _int8_pools(rng, n_pool, kv, d, group):
    """Random K/V quantized into int8 pools (P, ps, kv, d) with scale
    pools (P, ps, kv, 1); returns (raw k, raw v, k8, ks, v8, vs)."""
    out = []
    for _ in range(2):
        raw = (rng.standard_normal((n_pool * PS, kv, d)) * 2).astype(
            np.float32)
        q8, sc = quantize_kv(torch.from_numpy(raw), group=group)
        out.append((raw.reshape(n_pool, PS, kv, d),
                    q8.reshape(n_pool, PS, kv, d).numpy(),
                    sc.reshape(n_pool, PS, kv, 1).numpy()))
    (kr, k8, ks), (vr, v8, vs) = out
    return kr, vr, k8, ks, v8, vs


@pytest.mark.parametrize("gran", ["page", "token"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq", [1, 4])
def test_paged_decode_int8_plain_matches_jax(sq, dtype, gran):
    """Pages scattered through the pool, a partial page, a full table and
    a released slot on trash page 0, against the JAX twin, the Pallas
    kernel (interpret) and the oracle; in float32 also within
    ``int8_attention_output_bound`` of attention over the unquantized
    K/V. The Pallas body dequantizes in float32 without rounding to q's
    dtype: in bfloat16 it differs from the twin by that rounding, which
    the bfloat16 tolerance covers at these shapes."""
    rng = np.random.default_rng(20 + sq)
    b, h, kv, d, n_pages = 3, 4, 2, 32, 4
    n_pool = b * n_pages + 1
    kr, vr, k8, ks, v8, vs = _int8_pools(rng, n_pool, kv, d,
                                         PS if gran == "page" else 0)
    table = (rng.permutation(n_pool - 1)[:b * n_pages] + 1).reshape(
        b, n_pages).astype(np.int32)
    table[2] = 0
    pos = np.array([PS + 5, PS * n_pages, sq], np.int32)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    tq, jq = _pair(q, dtype)
    targs = [torch.from_numpy(a) for a in (k8, v8, ks, vs, table, pos)]
    jargs = [jnp.asarray(a) for a in (k8, v8, ks, vs, table, pos)]
    before = dict(ops.LAUNCHES)
    got = ops.paged_decode_attention_int8(tq, *targs)
    assert ops.LAUNCHES == before
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, JL.paged_decode_attention_int8(jq, *jargs), dtype)
    _close(got, jops.paged_decode_attention_int8(jq, *jargs, interpret=True),
           dtype)
    _close(ref.ref_paged_decode_attention_int8(tq, *targs),
           jref.ref_paged_decode_attention_int8(jq, *jargs), dtype)
    if dtype == "float32":
        exact = TL.paged_decode_attention(tq, torch.from_numpy(kr),
                                          torch.from_numpy(vr), targs[4],
                                          targs[5])
        v_deq = dequantize_kv(targs[1], targs[3], torch.float32)
        bound = ref.int8_attention_output_bound(tq, targs[2], targs[3],
                                                v_deq)
        jbound = jref.int8_attention_output_bound(jq, jargs[2], jargs[3],
                                                  jnp.asarray(v_deq.numpy()))
        np.testing.assert_allclose(float(bound), float(jbound), rtol=1e-6)
        err = float((got - exact).abs().max())
        assert 0 < err <= float(bound), (err, float(bound))


def test_paged_decode_int8_bad_shapes():
    q = torch.zeros((2, 1, 4, 32))
    pool = torch.zeros((5, 16, 2, 32), dtype=torch.int8)
    sc = torch.zeros((5, 16, 2, 1))
    table = torch.zeros((2, 2), dtype=torch.int32)
    pos = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="scale pools"):
        ops.paged_decode_attention_int8(q, pool, pool, sc[..., 0], sc,
                                        table, pos)
    with pytest.raises(ValueError, match="do not match"):
        ops.paged_decode_attention_int8(q, pool, pool, sc, sc, table[:1],
                                        pos)


# -- the model under each precision -------------------------------------------

PRECISIONS = {"kv": dict(kv_cache_dtype="int8"),
              "weights": dict(weight_dtype="int8"),
              "both": dict(kv_cache_dtype="int8", weight_dtype="int8")}


def _code_flips(t_codes, j_codes):
    """Codes that differ between the packages; each may differ by one."""
    diff = np.abs(t_codes.numpy().astype(np.int32)
                  - np.asarray(j_codes).astype(np.int32))
    assert diff.max(initial=0) <= 1
    return int((diff > 0).sum())


def _pool_flips(tcache, jcache):
    return sum(_code_flips(layer[name], jcache["body"][0][name][r])
               for r, layer in enumerate(tcache["layers"])
               for name in ("k", "v"))


def _prefill_flips_at_boundaries(tcache, jcache, kv, pages):
    """Every code of the admitted pages that differs between the packages
    comes from a port input within 1e-5 of its vector's max magnitude of
    a rounding boundary: 127e-5 code steps. Returns how many differ."""
    n = len(pages)
    flips = 0
    for r, (layer, raw_kv) in enumerate(zip(tcache["layers"], kv)):
        for name, raw in zip(("k", "v"), raw_kv):
            codes = layer[name][pages].numpy().astype(np.int32)
            jcodes = np.asarray(jcache["body"][0][name][r])[pages]
            differ = codes != jcodes
            x = (raw[0, :n * PS].reshape(codes.shape)
                 / layer[name + "_scale"][pages]).numpy()
            to_boundary = np.abs(x - np.floor(x) - 0.5)
            assert (to_boundary[differ] <= 127e-5).all()
            flips += int(differ.sum())
    return flips


@pytest.mark.parametrize("prec,s", [("kv", 1), ("weights", 1), ("both", 1),
                                    ("both", 4)])
def test_logits_match_jax_under_each_precision(setup, prec, s):
    """A 21-token prompt prefilled (bucket 32) and scattered into pages
    3 and 5 with page-granularity scales, a released slot on trash page
    0, then three decode steps of S tokens, through both packages."""
    jc, tc, jp, tp = setup
    pr = PRECISIONS[prec]
    kv_dtype = pr.get("kv_cache_dtype", "")
    if pr.get("weight_dtype"):
        jp, tp = jm.quantize_weights(jc, jp), tm.quantize_weights(tc, tp)
    n_pool, max_pages, plen = 8, 4, 21
    rng = np.random.default_rng(30 + s)
    prompt = np.zeros((1, 32), np.int32)
    prompt[0, :plen] = rng.integers(0, jc.vocab_size, plen)
    pages = np.array([3, 5], np.int32)

    with sharding_hints(kv_scale_page=PS):
        _, jlast, lin = je.paged_prefill_step(
            jc, jp, {"tokens": jnp.asarray(prompt)}, plen, kv_dtype=kv_dtype)
    jcache = jm.init_paged_cache(jc, 2, n_pool, PS, max_pages, kv_dtype)
    jcache = je.pages_insert(jcache, lin, jnp.asarray(pages), 0, plen)
    jcache = je.page_table_append(jcache, 0, 2, 6)

    _, last, kv = te.paged_prefill_step(tc, tp, torch.from_numpy(prompt),
                                        plen)
    tcache = tm.init_paged_cache(tc, 2, n_pool, PS, max_pages, device="cpu",
                                 kv_dtype=kv_dtype)
    te.pages_insert(tcache, kv, torch.from_numpy(pages).long(), 0, plen,
                    scale_group=PS if kv_dtype else 0)
    te.page_table_append(tcache, 0, 2, 6)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast),
                               atol=LOGITS_TOL, rtol=0)
    if kv_dtype:
        _prefill_flips_at_boundaries(tcache, jcache, kv, list(pages))

    for _ in range(3):
        toks = rng.integers(0, jc.vocab_size, (2, s)).astype(np.int32)
        want, jcache = jm.decode_step(jc, jp, jcache,
                                      {"tokens": jnp.asarray(toks)})
        got = tm.decode_step(tc, tp, tcache, torch.from_numpy(toks))
        flips = _pool_flips(tcache, jcache) if kv_dtype else 0
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=FLIP_TOL if flips else LOGITS_TOL)
    for r, layer in enumerate(tcache["layers"]):
        for name in ("k", "v"):
            if kv_dtype:
                assert layer[name].dtype == torch.int8
                np.testing.assert_allclose(
                    layer[name + "_scale"].numpy(),
                    np.asarray(jcache["body"][0][name + "_scale"][r]),
                    rtol=1e-5, atol=0)
            else:
                np.testing.assert_allclose(
                    layer[name].numpy(),
                    np.asarray(jcache["body"][0][name][r]),
                    atol=LOGITS_TOL, rtol=0)


@pytest.mark.parametrize("gran", ["page", "token"])
def test_pages_insert_scales_match_the_jax_engine(setup, gran):
    """One admission of a 40-token prompt (bucket 64: 4 pages, 24 pad
    positions) into both engines' int8 pools. Under "page" every page
    holds one scale per kv head, the last page's taken over its pad
    positions too, as the JAX engine's; under "token" one per token."""
    jc, tc, jp, tp = setup
    prompt = np.random.default_rng(4).integers(0, jc.vocab_size,
                                               40).astype(np.int32)
    engines = []
    for pkg, cfg, params, kw in ((js, jc, jp, {}), (ts, tc, tp,
                                                   {"device": "cpu"})):
        eng = pkg.ServingEngine(cfg, params, pkg.EngineConfig(
            slots=2, chunk_prefill=0, max_seq=128,
            precision=pkg.PrecisionConfig(kv_cache_dtype="int8",
                                          kv_scale_granularity=gran)), **kw)
        assert eng.submit(pkg.Request(rid=0, prompt=prompt,
                                      max_new_tokens=4), 0.0)
        engines.append(eng)
    jeng, teng = engines
    pages = teng.allocator.owned(0)[:4]
    assert pages == jeng.allocator.owned(0)[:4]
    for r, layer in enumerate(teng.cache["layers"]):
        for name in ("k", "v"):
            sc = layer[name + "_scale"]
            jsc = np.asarray(jeng.cache["body"][0][name + "_scale"][r])
            np.testing.assert_allclose(sc.numpy(), jsc, rtol=1e-5, atol=0)
            per_page = sc[pages]  # (4, ps, kv, 1)
            same = bool((per_page == per_page[:, :1]).all())
            assert same == (gran == "page")
    assert _pool_flips(teng.cache, jeng.cache) <= 2


# -- capacity arithmetic and validation ---------------------------------------


def test_kv_bytes_and_plan_admission_match_jax():
    """Per-token bytes per pool dtype, and the slots a KV budget grants
    (a loose SLA, so the budget binds in both packages' cost models)."""
    for name in ("granite-8b",):
        for reduced in (False, True):
            jc, tc = jax_config(name), torch_config(name)
            if reduced:
                jc, tc = jc.reduced(), tc.reduced()
            for kvd in ("", "int8"):
                assert kv_bytes_per_token(tc, kvd) == jax_kv_bytes(jc, kvd)
    jc, tc = jax_config("granite-8b"), torch_config("granite-8b")
    assert kv_bytes_per_token(tc, "int8") == 36 * 2 * 8 * (128 + 4)
    for budget in (2 ** 30, 2 * 2 ** 30, 4 * 2 ** 30):
        slots = {}
        for kvd in ("", "int8"):
            kw = dict(context=1024, sla_s=1e3, max_slots=256,
                      kv_hbm_budget_bytes=budget, mean_context=512,
                      kv_cache_dtype=kvd)
            got = plan_admission(tc, **kw).slots
            assert got == jax_plan(jc, **kw).slots
            slots[kvd] = got
        assert slots["int8"] >= int(1.9 * slots[""])
    with pytest.raises(AssertionError, match="over-admit"):
        kv_bytes_per_token(tc, "fp8")


def _jax_message(jc, **kw):
    with pytest.raises(ValueError) as e:
        js.EngineConfig(**kw).validate(jc)
    return str(e.value)


def test_validate_accepts_dense_paged_int8_and_keeps_the_jax_rules():
    jc, tc = _cfgs()
    for pr in PRECISIONS.values():
        for gran in ("page", "token"):
            p = ts.PrecisionConfig(kv_scale_granularity=gran, **pr)
            ts.EngineConfig(precision=p).validate(tc)
            ts.EngineConfig(precision=p).validate()
    kv8 = dict(precision=ts.PrecisionConfig(kv_cache_dtype="int8"))
    jkv8 = dict(precision=js.PrecisionConfig(kv_cache_dtype="int8"))
    with pytest.raises(ValueError) as e:
        ts.EngineConfig(paged=False, **kv8).validate(tc)
    assert str(e.value) == _jax_message(jc, paged=False, **jkv8)
    assert "rolling cache (paged=False)" in str(e.value)
    ssm_t = dataclasses.replace(tc, arch_type="ssm")
    ssm_j = dataclasses.replace(jc, arch_type="ssm")
    with pytest.raises(ValueError) as e:
        ts.EngineConfig(**kv8).validate(ssm_t)
    assert str(e.value) == _jax_message(ssm_j, **jkv8)
    w8 = dict(precision=ts.PrecisionConfig(weight_dtype="int8"))
    with pytest.raises(ValueError) as e:
        ts.EngineConfig(**w8).validate(ssm_t)
    assert str(e.value) == _jax_message(
        ssm_j, precision=js.PrecisionConfig(weight_dtype="int8"))
    with pytest.raises(ValueError, match="sharded replicas"):
        ts.EngineConfig(topology=ts.DeviceTopology(tp=2), **w8).validate(tc)
    # without an arch the reference's rules have nothing to check: rolling
    # caches are served, so both packages pass; so are chunks over int8
    # pages; what is not ported stays refused with its ROADMAP.md item
    ts.EngineConfig(paged=False, **kv8).validate()
    js.EngineConfig(paged=False, **jkv8).validate()
    ts.EngineConfig(chunk_prefill=32, **kv8).validate(tc)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        ts.EngineConfig(tracing=True, **kv8).validate()


# -- engine streams -----------------------------------------------------------

LENS = [5, 23, 40, 17]


def _serve(pkg, cfg, params, prompts, precision, **kw):
    eng = pkg.ServingEngine(cfg, params, pkg.EngineConfig(
        slots=3, chunk_prefill=0, max_seq=128,
        precision=pkg.PrecisionConfig(**precision)), **kw)
    reqs = [pkg.Request(rid=i, prompt=p, max_new_tokens=12,
                        sampling=(pkg.SamplingParams(
                            temperature=0.8, top_k=20, top_p=0.9,
                            seed=1000 + i)
                            if i % 2 else pkg.SamplingParams()))
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r, 0.0)
    t, done = 0.0, 0
    while done < len(reqs) and t < 500:
        t += 1.0
        done += len(eng.step(t))
    eng.drain(t)
    return reqs, eng


@pytest.mark.parametrize("gran", ["page", "token"])
@pytest.mark.parametrize("prec", sorted(PRECISIONS))
def test_int8_streams_match_the_jax_engine(setup, prec, gran):
    """4 requests of mixed length on 3 slots, greedy (even rid) and seeded
    (odd rid) together, token-identical to the JAX engine."""
    jc, tc, jp, tp = setup
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jc.vocab_size, n).astype(np.int32)
               for n in LENS]
    precision = dict(PRECISIONS[prec], kv_scale_granularity=gran)
    want, jeng = _serve(js, jc, jp, prompts, precision)
    got, teng = _serve(ts, tc, tp, prompts, precision, device="cpu",
                       threefry_partitionable=bool(
                           jax.config.jax_threefry_partitionable))
    assert [r.output for r in got] == [r.output for r in want]
    assert all(len(r.output) == 12 and r.state.value == "finished"
               for r in got)
    assert teng.metrics.sampled_requests == jeng.metrics.sampled_requests
    assert teng.allocator.pages_in_use == 0
    kv8 = "kv_cache_dtype" in PRECISIONS[prec]
    assert (teng.cache["layers"][0]["k"].dtype == torch.int8) == kv8
    wq = teng.params["layers"][0]["attn"]["wq"]
    assert isinstance(wq, dict) == ("weight_dtype" in PRECISIONS[prec])
