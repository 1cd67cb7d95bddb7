"""Model of the PyTorch port: block program -> an unrolled loop over
layers (the JAX package scans stacked weights; the port keeps one param
dict per layer, in scan order).

Public API (device explicit everywhere):
  block_program(cfg)                          -> (pattern, n_repeat, tail)
  init_params(cfg, seed, device)              -> params dict (random weights)
  init_cache(cfg, batch, window, device)      -> rolling caches (rings,
                                                 RG-LRU / SSD states, pos)
  init_paged_cache(cfg, batch, n_pages, page_size, max_pages, device,
                   kv_dtype)
  quantize_weights(cfg, params)               -> params with int8 leaves
  forward(cfg, params, tokens, ...)           -> (logits, per-layer (k, v));
                                                 fills a rolling cache;
                                                 mode="train": (logits, aux)
  decode_step(cfg, params, cache, tokens)     -> logits (B, S, V); cache
                                                 (paged or rolling) updated
                                                 in place
  param_specs(cfg), cache_specs(cfg, batch, window)
                                              -> the same trees on the
                                                 meta device (shapes only)
  param_count_tree(params)                    -> elements of a params tree
  shard_params(cfg, params, mesh), shard_cache(cfg, cache, mesh, paged=)
                                              -> one tree per shard
                                                 (``Shards``) under
                                                 ``serving_policy``

``forward`` and ``decode_step`` also take a sharded replica: params and
caches as ``Shards`` over a (data, model) grid (each data row runs its
block of the batch, or all of it when the rows do not divide it; its
model group is tensor and expert parallel, ``blocks.apply_block_sharded``).
The logits of all rows come back whole, in slot order, on the first
shard's device, where the sampler runs.

Both steps take ``positions`` (3, B, S) for mrope (qwen2-vl: the stubbed
vision frontend's three position streams; the reference's
``batch["positions"]``) and ``moe_dispatch`` (the MoE blocks' expert
dispatch, ``moe.resolve_dispatch``: the reference passes full capacity
as a trace hint); ``forward`` also takes ``patches``
(B, P, d), precomputed patch embeddings fused ahead of the text tokens
(``vision_text`` archs). An audio arch (hubert-xlarge) has no token
embedding: ``forward`` takes its precomputed frame embeddings (B, S, d)
in place of tokens (the reference's ``batch["frames"]``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.device import resolve_device
from repro_torch.core.simd.sharding import (
    Shards,
    cache_pspecs,
    paged_cache_pspecs,
    param_pspecs,
    place,
    serving_policy,
)
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.blocks import (
    PAGED_BLOCKS,
    PORTED_BLOCKS,
    apply_block,
    apply_block_sharded,
    by_rows,
    gather,
    init_block,
    init_block_cache,
    init_norm,
    init_paged_block_cache,
    paged_write_index,
    rows_of,
)
from repro_torch.tree import leaves

F32 = torch.float32


def dtype_of(cfg) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]


def block_program(cfg):
    if cfg.arch_type in ("dense", "vlm"):
        pattern = ("dense",)
    elif cfg.arch_type == "audio":
        pattern = ("encoder",)
    elif cfg.arch_type == "moe":
        k = cfg.moe_layer_period
        pattern = ("dense",) * (k - 1) + ("moe",)
    elif cfg.arch_type == "ssm":
        pattern = ("ssd",)
    elif cfg.arch_type == "hybrid":
        pattern = cfg.block_pattern or ("rglru", "rglru", "local_attn")
    else:
        raise ValueError(cfg.arch_type)
    n_repeat = cfg.num_layers // len(pattern)
    tail = pattern[: cfg.num_layers % len(pattern)]
    return pattern, n_repeat, tail


def layer_types(cfg):
    """Block type of every layer, in the reference's scan order."""
    pattern, n_repeat, tail = block_program(cfg)
    return list(pattern) * n_repeat + list(tail)


def ported(cfg) -> bool:
    return all(bt in PORTED_BLOCKS for bt in layer_types(cfg))


def paged_ok(cfg) -> bool:
    """Every block of the arch can serve from a paged KV cache (the
    reference's ``models.paged_ok``)."""
    pattern, _, tail = block_program(cfg)
    return all(bt in PAGED_BLOCKS for bt in pattern + tail)


def init_params(cfg, seed: int = 0, device="cuda"):
    """Random weights from a ``torch.Generator`` on ``device`` (normal,
    scaled as the reference's init). Not the reference's bits: parity tests
    convert the JAX package's weights with ``convert.params_from_jax``.
    An audio arch has no ``embed`` (its frontend is stubbed: frames come
    in as embeddings), as in the reference."""
    device = resolve_device(device)
    dtype = dtype_of(cfg)
    # the meta device (``param_specs``) draws nothing: a CPU generator
    gen = torch.Generator(device="cpu" if device.type == "meta" else device)
    gen.manual_seed(seed)
    d, v = cfg.d_model, cfg.vocab_size
    params = {
        "layers": [init_block(cfg, bt, gen, dtype, device)
                   for bt in layer_types(cfg)],
        "final_norm": init_norm(cfg, d, dtype, device),
    }
    if cfg.modality != "audio":
        params["embed"] = (torch.randn((v, d), generator=gen, device=device)
                           * d ** -0.5).to(dtype)
    if not cfg.tie_embeddings:
        params["lm_head"] = (torch.randn((d, v), generator=gen,
                                         device=device)
                             * d ** -0.5).to(dtype)
    return params


def param_specs(cfg):
    """The params' shapes and dtypes, on the meta device (nothing is
    allocated): the reference's ``param_specs``, one entry per layer."""
    return init_params(cfg, 0, device="meta")


def param_count_tree(params) -> int:
    """Elements over every leaf of a params tree (meta tensors count)."""
    return sum(t.numel() for t in leaves(params))


def cache_specs(cfg, batch: int, window: int, kv_dtype: str = ""):
    """The rolling cache's shapes and dtypes, on the meta device."""
    return init_cache(cfg, batch, window, device="meta", kv_dtype=kv_dtype)


def init_cache(cfg, batch: int, window: int, device="cuda",
               kv_dtype: str = ""):
    """Rolling decode caches: per layer a KV ring (B, W, kv, hd) or the
    RG-LRU or SSD conv window and state (``blocks.init_block_cache``),
    plus each slot's position ``pos`` (B,) int32. ``kv_dtype`` "int8":
    int8 rings with float32 scales."""
    if not ported(cfg):
        raise ValueError(f"{cfg.name}: arch has blocks the port does not "
                         f"serve yet")
    device = resolve_device(device)
    dtype = dtype_of(cfg)
    return {
        "layers": [init_block_cache(cfg, bt, batch, window, dtype, device,
                                    kv_dtype)
                   for bt in layer_types(cfg)],
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def init_paged_cache(cfg, batch: int, n_pages: int, page_size: int,
                     max_pages_per_slot: int, device="cuda",
                     kv_dtype: str = ""):
    """One page pool pair per layer plus one page-table row and position
    per slot. Table entries start at 0 — the reserved trash page.
    ``kv_dtype`` "int8": int8 pools with float32 scale pools."""
    if not ported(cfg):
        raise ValueError(f"{cfg.name}: arch has blocks the port does not "
                         f"serve yet")
    device = resolve_device(device)
    dtype = dtype_of(cfg)
    return {
        "layers": [init_paged_block_cache(cfg, n_pages, page_size, dtype,
                                          device, kv_dtype)
                   for _ in layer_types(cfg)],
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
        "page_table": torch.zeros((batch, max_pages_per_slot),
                                  dtype=torch.int32, device=device),
    }


#: attention/MLP matmul weights eligible for weight-only int8. Embeddings,
#: the lm head and norms stay in the model dtype.
QUANT_WEIGHT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _quantize_leaf(w):
    """Symmetric per-output-channel int8 over the contraction axis, as the
    reference: ``{"w_q": int8 (K, N), "scale": float32 (1, N)}``."""
    w_q, scale = ops.quantize_int8(w)
    return {"w_q": w_q, "scale": scale.reshape(1, -1)}


def quantize_weights(cfg, params):
    """Weight-only int8 (the reference's ``model.quantize_weights``): each
    attention/MLP matmul weight of every layer becomes a ``{"w_q",
    "scale"}`` dict, which ``blocks.linear`` dispatches to the int8
    matmul kernel (``validate()`` refuses int8 weights on archs with other
    blocks: an rglru or ssd mixer is never quantized). Returns new
    params; the input is left as it is. Leaves
    quantized already (another engine's params) are kept as they are, so
    replicas share one set of int8 weights."""
    layers = []
    for p in params["layers"]:
        p = dict(p)
        for sub in ("attn", "mlp"):
            if sub in p:
                p[sub] = {k: (_quantize_leaf(v) if k in QUANT_WEIGHT_KEYS
                              and not isinstance(v, dict) else v)
                          for k, v in p[sub].items()}
        layers.append(p)
    return {**params, "layers": layers}


def _embed(params, tokens):
    return params["embed"][tokens.to(torch.int64)]


def _embed_scaled(cfg, params, tokens):
    """The token embeddings times ``cfg.embedding_multiplier`` (when not
    1: Granite's x 12)."""
    x = _embed(params, tokens)
    m = cfg.embedding_multiplier
    return x if m == 1.0 else x * m


# ---------------------------------------------------------------------------
# sharded replicas
# ---------------------------------------------------------------------------


def shard_params(cfg, params, mesh) -> Shards:
    """Shard j's params on ``mesh.flat[j]``, laid out by ``param_pspecs``
    under ``serving_policy``: column blocks of the _COL projections, vocab
    blocks of ``embed`` / ``lm_head``, expert or ff blocks of the MoE
    stacks, every other leaf whole (``sharding.place``: a whole leaf
    already on a shard's device is shared, not copied); the data rows hold
    the same blocks. A float32 copy of the shard's lm-head block
    (``lm_head_f32``) is added under a narrower model dtype; a copy the
    caller made of the whole head is not used."""
    base = {k: v for k, v in params.items() if k != "lm_head_f32"}
    trees = place(base, param_pspecs(cfg, base, serving_policy(cfg, mesh)),
                  mesh)
    if dtype_of(cfg) != F32:
        made = {}  # the data rows' shards on a device share one copy
        for p in trees:
            src = p.get("lm_head", p["embed"])
            key = (src.data_ptr(), tuple(src.shape), str(src.device))
            if key not in made:
                made[key] = head_f32(p)
            p["lm_head_f32"] = made[key]
    return Shards(trees, mesh)


def _pool_leaf(path: str) -> bool:
    return path.startswith("layers/")


def shard_cache(cfg, cache, mesh, *, paged: bool) -> Shards:
    """Shard j's cache on ``mesh.flat[j]`` from ``cache`` (meta tensors
    give zeros): page pools, and the B=1 working buffers gathered from and
    scattered into them, by ``paged_cache_pspecs``, each pool one tensor
    for the data rows on a device (they hold it whole and write into it
    alike); rolling caches by ``cache_pspecs`` (the slots split over the
    data rows when they divide). Positions and page tables are whole on
    every shard. Paged pools of data rows on different devices would need
    every write broadcast to each row's copy, which the port does not do:
    refused."""
    pol = serving_policy(cfg, mesh)
    specs = (paged_cache_pspecs if paged else cache_pspecs)(
        cfg, cache, pol, mesh)
    if paged and mesh.shape.get("data", 1) > 1:
        cols = mesh.devices.T
        if any(len({str(d) for d in col}) > 1 for col in cols):
            raise ValueError(
                f"paged pools over data rows on different devices "
                f"({[str(d) for d in mesh.flat]}): every row would hold "
                f"its own copy and miss the other rows' writes; stack each "
                f"model shard's rows on one device, serve rolling caches "
                f"(paged=False), or see ROADMAP.md queue 1, 'Multi-GPU' "
                f"item 4c")
    return Shards(place(cache, specs, mesh,
                        shared=_pool_leaf if paged else None), mesh)


def _grid(mesh, b: int):
    """(tp, split, slices): the model group's width, whether the data rows
    split the batch of ``b`` (when they divide it: the reference's
    ``_batch_dim_spec``; else every row runs the whole batch), and each
    shard's slice of the batch."""
    dp, tp = mesh.shape.get("data", 1), mesh.shape.get("model", 1)
    split = dp > 1 and b % dp == 0
    w = b // dp if split else b
    rows = [slice(r * w, r * w + w) if split else slice(None)
            for r in range(dp)]
    return tp, split, [sl for sl in rows for _ in range(tp)]


def _embed_sharded(cfg, shards, toks):
    """Every shard's token embeddings (B, S, d), whole, within one model
    group: under a vocab split each shard looks up the tokens its block
    owns (clamped elsewhere), and each token's row is taken from its
    owner's concatenated rows."""
    vb = shards[0]["embed"].shape[0]
    if vb == cfg.vocab_size:
        return [_embed(p, t) for p, t in zip(shards, toks)]
    rows = [p["embed"][torch.clamp(t.to(torch.int64) - j * vb, 0, vb - 1)]
            for j, (p, t) in enumerate(zip(shards, toks))]
    xs = []
    for t in toks:
        owner = (t.to(torch.int64) // vb)[None, :, :, None]
        xs.append(torch.take_along_dim(
            gather([r[None] for r in rows], t.device, dim=0), owner,
            dim=0)[0])
    return xs


def _logits_sharded(cfg, shards, xs):
    """The logits (B, ..., V) float32 on the first shard's device of one
    model group: each shard's vocab block, concatenated (the reference
    replicates them before its sampler), or the first shard's whole
    product when the head is not split."""
    if head_f32(shards[0]).shape[-1] == cfg.vocab_size:
        return _logits(cfg, shards[0], xs[0])
    return gather([_logits(cfg, p, x) for p, x in zip(shards, xs)],
                  xs[0].device)


def _logits_grid(cfg, shards, xs, tp: int, split: bool):
    """The logits of every data row, concatenated in slot order on the
    first shard's device (the first row's alone when every row ran the
    whole batch)."""
    if not split:
        return _logits_sharded(cfg, shards[:tp], xs[:tp])
    return gather([_logits_sharded(cfg, p, x) for p, x in zip(
        rows_of(shards, tp), rows_of(xs, tp))], xs[0].device, dim=0)


def _at(xs, logits_at):
    if logits_at is None:
        return xs
    return [x[torch.arange(x.shape[0], device=x.device),
              at.to(x.device, torch.int64)] for x, at in zip(xs, logits_at)]


def _forward_sharded(cfg, shards, tokens, *, logits_at, want_kv, cache,
                     positions, moe_dispatch):
    """``forward`` (prefill mode) over a sharded replica: each data row
    over its block of the batch (or all of it), its model group
    tensor-parallel. kv, when wanted, is per shard the per-layer (k, v)
    of the heads it stores, for its row's batch."""
    devs = shards.mesh.flat
    b, s = tokens.shape
    tp, split, sl = _grid(shards.mesh, b)
    toks = [tokens[sl[j]].to(d) for j, d in enumerate(devs)]
    xs = by_rows(lambda p, t: _embed_sharded(cfg, p, t), tp, shards, toks)
    ropes = [_rope(cfg, None if positions is None
                   else positions[:, sl[j]].to(d),
                   lambda t=t, d=d: torch.arange(s, device=d)[None].expand(
                       t.shape[0], s))
             for j, (t, d) in enumerate(zip(toks, devs))]
    kvs = [[] for _ in devs]
    for i, bt in enumerate(layer_types(cfg)):
        xs, kv = apply_block_sharded(
            cfg, bt, [p["layers"][i] for p in shards], xs, ropes,
            mode="prefill", tp=tp, split=split, moe_dispatch=moe_dispatch,
            caches=None if cache is None else [c["layers"][i]
                                               for c in cache])
        for j in range(len(devs)):
            kvs[j].append(kv[j] if want_kv and kv is not None else None)
    if cache is not None:
        for c in cache:
            c["pos"].fill_(s)
    ats = None if logits_at is None else [logits_at[x] for x in sl]
    return (_logits_grid(cfg, shards, _at(xs, ats), tp, split),
            kvs if want_kv else None)


def _decode_sharded(cfg, shards, cache, tokens, *, logits_at, positions,
                    moe_dispatch):
    """``decode_step`` over a sharded replica: each data row over its
    block of the slots (or all of them) from its shards' caches (its
    block of the rings and states; the pools whole and shared), every
    shard's copy of the positions and page table advanced alike."""
    devs = shards.mesh.flat
    b, s = tokens.shape
    tp, split, sl = _grid(shards.mesh, b)
    toks = [tokens[sl[j]].to(d) for j, d in enumerate(devs)]
    xs = by_rows(lambda p, t: _embed_sharded(cfg, p, t), tp, shards, toks)
    poss = [c["pos"][sl[j]] for j, c in enumerate(cache)]
    pagess = [None if c.get("page_table") is None else
              c["page_table"][sl[j]] for j, c in enumerate(cache)]
    ropes = [_rope(cfg, None if positions is None
                   else positions[:, sl[j]].to(d),
                   lambda p=p, d=d: p.to(torch.int64)[:, None]
                   + torch.arange(s, device=d)[None, :])
             for j, (p, d) in enumerate(zip(poss, devs))]
    write_ats = [None if pages is None else paged_write_index(
        pages, pos, s, c["layers"][0]["k"].shape[1],
        resolve_duplicates=cfg.arch_type == "moe")
        for pages, pos, c in zip(pagess, poss, cache)]
    n_valids = [(pos + s).to(torch.int32) for pos in poss]
    for i, bt in enumerate(layer_types(cfg)):
        xs, _ = apply_block_sharded(
            cfg, bt, [p["layers"][i] for p in shards], xs, ropes,
            mode="decode", tp=tp, split=split,
            caches=[c["layers"][i] for c in cache], poss=poss,
            pagess=pagess, write_ats=write_ats, n_valids=n_valids,
            moe_dispatch=moe_dispatch)
    for c in cache:
        c["pos"].add_(s)
    ats = None if logits_at is None else [logits_at[x] for x in sl]
    return _logits_grid(cfg, shards, _at(xs, ats), tp, split)


def _embed_inputs(cfg, params, tokens, patches):
    """The sequence's input embeddings (B, S, d): an audio arch's frames
    (``tokens`` is then (B, S, d)) cast to the model dtype; else the token
    embeddings, after ``patches`` on a ``vision_text`` arch (early
    fusion)."""
    if cfg.modality == "audio":
        return tokens.to(dtype_of(cfg))
    x = _embed_scaled(cfg, params, tokens)
    if cfg.modality == "vision_text" and patches is not None:
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    return x


def head_f32(params):
    """The lm head in float32 (the reference's ``preferred_element_type``
    product): a cached float32 copy when the caller made one, else an
    upcast per call."""
    if "lm_head_f32" in params:
        return params["lm_head_f32"]
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return head.to(F32)


def _logits(cfg, params, x):
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = torch.matmul(x.to(F32), head_f32(params))
    s = cfg.logits_scaling
    return logits if s == 1.0 else logits / s


def _rope(cfg, positions, default):
    """The step's rotation table: mrope from the caller's (3, B, S)
    ``positions`` (required, as the reference's), any other variant from
    ``positions`` or, when None, the (B, S) ``default()``."""
    if cfg.rope_variant == "mrope" and positions is None:
        raise ValueError(f"{cfg.name}: mrope needs (3, B, S) positions")
    return L.rope_table(cfg, default() if positions is None else positions)


def _train_layers(cfg, params, x, rope, moe_dispatch, parallel_block):
    """The layers in train mode: the body's repeats of the block pattern
    each recomputed in backward (``torch.utils.checkpoint``, non-
    reentrant: the reference's ``jax.checkpoint`` of each blockset with
    ``nothing_saveable``), the tail's blocks not. Returns (x, aux summed
    over the layers)."""
    pattern, n_repeat, _ = block_program(cfg)
    types = layer_types(cfg)

    def run(x, lo, hi):
        aux = 0.0
        for bt, p in zip(types[lo:hi], params["layers"][lo:hi]):
            x, _, a = apply_block(cfg, bt, p, x, rope, mode="train",
                                  moe_dispatch=moe_dispatch,
                                  parallel_block=parallel_block)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=F32, device=x.device)
    n = len(pattern)
    for r in range(n_repeat):
        if torch.is_grad_enabled():
            x, a = checkpoint(run, x, r * n, (r + 1) * n,
                              use_reentrant=False)
        else:
            x, a = run(x, r * n, (r + 1) * n)
        aux = aux + a
    x, a = run(x, n_repeat * n, len(types))
    return x, aux + a


def forward(cfg, params, tokens, *, logits_at: Optional[torch.Tensor] = None,
            want_kv: bool = False, cache: Optional[dict] = None,
            patches: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            moe_dispatch: str = "factor", mode: str = "prefill",
            parallel_block: bool = False):
    """Full-sequence forward, causal unless the arch is an encoder.
    tokens (B, S) integer, or an audio arch's frames (B, S, d);
    ``patches`` (B, P, d) go ahead of the tokens on a ``vision_text`` arch
    (early fusion: the sequence is then P + S long).

    mode "prefill" returns (logits, kv): logits (B, S, V) float32, or
    (B, V) at the positions ``logits_at`` (B,) when given; kv is the
    per-layer list of the prompt's (k, v), each (B, S, kv, hd), when
    ``want_kv``. A fresh rolling ``cache`` (``init_cache``) is filled in
    place: every ring with the prompt's last keys, every RG-LRU and SSD
    conv window and state, and ``pos`` = the sequence's length.

    mode "train" (the reference's ``forward(mode="train")``) returns
    (logits (B, S, V) float32, aux): aux is the float32 sum of the MoE
    blocks' Switch load-balance terms (0 on other archs). Under grad mode
    each repeat of the block pattern is recomputed in backward; nothing
    is cached."""
    if mode not in ("prefill", "train"):
        raise ValueError(f"forward: mode {mode!r} not in ('prefill', "
                         f"'train')")
    if isinstance(params, Shards):
        if mode != "prefill" or patches is not None or parallel_block:
            raise ValueError("forward: a sharded replica serves token "
                             "prefill only (no train mode, no patches, no "
                             "parallel_block)")
        return _forward_sharded(cfg, params, tokens, logits_at=logits_at,
                                want_kv=want_kv, cache=cache,
                                positions=positions,
                                moe_dispatch=moe_dispatch)
    x = _embed_inputs(cfg, params, tokens, patches)
    b, s = x.shape[:2]
    rope = _rope(cfg, positions, lambda: torch.arange(
        s, device=tokens.device)[None].expand(b, s))
    if mode == "train":
        if cache is not None or want_kv or logits_at is not None:
            raise ValueError("forward: mode 'train' takes no cache, "
                             "want_kv or logits_at")
        x, aux = _train_layers(cfg, params, x, rope, moe_dispatch,
                               parallel_block)
        return _logits(cfg, params, x), aux
    kvs = []
    layer_caches = (cache["layers"] if cache is not None
                    else [None] * cfg.num_layers)
    for bt, p, c in zip(layer_types(cfg), params["layers"], layer_caches):
        x, kv, _ = apply_block(cfg, bt, p, x, rope, mode="prefill",
                               cache=c, moe_dispatch=moe_dispatch,
                               parallel_block=parallel_block)
        if want_kv:
            kvs.append(kv)
    if cache is not None:
        cache["pos"].fill_(s)
    if logits_at is not None:
        x = x[torch.arange(b, device=x.device), logits_at.to(torch.int64)]
    return _logits(cfg, params, x), (kvs if want_kv else None)


def decode_step(cfg, params, cache, tokens, *,
                logits_at: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None,
                moe_dispatch: str = "factor", parallel_block: bool = False):
    """Incremental decode against the paged cache (``init_paged_cache``)
    or the rolling one (``init_cache``). tokens (B, S): S=1 is the
    one-token decode step, S > 1 a chunk of prefill (recurrent blocks
    take S=1 only). Writes the S tokens' K/V into the pools or rings,
    steps every recurrent state and advances ``cache["pos"]`` by S, in
    place (never rebinding it: a captured CUDA graph keeps reading the
    tensor it was captured with). Returns logits (B, S, V) float32, or
    (B, V) at the chunk offsets ``logits_at`` (B,) when given.
    ``parallel_block`` as in ``forward``."""
    if isinstance(params, Shards):
        if parallel_block:
            raise ValueError("decode_step: parallel_block is a one-card "
                             "option")
        return _decode_sharded(cfg, params, cache, tokens,
                               logits_at=logits_at, positions=positions,
                               moe_dispatch=moe_dispatch)
    b, s = tokens.shape
    pos = cache["pos"]
    pages = cache.get("page_table")
    x = _embed_scaled(cfg, params, tokens)
    # what every layer shares, built once per step
    rope = _rope(cfg, positions, lambda: pos.to(torch.int64)[:, None]
                 + torch.arange(s, device=tokens.device)[None, :])
    # idle lanes share the trash page's rows; on a MoE arch their state
    # routes beside live tokens, so their writes must land alike on any
    # device (the last writer wins, as on the CPU)
    write_at = (None if pages is None else paged_write_index(
        pages, pos, s, cache["layers"][0]["k"].shape[1],
        resolve_duplicates=cfg.arch_type == "moe"))
    n_valid = (pos + s).to(torch.int32)
    for bt, p, c in zip(layer_types(cfg), params["layers"], cache["layers"]):
        x, _, _ = apply_block(cfg, bt, p, x, rope, mode="decode", cache=c,
                              pos=pos, pages=pages, write_at=write_at,
                              n_valid=n_valid, moe_dispatch=moe_dispatch,
                              parallel_block=parallel_block)
    cache["pos"].add_(s)  # after the layers' last read of the old value
    if logits_at is not None:
        x = x[torch.arange(b, device=x.device), logits_at.to(torch.int64)]
    return _logits(cfg, params, x)
