"""Model of the PyTorch port: block program -> an unrolled loop over
layers (the JAX package scans stacked weights; the port keeps one param
dict per layer, in scan order).

Public API (device explicit everywhere):
  block_program(cfg)                          -> (pattern, n_repeat, tail)
  init_params(cfg, seed, device)              -> params dict (random weights)
  init_cache(cfg, batch, window, device)      -> rolling caches (rings,
                                                 RG-LRU states, pos)
  init_paged_cache(cfg, batch, n_pages, page_size, max_pages, device,
                   kv_dtype)
  quantize_weights(cfg, params)               -> params with int8 leaves
  forward(cfg, params, tokens, ...)           -> (logits, per-layer (k, v));
                                                 fills a rolling cache
  decode_step(cfg, params, cache, tokens)     -> logits (B, S, V); cache
                                                 (paged or rolling) updated
                                                 in place
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.blocks import (
    PAGED_BLOCKS,
    PORTED_BLOCKS,
    apply_block,
    init_block,
    init_block_cache,
    init_norm,
    init_paged_block_cache,
    paged_write_index,
)

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
    convert the JAX package's weights with ``convert.params_from_jax``."""
    device = resolve_device(device)
    dtype = dtype_of(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, v = cfg.d_model, cfg.vocab_size
    params = {
        "layers": [init_block(cfg, bt, gen, dtype, device)
                   for bt in layer_types(cfg)],
        "final_norm": init_norm(cfg, d, dtype, device),
        "embed": (torch.randn((v, d), generator=gen, device=device)
                  * d ** -0.5).to(dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = (torch.randn((d, v), generator=gen,
                                         device=device)
                             * d ** -0.5).to(dtype)
    return params


def init_cache(cfg, batch: int, window: int, device="cuda",
               kv_dtype: str = ""):
    """Rolling decode caches: per layer a KV ring (B, W, kv, hd) or the
    RG-LRU conv window and state (``blocks.init_block_cache``), plus each
    slot's position ``pos`` (B,) int32. ``kv_dtype`` "int8": int8 rings
    with float32 scales."""
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
    matmul kernel. Returns new params; the input is left as it is. Leaves
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
    return torch.matmul(x.to(F32), head_f32(params))


def forward(cfg, params, tokens, *, logits_at: Optional[torch.Tensor] = None,
            want_kv: bool = False, cache: Optional[dict] = None):
    """Full-sequence causal forward (prefill). tokens (B, S) integer.
    Returns (logits, kv): logits (B, S, V) float32, or (B, V) at the
    positions ``logits_at`` (B,) when given; kv is the per-layer list of
    the prompt's (k, v), each (B, S, kv, hd), when ``want_kv``. A fresh
    rolling ``cache`` (``init_cache``) is filled in place: every ring with
    the prompt's last keys, every RG-LRU state, and ``pos`` = S."""
    b, s = tokens.shape
    x = _embed(params, tokens)
    rope_pos = torch.arange(s, device=tokens.device)[None].expand(b, s)
    rope = L.rope_table(cfg, rope_pos)
    kvs = []
    layer_caches = (cache["layers"] if cache is not None
                    else [None] * cfg.num_layers)
    for bt, p, c in zip(layer_types(cfg), params["layers"], layer_caches):
        x, kv = apply_block(cfg, bt, p, x, rope, mode="prefill", cache=c)
        if want_kv:
            kvs.append(kv)
    if cache is not None:
        cache["pos"].fill_(s)
    if logits_at is not None:
        x = x[torch.arange(b, device=x.device), logits_at.to(torch.int64)]
    return _logits(cfg, params, x), (kvs if want_kv else None)


def decode_step(cfg, params, cache, tokens, *,
                logits_at: Optional[torch.Tensor] = None):
    """Incremental decode against the paged cache (``init_paged_cache``)
    or the rolling one (``init_cache``). tokens (B, S): S=1 is the
    one-token decode step, S > 1 a chunk of prefill (recurrent blocks
    take S=1 only). Writes the S tokens' K/V into the pools or rings,
    steps every recurrent state and advances ``cache["pos"]`` by S, in
    place (never rebinding it: a captured CUDA graph keeps reading the
    tensor it was captured with). Returns logits (B, S, V) float32, or
    (B, V) at the chunk offsets ``logits_at`` (B,) when given."""
    b, s = tokens.shape
    pos = cache["pos"]
    pages = cache.get("page_table")
    x = _embed(params, tokens)
    rope_pos = pos.to(torch.int64)[:, None] + torch.arange(
        s, device=tokens.device)[None, :]
    # what every layer shares, built once per step
    rope = L.rope_table(cfg, rope_pos)
    write_at = (None if pages is None else paged_write_index(
        pages, pos, s, cache["layers"][0]["k"].shape[1]))
    n_valid = (pos + s).to(torch.int32)
    for bt, p, c in zip(layer_types(cfg), params["layers"], cache["layers"]):
        x, _ = apply_block(cfg, bt, p, x, rope, mode="decode", cache=c,
                           pos=pos, pages=pages, write_at=write_at,
                           n_valid=n_valid)
    cache["pos"].add_(s)  # after the layers' last read of the old value
    if logits_at is not None:
        x = x[torch.arange(b, device=x.device), logits_at.to(torch.int64)]
    return _logits(cfg, params, x)
