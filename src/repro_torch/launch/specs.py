"""Shape-only stand-ins for every model input of the dry run (the JAX
package's ``repro/launch/specs.py``): trees of tensors on the meta
device, which carry shapes and dtypes and allocate nothing.

``input_specs(cfg, shape)`` gives the batch inputs of a train, prefill
or decode shape; a decode shape also needs ``decode_cache_specs``. The
vision and audio frontends are stubbed as in the reference: the specs
carry precomputed patch or frame embeddings of the right shape.
``opt_state_specs`` is the AdamW state of a params tree, on the meta
device too.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import cache_specs, dtype_of
from repro_torch.training.optimizer import init_adamw

VLM_PATCHES = 1024  # early-fusion vision prefix length (stub frontend)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def decode_window(cfg, seq_len: int) -> int:
    """KV window of a decode shape: the whole context at 32k; the model's
    sliding window past 100k tokens (full-attention archs that have one);
    1 on an SSM arch, whose decode carries O(1) state whatever the
    context (the window is vestigial). A local-attention block's ring is
    capped at its own window where the cache is built
    (``blocks.init_block_cache`` through ``blocks.attn_cache_window``)."""
    if seq_len > 100_000 and cfg.sliding_window_decode:
        return cfg.sliding_window_decode
    if cfg.arch_type == "ssm":
        return 1
    return seq_len


def input_specs(cfg, shape) -> Dict[str, torch.Tensor]:
    """The batch of ``shape`` (a ``configs.ShapeConfig``): tokens (and
    labels when training), an audio arch's frames, a vision arch's
    patches and (3, B, S) positions; decode: one new token a slot (and
    its mrope positions)."""
    b, s = shape.global_batch, shape.seq_len
    model_dtype = dtype_of(cfg)
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        if cfg.modality == "audio":
            batch = {"frames": _meta((b, s, cfg.d_model), model_dtype)}
            if shape.kind == "train":
                batch["labels"] = _meta((b, s), i32)
            return batch
        if cfg.modality == "vision_text":
            p = min(VLM_PATCHES, s // 2)
            batch = {"tokens": _meta((b, s - p), i32),
                     "patches": _meta((b, p, cfg.d_model), model_dtype),
                     "positions": _meta((3, b, s), i32)}
            if shape.kind == "train":
                batch["labels"] = _meta((b, s - p), i32)
            return batch
        batch = {"tokens": _meta((b, s), i32)}
        if shape.kind == "train":
            batch["labels"] = _meta((b, s), i32)
        return batch
    batch = {"tokens": _meta((b, 1), i32)}
    if cfg.rope_variant == "mrope":
        batch["positions"] = _meta((3, b, 1), i32)
    return batch


def decode_cache_specs(cfg, shape, kv_dtype: str = ""):
    """The rolling decode cache of a decode shape: ``global_batch`` slots,
    rings of ``decode_window``; ``kv_dtype`` "int8": int8 rings and their
    float32 scales."""
    if shape.kind != "decode":
        raise ValueError(f"decode_cache_specs: {shape.name} is a "
                         f"{shape.kind} shape")
    return cache_specs(cfg, shape.global_batch,
                       decode_window(cfg, shape.seq_len), kv_dtype)


def opt_state_specs(cfg, params_specs):
    """The AdamW state (step, float32 master, m, v) of ``params_specs``,
    on the meta device."""
    del cfg
    return init_adamw(params_specs)
