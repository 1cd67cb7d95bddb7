"""The one dispatch point per kernel (the port's counterpart of the JAX
package's ``kernels/ops.py``). Each takes the model layout; a CPU tensor
runs the plain PyTorch version, a CUDA tensor the hand-written kernel (a
meta tensor, shapes only, the plain version's shapes: the dry run).
Prefill attention and the RG-LRU scan go through their autograd
``Function`` on the card whenever grad mode is on and an input requires
grad (the kernel forward, the plain version's gradients backward); every
other kernel has no backward, and its wrapper refuses such inputs."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import rglru_scan as _scan
from repro_torch.kernels.build import LAUNCHES
from repro_torch.kernels.decode_attention import (
    decode_attention,
    paged_decode_attention,
    paged_decode_attention_int8,
)
from repro_torch.kernels.int8_matmul import int8_matmul, quantize_int8
from repro_torch.kernels.moe_grouped import moe_grouped
from repro_torch.kernels.ssd_step import ssd_step
from repro_torch.kernels.topk_sample import (
    path_rows,
    reset_path_rows,
    sample_tokens,
    topk_sample,
)

__all__ = ["LAUNCHES", "decode_attention", "flash_attention", "int8_matmul",
           "moe_grouped", "paged_decode_attention",
           "paged_decode_attention_int8",
           "path_rows", "quantize_int8", "reset_launches", "rglru_scan",
           "sample_tokens", "ssd_step", "topk_sample"]


def reset_launches():
    """Every kernel's launch count, and the sampler's rows by path, to 0."""
    build.reset_launches()
    reset_path_rows()


def _autograd(*tensors) -> bool:
    """On the card, with grad mode on and an input that requires grad."""
    return (tensors[0].device.type == "cuda" and torch.is_grad_enabled()
            and any(t.requires_grad for t in tensors))


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    if _autograd(q, k, v):
        return _flash.FlashAttention.apply(q, k, v, causal, window)
    return _flash.flash_attention(q, k, v, causal=causal, window=window)


def rglru_scan(a, x, h0):
    if _autograd(a, x, h0):
        return _scan.RGLRUScan.apply(a, x, h0)
    return _scan.rglru_scan(a, x, h0)
