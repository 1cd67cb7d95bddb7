"""Prefill attention: the wrapper of the hand-written Hopper kernel
``csrc/flash_attention.cu`` (the port of TPU kernel 1,
``repro/kernels/flash_attention.py::flash_attention``) beside its plain
version ``plain.dense_attention``.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
or raises. q (B, S, H, D), k/v (B, S, KVH, D), float32 or bfloat16, any S,
head_dim 32, 64, 128 or 256; q head h reads kv head ``h // (H // KVH)``
inside the kernel. ``window`` > 0 is local attention: query s sees keys
t > s - window (the local-attention blocks of hybrid archs).

bfloat16 runs on the tensor cores in one pass, float32 on the FMA
kernel, as the source note says; the kernel fixes its tile geometry per
head_dim."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import plain

_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: want q (B,S,H,D), k/v "
                         f"(B,S,KVH,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d \
            or h % k.shape[2]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if q.device.type == "cpu":
        return plain.dense_attention(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    if q.dtype not in _ENTRY or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention: float32 or bfloat16 q/k/v "
                         f"required, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in (32, 64, 128, 256):
        raise ValueError(f"flash_attention: head_dim {d} not in "
                         f"(32, 64, 128, 256)")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_attention: q, k and v must be 16-byte "
                         "aligned (the kernel's vector loads)")
    out = torch.empty_like(q)
    lib = build.load()
    lib.call(_ENTRY[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), b, s, h, k.shape[2], d, d ** -0.5, int(causal),
             int(window), torch.cuda.current_stream(q.device).cuda_stream)
    build.LAUNCHES["flash_attention"] += 1
    return out
