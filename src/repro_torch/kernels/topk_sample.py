"""The decode sampling tail: wrappers of the hand-written Hopper kernel
``csrc/sampling.cu`` (the port of TPU kernel 3,
``repro/kernels/topk_sample.py::topk_sample``) beside their plain
versions in ``plain``.

``sample_tokens`` is what the engine calls (the semantics of
``plain.sample_tokens``: greedy mask, temperature, top-k, top-p, one
uniform per row, inverse CDF); ``topk_sample`` keeps the Pallas kernel's
own semantics (Gumbel argmax over (B, V) uniforms). A cluster of 8 blocks
per row keeps the whole row in their shared memories (an eighth each), so
the vocabulary must fit in 8 blocks' shared memory: recurrentgemma's
256000 takes 128,000 B per block. A CPU tensor goes to the plain version;
a CUDA tensor launches the kernel or raises."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import plain

SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
_STATIC = 1024  # the kernels' own reduction scratch, rounded up
CLUSTER = 8  # blocks per row (the portable thread-block cluster size)


def max_vocab() -> int:
    return CLUSTER * ((SMEM_LIMIT - _STATIC) // 4)


def _check_rows(name, logits, *rows):
    if logits.dim() != 2:
        raise ValueError(f"{name}: logits must be (B, V), got "
                         f"{tuple(logits.shape)}")
    b = logits.shape[0]
    for r in rows:
        if r.shape[0] != b or r.device != logits.device:
            raise ValueError(f"{name}: per-row input of shape "
                             f"{tuple(r.shape)} on {r.device} does not "
                             f"match logits {tuple(logits.shape)} on "
                             f"{logits.device}")


def _check_cuda(name, logits, typed):
    if logits.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {logits.device}")
    v = logits.shape[1]
    if v > max_vocab():
        raise ValueError(f"{name}: a vocabulary of {v} does not fit in "
                         f"{CLUSTER} blocks' shared memory (at most "
                         f"{max_vocab()} float32 logits)")
    for t, dt in typed:
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous {dt}, got "
                             f"{t.dtype} (contiguous={t.is_contiguous()})")


def sample_tokens(logits, greedy, temperature, top_k, top_p, uniform):
    """logits (B, V) float32; greedy (B,) bool; temperature, top_p,
    uniform (B,) float32; top_k (B,) int32. Returns (B,) int32."""
    _check_rows("sample_tokens", logits, greedy, temperature, top_k, top_p,
                uniform)
    if logits.device.type == "cpu":
        return plain.sample_tokens(logits, greedy, temperature, top_k, top_p,
                               uniform)
    _check_cuda("sample_tokens", logits,
                [(logits, torch.float32), (greedy, torch.bool),
                 (temperature, torch.float32), (top_k, torch.int32),
                 (top_p, torch.float32), (uniform, torch.float32)])
    b, v = logits.shape
    out = torch.empty((b,), dtype=torch.int32, device=logits.device)
    lib = build.load()
    lib.call("sample_tokens_f32", logits.data_ptr(), greedy.data_ptr(),
             temperature.data_ptr(), top_k.data_ptr(), top_p.data_ptr(),
             uniform.data_ptr(), out.data_ptr(), b, v,
             torch.cuda.current_stream(logits.device).cuda_stream)
    build.LAUNCHES["sample_tokens"] += 1
    return out


def topk_sample(logits, k, temperature, uniform):
    """logits (B, V) float32; k (B,) int32 in [1, V]; temperature (B,) > 0;
    uniform (B, V) in [0, 1). Returns (B,) int32."""
    _check_rows("topk_sample", logits, k, temperature, uniform)
    if logits.device.type == "cpu":
        return plain.topk_sample(logits, k, temperature, uniform)
    _check_cuda("topk_sample", logits,
                [(logits, torch.float32), (k, torch.int32),
                 (temperature, torch.float32), (uniform, torch.float32)])
    if uniform.shape != logits.shape:
        raise ValueError("topk_sample: uniform must be (B, V)")
    b, v = logits.shape
    out = torch.empty((b,), dtype=torch.int32, device=logits.device)
    lib = build.load()
    lib.call("topk_sample_f32", logits.data_ptr(), k.data_ptr(),
             temperature.data_ptr(), uniform.data_ptr(), out.data_ptr(), b, v,
             torch.cuda.current_stream(logits.device).cuda_stream)
    build.LAUNCHES["topk_sample"] += 1
    return out
