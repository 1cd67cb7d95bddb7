"""Prefill attention: the wrapper of the hand-written Hopper kernel
``csrc/flash_attention.cu`` (the port of TPU kernel 1,
``repro/kernels/flash_attention.py::flash_attention``) beside its plain
version ``plain.dense_attention``, and its autograd ``Function``.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
or raises. q (B, S, H, D), k/v (B, S, KVH, D), float32 or bfloat16, any S,
head_dim 32, 64, 80 (hubert-xlarge), 128 or 256; q head h reads kv head
``h // (H // KVH)`` inside the kernel. ``causal`` False attends every key
(an encoder's bidirectional attention); ``window`` > 0 is local attention:
query s sees keys t > s - window (the local-attention blocks of hybrid
archs).

bfloat16 runs on the tensor cores in one pass, float32 on the FMA
kernel, as the source note says; the kernel fixes its tile geometry per
head_dim.

``FlashAttention`` carries gradients: its forward launches the kernel and
keeps q, k, v; its backward recomputes the plain version under autograd
(the reference differentiates ``layers.attention`` with XLA: no Pallas
kernel has a backward) and returns its gradients, one batch row and one
slice of kv heads at a time, so no chunk's float32 scores pass
``BACKWARD_SCORE_BYTES``. ``ops.flash_attention`` routes through it
whenever grad mode is on and an input requires grad; the kernel wrapper
itself refuses such inputs rather than return a result cut from the
graph."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import plain

_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
HEAD_DIMS = (32, 64, 80, 128, 256)
#: float32 scores (and each of their softmax intermediates) one backward
#: chunk may hold: 1 GiB, so a chunk's plain backward peaks at a few GiB
BACKWARD_SCORE_BYTES = 1 << 30


def _check(q, k, v):
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


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    _check(q, k, v)
    b, s, h, d = q.shape
    if q.device.type in build.PLAIN_DEVICES:
        return plain.dense_attention(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    build.refuse_grad("flash_attention", q, k, v)
    if q.dtype not in _ENTRY or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention: float32 or bfloat16 q/k/v "
                         f"required, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in "
                         f"{HEAD_DIMS}")
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


def backward_chunks(b: int, s: int, h: int, hkv: int):
    """The plain backward's chunks: (batch row, first kv head, end kv
    head), each holding at most ``BACKWARD_SCORE_BYTES`` of float32 scores
    (at least one kv head's group)."""
    per_kv_head = (h // hkv) * s * s * 4
    step = max(1, min(hkv, BACKWARD_SCORE_BYTES // per_kv_head))
    return [(i, c, min(hkv, c + step)) for i in range(b)
            for c in range(0, hkv, step)]


def plain_backward(q, k, v, grad, *, causal: bool, window: int = 0):
    """(dq, dk, dv) of ``plain.dense_attention`` at q, k, v for the output
    gradient ``grad``, by autograd through the plain version, chunk by
    chunk (``backward_chunks``); each gradient in its input's dtype."""
    b, s, h, _ = q.shape
    hkv = k.shape[2]
    g = h // hkv
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    with torch.enable_grad():
        for i, c0, c1 in backward_chunks(b, s, h, hkv):
            qs = q[i:i + 1, :, c0 * g:c1 * g].detach().requires_grad_()
            ks = k[i:i + 1, :, c0:c1].detach().requires_grad_()
            vs = v[i:i + 1, :, c0:c1].detach().requires_grad_()
            out = plain.dense_attention(qs, ks, vs, causal=causal,
                                        window=window)
            gq, gk, gv = torch.autograd.grad(
                out, (qs, ks, vs), grad[i:i + 1, :, c0 * g:c1 * g])
            dq[i:i + 1, :, c0 * g:c1 * g] = gq
            dk[i:i + 1, :, c0:c1] = gk
            dv[i:i + 1, :, c0:c1] = gv
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The kernel forward, the plain version's gradients backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = plain_backward(q, k, v, grad.contiguous(),
                                    causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None
