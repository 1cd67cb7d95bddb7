"""The RG-LRU linear recurrence: the wrapper of the hand-written Hopper
kernel ``csrc/rglru_scan.cu`` (the port of TPU kernel 7,
``repro/kernels/rglru_scan.py::rglru_scan_kernel``) beside its plain
version ``plain.rglru_scan``.

``h_t = a_t * h_{t-1} + x_t`` over a, x (B, S, L) float32 from h0 (B, L)
float32, any S >= 1; returns (y (B, S, L), h_S (B, L)), both float32. A
CPU tensor goes to the plain version; a CUDA tensor launches the kernel or
raises. ``scan_plan`` is the launch plan, in Python so that it can be
tested without a card.

``RGLRUScan`` carries gradients: its forward launches the kernel and keeps
a, x, h0; its backward recomputes ``plain.rglru_scan`` under autograd
(the reference trains through the jnp twin with XLA autodiff: the Pallas
kernel has no backward) and returns its gradients. ``ops.rglru_scan``
routes through it whenever grad mode is on and an input requires grad;
the kernel wrapper refuses such inputs."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels import build
from repro_torch.kernels import plain

SMS = 132  # the H100's streaming multiprocessors
SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
# the kernel's compile-time tile (``csrc/rglru_scan.cu``; 4 warps a block)
CHANNELS = 32  # channels a block owns: one 128-byte segment a step
TIME_TILE = 32  # steps of a and x in one ring stage
STAGES = 8  # ring depth: STAGES - 1 tiles (56 KB a block) in flight
# dynamic shared memory of one block: a ring of a and x tiles, two y tiles
SMEM = (STAGES + 1) * 2 * TIME_TILE * CHANNELS * 4


@dataclass(frozen=True)
class ScanPlan:
    vec: bool  # 16-byte copies (else 4-byte ones)
    grid: tuple  # (channel blocks, B)

    def channels(self, bx: int) -> range:
        """The channels block column ``bx`` owns (the last block's may run
        past L, where the kernel masks)."""
        return range(bx * CHANNELS, (bx + 1) * CHANNELS)


def scan_plan(b: int, s: int, l: int, aligned: bool = True) -> ScanPlan:
    """One block per 32 channels of a row: (1, S, 4096) puts 128 blocks
    on 128 SMs. 16-byte copies where L % 4 == 0 and a, x are 16-byte
    aligned (``aligned``)."""
    return ScanPlan(vec=aligned and l % 4 == 0, grid=(-(-l // CHANNELS), b))


def rglru_scan(a, x, h0):
    name = "rglru_scan"
    if a.dim() != 3 or x.shape != a.shape or h0.dim() != 2 \
            or tuple(h0.shape) != (a.shape[0], a.shape[2]) \
            or a.shape[1] < 1:
        raise ValueError(f"{name}: want a, x (B, S>=1, L) and h0 (B, L); "
                         f"got {tuple(a.shape)}, {tuple(x.shape)}, "
                         f"{tuple(h0.shape)}")
    if not (a.device == x.device == h0.device):
        raise ValueError(f"{name}: a, x, h0 on different devices")
    if a.device.type in build.PLAIN_DEVICES:
        return plain.rglru_scan(a, x, h0)
    if a.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {a.device}")
    build.refuse_grad(name, a, x, h0)
    if not (a.dtype == x.dtype == h0.dtype == torch.float32):
        raise ValueError(f"{name}: float32 a, x, h0 required, got "
                         f"{a.dtype}/{x.dtype}/{h0.dtype}")
    if not (a.is_contiguous() and x.is_contiguous() and h0.is_contiguous()):
        raise ValueError(f"{name}: a, x, h0 must be contiguous")
    b, s, l = a.shape
    p = scan_plan(b, s, l, a.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0)
    y = torch.empty_like(a)
    h_last = torch.empty_like(h0)
    lib = build.load()
    lib.call("rglru_scan_f32", a.data_ptr(), x.data_ptr(), h0.data_ptr(),
             y.data_ptr(), h_last.data_ptr(), b, s, l, int(p.vec),
             torch.cuda.current_stream(a.device).cuda_stream)
    build.LAUNCHES[name] += 1
    return y, h_last


class RGLRUScan(torch.autograd.Function):
    """The scan kernel forward, the plain version's gradients backward."""

    @staticmethod
    def forward(ctx, a, x, h0):
        ctx.save_for_backward(a, x, h0)
        return rglru_scan(a, x, h0)

    @staticmethod
    def backward(ctx, grad_y, grad_h):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            y, h = plain.rglru_scan(*inputs)
            return torch.autograd.grad((y, h), inputs, (grad_y, grad_h))
