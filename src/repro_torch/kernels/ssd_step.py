"""One decode step of the Mamba-2 SSD mixer: the wrapper of the
hand-written Hopper kernel ``csrc/ssd_step.cu`` beside its plain version
``plain.ssd_step``. The reference has no Pallas kernel here (its step is
plain jnp), so this replaces no TPU kernel: it fuses the port's chain of
PyTorch ops over the float32 state into one pass that reads and writes
each element once.

``ssd_step(state, x, B, C, dt, dt_bias, A_log, D, in_place=...)``: state
(b, H, P, N) float32; x (b, H, P), B and C (b, N), dt (b, H) the mixer's
lanes in the model dtype (dt before its softplus), read at their row
strides; dt_bias, A_log, D (H,) float32. Returns (y (b, H, P) in x's
dtype, the new state): ``in_place`` writes the new state into ``state``
and returns it, else into a fresh tensor. A CPU or meta tensor goes to the
plain version; a CUDA tensor launches the kernel or raises. ``step_plan``
is the launch plan, in Python so that it can be tested without a card."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels import build
from repro_torch.kernels import plain

THREADS = 256  # at most, a block (``csrc/ssd_step.cu``)
PER = (1, 2, 4, 8)  # 16-byte chunks of the state a thread may own
_ENTRY = {torch.float32: "ssd_step_f32", torch.bfloat16: "ssd_step_bf16"}


@dataclass(frozen=True)
class StepPlan:
    rows: int  # rows of a (b, h) tile a block owns
    threads: int  # a block's
    per: int  # 16-byte chunks a thread owns, at most
    grid: tuple  # (b * H, row blocks)

    def chunks(self, by: int, t: int, p: int, n: int) -> list:
        """(row, column chunk) of each chunk that thread ``t`` of row
        block ``by`` owns, as the kernel indexes them."""
        g = n // 4
        row0 = by * self.rows
        n_chunks = min(self.rows, p - row0) * g
        return [(row0 + idx // g, idx % g)
                for idx in range(t, self.threads * self.per, self.threads)
                if idx < n_chunks]


def step_plan(b: int, h: int, p: int, n: int) -> StepPlan:
    """A block per (b, h) tile of up to ``THREADS * 8`` chunks of 16 bytes
    (mamba2's P 64 x N 128: the whole 32 KiB tile, 256 threads of 8
    chunks); a larger P takes several row blocks. A row's N / 4 chunks
    must divide a warp, so N is 4, 8, ... or 128."""
    g = n // 4
    if n % 4 or g < 1 or g > 32 or g & (g - 1):
        raise ValueError(f"ssd_step: state size N {n} must be 4 x a power "
                         f"of two up to 128 (a row's 16-byte chunks divide "
                         f"a warp)")
    rows = min(p, THREADS * PER[-1] // g)
    chunks = rows * g
    threads = min(THREADS, -(-chunks // 32) * 32)
    per = next(k for k in PER if k * threads >= chunks)
    return StepPlan(rows=rows, threads=threads, per=per,
                    grid=(b * h, -(-p // rows)))


def _row_major(t, inner: int = 1) -> bool:
    """Unit stride along the last dimension, and ``inner`` along the one
    before it where there is one of size > 1 (a lane's rows may have any
    stride)."""
    ok = t.shape[-1] == 1 or t.stride(-1) == 1
    if t.dim() == 3 and t.shape[1] > 1:
        ok &= t.stride(1) == inner
    return ok


def ssd_step(state, x, B, C, dt, dt_bias, A_log, D, *, in_place: bool):
    name = "ssd_step"
    if state.dim() != 4 or x.dim() != 3 or B.dim() != 2 or C.dim() != 2 \
            or dt.dim() != 2:
        raise ValueError(f"{name}: want state (b, H, P, N), x (b, H, P), "
                         f"B, C (b, N), dt (b, H); got "
                         f"{[tuple(t.shape) for t in (state, x, B, C, dt)]}")
    b, h, p, n = state.shape
    if tuple(x.shape) != (b, h, p) or tuple(B.shape) != (b, n) \
            or tuple(C.shape) != (b, n) or tuple(dt.shape) != (b, h) \
            or any(tuple(t.shape) != (h,) for t in (dt_bias, A_log, D)):
        raise ValueError(
            f"{name}: shapes do not match the state {tuple(state.shape)}: "
            f"{[tuple(t.shape) for t in (x, B, C, dt, dt_bias, A_log, D)]}")
    tensors = (state, x, B, C, dt, dt_bias, A_log, D)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: inputs on different devices")
    if state.device.type in build.PLAIN_DEVICES:
        return plain.ssd_step(state, x, B, C, dt, dt_bias, A_log, D,
                              in_place=in_place)
    if state.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {state.device}")
    build.refuse_grad(name, *tensors)
    if x.dtype not in _ENTRY or not (x.dtype == B.dtype == C.dtype
                                     == dt.dtype):
        raise ValueError(f"{name}: x, B, C, dt must share float32 or "
                         f"bfloat16, got {x.dtype}/{B.dtype}/{C.dtype}/"
                         f"{dt.dtype}")
    if any(t.dtype != torch.float32 for t in (state, dt_bias, A_log, D)):
        raise ValueError(f"{name}: state, dt_bias, A_log, D must be float32")
    if not (state.is_contiguous() and state.data_ptr() % 16 == 0
            and all(t.is_contiguous() for t in (dt_bias, A_log, D))):
        raise ValueError(f"{name}: state (16-byte aligned), dt_bias, A_log "
                         f"and D must be contiguous")
    if not (_row_major(x, p) and _row_major(B) and _row_major(C)
            and _row_major(dt)):
        raise ValueError(f"{name}: a lane's rows must be unit-stride (x's "
                         f"heads {p} apart)")
    plan = step_plan(b, h, p, n)
    out = state if in_place else torch.empty_like(state)
    y = torch.empty((b, h, p), dtype=x.dtype, device=x.device)
    lib = build.load()
    lib.call(_ENTRY[x.dtype], state.data_ptr(), out.data_ptr(),
             x.data_ptr(), B.data_ptr(), C.data_ptr(), dt.data_ptr(),
             dt_bias.data_ptr(), A_log.data_ptr(), D.data_ptr(),
             y.data_ptr(), x.stride(0), B.stride(0), C.stride(0),
             dt.stride(0), b, h, p, n, plan.rows, plan.threads, plan.per,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.LAUNCHES[name] += 1
    return y, out
