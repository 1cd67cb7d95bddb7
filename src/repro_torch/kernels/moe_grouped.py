"""A MoE layer's routed experts over its token-sorted rows: the wrapper of
the hand-written Hopper kernel ``csrc/moe_grouped.cu`` beside its plain
version ``plain.moe_grouped``. The reference has no Pallas kernel here (its
MoE is plain jnp), so this replaces no TPU kernel: it turns the port's
per-expert host loop, and the host read of the counts it needed, into two
grouped products over every expert at once.

``moe_grouped(x, order, offsets, w_gate, w_up, w_down, k=, variant=)``: x
(T, d); order (R,) int64, the (token, expert) pairs sorted by expert (row
p is token ``order[p] // k``); offsets (E + 1,) int32, expert e's rows
``offsets[e]:offsets[e + 1]``, left on the device; the (E, d, ff) /
(E, ff, d) expert stacks (``w_gate`` None for "gelu"). Returns ys (R, d)
in x's dtype. A CPU or meta tensor goes to the plain version; a CUDA
tensor launches the kernel (bf16 only) twice or raises. ``grouped_plan``
is the launch plan, in Python so that it can be tested without a card."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import plain

_ACT = {"swiglu": 1, "geglu": 2, "gelu": 3}  # the kernel's ``Act``; 0 none


def grouped_plan(r: int, e: int) -> tuple:
    """(rows a tile, row tiles launched) for ``r`` sorted rows over ``e``
    experts: tiles of 64 rows when the experts average fewer than 96 rows,
    else 128 (an expert's last tile pads fewer rows). The experts' tiles,
    ceil(count / bm) each, sum to at most floor((r + e (bm - 1)) / bm)
    whatever the counts, so the grid needs no device read; a block past
    the last tile returns at once. On an H100 at granite-4.0-h's widths
    (E 72, top 10, d 4096, ff 768) tiles of 64 took 11% less time than
    128 at 42 rows an expert and 7% less at 71; the two met from 83 to 96
    rows, and 128 was 3% ahead at 111."""
    bm = 64 if r < 96 * e else 128
    return bm, (r + e * (bm - 1)) // bm


def moe_grouped(x, order, offsets, w_gate, w_up, w_down, *, k: int,
                variant: str):
    name = "moe_grouped"
    if variant not in _ACT:
        raise ValueError(f"{name}: no MLP variant {variant!r}")
    if (w_gate is None) != (variant == "gelu"):
        raise ValueError(f"{name}: {variant} takes "
                         f"{'no' if variant == 'gelu' else 'a'} w_gate")
    if x.dim() != 2 or order.dim() != 1 or offsets.dim() != 1:
        raise ValueError(f"{name}: want x (T, d), order (R,), offsets "
                         f"(E + 1,); got {tuple(x.shape)}, "
                         f"{tuple(order.shape)}, {tuple(offsets.shape)}")
    (t, d), r = x.shape, order.shape[0]
    e, _, ff = w_up.shape
    stacks = [w for w in (w_gate, w_up) if w is not None]
    if any(tuple(w.shape) != (e, d, ff) for w in stacks) \
            or tuple(w_down.shape) != (e, ff, d) \
            or offsets.shape[0] != e + 1 or r != t * k:
        raise ValueError(
            f"{name}: shapes do not match x {tuple(x.shape)} at k {k}: "
            f"{[tuple(w.shape) for w in stacks + [w_down]]}, order "
            f"{tuple(order.shape)}, offsets {tuple(offsets.shape)}")
    tensors = (x, order, offsets, *stacks, w_down)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: inputs on different devices")
    if x.device.type in build.PLAIN_DEVICES:
        return plain.moe_grouped(x, order, offsets, w_gate, w_up, w_down,
                                 k=k, variant=variant)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
    build.refuse_grad(name, *tensors)
    if any(w.dtype != torch.bfloat16 for w in (x, *stacks, w_down)):
        raise ValueError(f"{name}: the kernel takes bfloat16 x and experts, "
                         f"got {x.dtype} / {w_up.dtype} / {w_down.dtype}")
    if order.dtype != torch.int64 or offsets.dtype != torch.int32:
        raise ValueError(f"{name}: order must be int64 and offsets int32")
    if d % 8 or ff % 8:
        raise ValueError(f"{name}: d {d} and ff {ff} must be multiples of 8 "
                         f"(16-byte rows)")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous and 16-byte "
                         f"aligned")
    bm, tiles = grouped_plan(r, e)
    lib = build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    h = torch.empty((r, ff), dtype=x.dtype, device=x.device)
    lib.call("moe_grouped_bf16", x.data_ptr(), order.data_ptr(), k,
             offsets.data_ptr(), 0 if w_gate is None else w_gate.data_ptr(),
             w_up.data_ptr(), h.data_ptr(), r, e, d, ff, _ACT[variant], bm,
             tiles, stream)
    ys = torch.empty((r, d), dtype=x.dtype, device=x.device)
    lib.call("moe_grouped_bf16", h.data_ptr(), 0, 1, offsets.data_ptr(), 0,
             w_down.data_ptr(), ys.data_ptr(), r, e, ff, d, 0, bm, tiles,
             stream)
    build.LAUNCHES[name] += 2
    return ys
