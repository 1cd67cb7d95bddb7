"""The harness's timer (the JAX package's ``repro/util.py`` ``timeit`` and
``TimedSamples``), on the card's clock.

On a CUDA device each timed call is bracketed by two CUDA events and a
synchronize, so a sample is the call's wall time on the device's clock,
launches and all; on ``device="cpu"``, which the caller asks for, each
sample is ``time.perf_counter`` around the call.

The reference's ``util.py`` also holds its trace hints
(``sharding_hints``, ``hints``, ``hint_opt``, ``hint_val``). The two
that change results are explicit options here: ``parallel_block`` is
``apply_block`` / ``forward`` / ``decode_step`` / ``train_step``'s
``parallel_block=``, and ``kv_seq`` is the dry run's ``--opt kv_seq``
(``launch/dryrun.py``, the policy's ``kv_shard="seq"``); so are
the full-capacity MoE hint (``models/moe.py``'s dispatch "full") and
``kv_scale_page`` (the engine's ``kv_scale_group``). The rest have no
PyTorch counterpart, one line each:

- ``attn_carry``: pins the GSPMD sharding of the attention scan's carry.
- ``decode_pin``: pins the GSPMD sharding of decode attention's scores.
- ``moe_pin``: pins the GSPMD sharding of the MoE dispatch buffers.
- ``bf16_ar``: asks XLA for bfloat16 all-reduces (the port adds no
  partial sums: its shards only concatenate).
- ``wsc``: ``with_sharding_constraint`` under the hinted axis names.
- ``unrolled_scans`` / ``scan``: unroll ``lax.scan`` so XLA's
  ``cost_analysis`` counts every trip (the port's layers are a Python
  loop, which ``FlopCounterMode`` counts in full).
- ``attn_chunk_default``: the chunk of the reference's unrolled
  attention scan (the port's attention is one kernel call).
"""
from __future__ import annotations

import time

import torch

from repro_torch.core.device import resolve_device


class TimedSamples(float):
    """The mean seconds per call, plus the per-iteration samples behind it.

    A ``float`` subclass, so ``timeit(...) * 1e3`` reads as milliseconds,
    while callers that care about the distribution read ``.samples`` /
    ``.median``."""

    __slots__ = ("samples",)
    samples: tuple

    def __new__(cls, mean_s: float, samples):
        self = super().__new__(cls, mean_s)
        self.samples = tuple(samples)
        return self

    @property
    def median(self) -> float:
        s = sorted(self.samples)
        n = len(s)
        if not n:
            return float(self)
        mid = n // 2
        return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def timeit(fn, *args, iters: int = 10, warmup: int = 2,
           device="cuda") -> TimedSamples:
    """Seconds per call of ``fn(*args)``: ``warmup`` calls, then ``iters``
    calls each fenced on its own (CUDA events and a synchronize on the
    card, ``time.perf_counter`` on the CPU), so queued work never leaks
    from one sample into the next. Returns a ``TimedSamples``: the mean,
    carrying each sample."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    for _ in range(warmup):
        fn(*args)
    if cuda:
        torch.cuda.synchronize(dev)
    samples = []
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            torch.cuda.synchronize(dev)
            samples.append(start.elapsed_time(end) * 1e-3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            samples.append(time.perf_counter() - t0)
    return TimedSamples(sum(samples) / max(1, len(samples)), samples)
