"""The engine's compiled steps: the port's counterpart of the reference's
jit caches (``repro/serving/engine.py``, ``_decode``, ``_decode_scan`` and
the prefill variants, each jitted with the KV cache donated).

A step is a function of no arguments that reads its inputs from static
buffers the engine owns (the caches, the page table, the token carry, the
sampling state, a bucket's prompt buffer) and writes its results into
them in place. ``StepGraphs.run`` keys a step the way the reference's
trace key is keyed: its kind (a decode tick, a fused window of ``n``
ticks, a prefill bucket of ``n`` tokens, a chunk of prefill, a prefix
hit's suffix of ``n`` tokens). On a CUDA device:

- the first call of a key runs the step eagerly on a side stream: that run
  is the call's result, and also the warm-up that makes the first-use
  ``nvcc`` build, each kernel's ``cudaFuncSetAttribute`` and the sampler's
  lazily allocated path counter happen outside capture;
- then it captures the step into a ``torch.cuda.CUDAGraph``, once;
- every later call replays the graph. Nothing falls back to eager: a
  capture that fails raises.

On the CPU every call runs the step eagerly. The probes ``prefill_traces``
and ``decode_traces`` count the keys first seen, on either device (one per
capture on the card; a key whose capture failed is not counted), so the
CPU tests hold them to the reference's counts: one per prompt bucket or
suffix width, one single tick and one fused window for any sampling mix.
Keys of kind "aux" count into neither probe, as the reference counts none
of those steps: the chunk step (a compile event only there), the working
buffer's gather and the activations' scatters.

All graphs of one engine share one memory pool. That is safe because the
engine reads a replay's outputs before it replays any step again: a
graph's temporaries may lie where another graph keeps its outputs.

A replay calls no Python wrapper, so ``kernels.build.LAUNCHES`` would not
see its kernels: the capture's wrapper calls launched nothing, so their
counts are taken back out of ``LAUNCHES`` and kept as the graph's credit,
which every replay adds.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels.build import LAUNCHES

#: step kinds: a key counts into ``decode_traces`` or ``prefill_traces``,
#: or (``aux``) into neither
KINDS = ("decode", "prefill", "aux")


@dataclass
class _Graph:
    graph: Any  # torch.cuda.CUDAGraph
    out: Any  # the step's outputs, static tensors the replays overwrite
    credit: Dict[str, int] = field(default_factory=dict)  # launches/replay


class StepGraphs:
    """One engine's steps by key ``(kind, name, n)``: ``kind`` "decode",
    "prefill" (the probe it counts into) or "aux", ``name`` the step
    ("tick", "scan", "paged", "bucket", "suffix", "chunk", "seed",
    "insert", "ring") and ``n`` its static length (window ticks, bucket,
    suffix or chunk tokens, pages of a row)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.capture = self.device.type == "cuda"
        self._steps: Dict[Tuple[str, str, int], Optional[_Graph]] = {}
        self.prefill_traces = 0
        self.decode_traces = 0
        self.captures = 0
        self.capture_s = 0.0  # host seconds spent capturing
        self.replays = 0
        self._pool = torch.cuda.graph_pool_handle() if self.capture else None
        self._side = torch.cuda.Stream(self.device) if self.capture else None

    @property
    def keys(self):
        return list(self._steps)

    def run(self, kind: str, name: str, n: int, step: Callable[[], Any]):
        """The result of ``step()`` for key (kind, name, n): a replay of
        its graph once one is captured (CUDA), else ``step()`` itself.
        The outputs of a replay are the graph's static tensors: read them
        before the next ``run`` of any key."""
        if kind not in KINDS:
            raise ValueError(f"step kind must be one of {KINDS}, got {kind!r}")
        key = (kind, name, n)
        if key in self._steps:
            g = self._steps[key]
            if g is None:
                return step()
            g.graph.replay()
            self.replays += 1
            for k, v in g.credit.items():
                LAUNCHES[k] += v
            return g.out
        if not self.capture:
            out = step()
        else:
            cur = torch.cuda.current_stream(self.device)
            self._side.wait_stream(cur)
            with torch.cuda.stream(self._side):
                out = step()
            cur.wait_stream(self._side)
        self._steps[key] = self._capture(step) if self.capture else None
        if kind == "decode":
            self.decode_traces += 1
        elif kind == "prefill":
            self.prefill_traces += 1
        return out

    def _capture(self, step) -> _Graph:
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                out = step()
        finally:
            credit = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                      if LAUNCHES[k] != before[k]}
            LAUNCHES.update(before)  # recorded, not launched
        self.capture_s += time.perf_counter() - t0
        self.captures += 1
        return _Graph(graph, out, credit)
