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
buffer's gather and the activations' scatters. A key run with
``capture=False`` (exact-length prefill, one key per prompt length) counts
into its probe like any other and always runs eagerly, on either device.
``on_new_key`` (when set) is called with (kind, name, n) once a key is
first seen: the engine's ``compile`` trace event.

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

#: the stream of every first (eager) run, one per card for all engines:
#: cuBLAS keeps a workspace (32 MiB) for each stream it has run on, for the
#: life of the process, so a stream per engine would leave one behind for
#: every engine dropped (a retired or rebuilt replica)
_SIDE: Dict[int, "torch.cuda.Stream"] = {}


def _side_stream(device: torch.device):
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    if index not in _SIDE:
        _SIDE[index] = torch.cuda.Stream(index)
    return _SIDE[index]


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
        self.eager = 0  # keys run with capture=False
        self.on_new_key: Optional[Callable[[str, str, int], None]] = None
        self._pool = torch.cuda.graph_pool_handle() if self.capture else None
        self._side = _side_stream(self.device) if self.capture else None

    @property
    def keys(self):
        return list(self._steps)

    def run(self, kind: str, name: str, n: int, step: Callable[[], Any], *,
            capture: bool = True):
        """The result of ``step()`` for key (kind, name, n): a replay of
        its graph once one is captured (CUDA), else ``step()`` itself.
        The outputs of a replay are the graph's static tensors: read them
        before the next ``run`` of any key. ``capture=False`` counts the
        key and runs it eagerly, always."""
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
        if not capture:
            self.eager += 1
        capture = capture and self.capture
        if not capture:
            out = step()
        else:
            cur = torch.cuda.current_stream(self.device)
            self._side.wait_stream(cur)
            with torch.cuda.stream(self._side):
                out = step()
            cur.wait_stream(self._side)
        self._steps[key] = self._capture(step) if capture else None
        if kind == "decode":
            self.decode_traces += 1
        elif kind == "prefill":
            self.prefill_traces += 1
        if self.on_new_key is not None:
            self.on_new_key(kind, name, n)
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
