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

On the CPU every call runs the step eagerly, and so it does on the card
for an engine built with ``capture=False``: a sharded replica whose
shards lie on several cards, whose steps hold work and peer copies of
every card (whether one ``torch.cuda.CUDAGraph`` may capture those is
not assumed; shards stacked on one card capture as one card does). The
probes ``prefill_traces``
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

``timeline`` (None unless the engine traces or its profiler hook is
armed) is the engine's ``StepTimeline``: every ``run`` then goes through
it, which times the call on the host, brackets it with CUDA events on the
current stream and, with the hook armed, opens a ``record_function``
range named after the key.
"""
from __future__ import annotations

import contextlib
import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.kernels.build import LAUNCHES
from repro_torch.serving.tracing import Timing

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


#: the prefix of the engine's ``torch.profiler`` ranges
RANGE = "repro_torch/"
_NO_RANGE = contextlib.nullcontext()


class StepTimeline:
    """An engine's step timeline (``serving/tracing.py``, ``Timing``).

    ``timing`` (the engine traces): every step call's host seconds and,
    with ``events`` (one card), a start / end ``torch.cuda.Event`` pair
    recorded around it on the current stream, from a pool; every host sync
    the engine routes through ``wait``, its seconds and count under its
    site's name. All of it goes into the open delivery period
    (``period``) and, while the engine works on one request's prefill,
    into that request's record too (``owner``; delivery syncs excepted).
    ``deliver`` closes the period right after a delivery sync: only then
    are the period's events read (``elapsed_time``), since that sync has
    passed them all; the timeline adds no sync of its own.

    ``ranges`` (the engine's profiler hook armed): a
    ``torch.profiler.record_function`` range around each engine call
    (``enter``), step (``run <kind>/<name><n>``) and sync (``wait
    <site>``), all named ``repro_torch/...``; none while it is off,
    whatever other profiler runs."""

    def __init__(self, device, *, timing: bool, events: bool = False):
        self.device = torch.device(device)
        self.timing = timing
        self.events = timing and events and self.device.type == "cuda"
        self.ranges = False
        self._kinds = KINDS if self.events else None
        self._serial = itertools.count()
        self._free: List[tuple] = []  # event pairs ready for reuse
        self.reset()

    def reset(self):
        """A new period; events not yet passed by a sync are dropped."""
        self.owner: Optional[Timing] = None
        self.period = self.record(next(self._serial)) if self.timing else None
        self.period_t0: Optional[float] = None  # perf_counter: it opened
        self._pending: List[tuple] = []  # (kind, events, owner, period)

    def record(self, serial: Optional[int] = None) -> Timing:
        return Timing(serial, self._kinds)

    def _range(self, label: str):
        if self.ranges:
            return torch.profiler.record_function(RANGE + label)
        return _NO_RANGE

    def enter(self, name: str, idle: bool):
        """An engine call (``submit``, ``step``, ``drain``) begins; an idle
        engine's period opens here, so the caller's time while nothing
        was in flight does not count (unless a step still awaits its
        reading: its device time lies before this call). Returns the
        call's range."""
        if self.timing and (self.period_t0 is None
                            or (idle and not self._pending)):
            self.period_t0 = time.perf_counter()
        return self._range(name)

    def step(self, run, kind: str, name: str, n: int, step, capture: bool):
        with self._range(f"run {kind}/{name}{n}"):
            if not self.timing:
                return run(kind, name, n, step, capture)
            pair = None
            if self.events:
                pair = self._free.pop() if self._free else (
                    torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
                stream = torch.cuda.current_stream(self.device)
                pair[0].record(stream)
            t0 = time.perf_counter()
            out = run(kind, name, n, step, capture)
            dt = time.perf_counter() - t0
            if pair is not None:
                pair[1].record(stream)
                self._pending.append((kind, pair, self.owner, True))
            if self.period_t0 is None:
                self.period_t0 = t0
            self.period.launch_s += dt
            if self.owner is not None:
                self.owner.launch_s += dt
            return out

    @contextlib.contextmanager
    def device_span(self, kind: str):
        """A CUDA event pair around the work launched inside, on the
        current stream, for the owner's record alone (``device_s[kind]``,
        read at the next delivery, as every step's): a part of a step
        (the MoE MLPs of an eager prefill), which the step's own events
        already count into the period."""
        if not self.events or self.owner is None:
            yield
            return
        pair = self._free.pop() if self._free else (
            torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
        stream = torch.cuda.current_stream(self.device)
        pair[0].record(stream)
        try:
            yield
        finally:
            pair[1].record(stream)
            self._pending.append((kind, pair, self.owner, False))

    def wait(self, site: str, fn, *args, delivery: bool = False):
        """``fn(*args)``, a host sync, timed and counted under ``site``;
        a ``delivery`` sync (tokens to the host) is charged to the period
        alone."""
        with self._range("wait " + site):
            t0 = time.perf_counter()
            out = fn(*args)
            dt = time.perf_counter() - t0
        if self.timing:
            if self.period_t0 is None:
                self.period_t0 = t0
            for rec in (self.period, None if delivery else self.owner):
                if rec is not None:
                    rec.wait_s[site] = rec.wait_s.get(site, 0.0) + dt
                    rec.syncs[site] = rec.syncs.get(site, 0) + 1
        return out

    def count(self, name: str, n: int):
        """Add ``n`` to the counter ``name`` of the open period and of
        the owner's record (host arithmetic, no device read)."""
        if not self.timing:
            return
        for rec in (self.period, self.owner):
            if rec is not None:
                rec.counts[name] = rec.counts.get(name, 0) + n

    def deliver(self, ticks: int) -> Timing:
        """Close the period right after a delivery sync of ``ticks``
        decode ticks: its events are read now (the sync passed them) and
        its record returned; the next period opens."""
        now = time.perf_counter()
        rec = self.period
        for kind, pair, owner, period in self._pending:
            s = pair[0].elapsed_time(pair[1]) * 1e-3
            if period:
                rec.device_s[kind] += s
            if owner is not None:
                owner.device_s[kind] = owner.device_s.get(kind, 0.0) + s
            self._free.append(pair)
        self._pending.clear()
        rec.ticks = ticks
        rec.wall_s = now - (now if self.period_t0 is None
                            else self.period_t0)
        self.period = self.record(next(self._serial))
        self.period_t0 = now
        return rec


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

    def __init__(self, device, *, capture: bool = True):
        self.device = torch.device(device)
        self.capture = capture and self.device.type == "cuda"
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
        self.timeline: Optional[StepTimeline] = None

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
        tl = self.timeline
        if tl is not None:
            return tl.step(self._run, kind, name, n, step, capture)
        return self._run(kind, name, n, step, capture)

    def _run(self, kind: str, name: str, n: int, step, capture: bool):
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
