"""Serving engine of the PyTorch port: the JAX package's
``repro/serving/engine.py`` on one card — continuous batching over a paged
KV cache on dense archs, or over rolling caches (KV rings and recurrent
states) on archs that cannot page (recurrentgemma) and on dense archs with
``paged=False``; single-shot prefill (bucketed, or at the exact prompt
length where a recurrent state forbids end padding) and chunked prefill
(the reference's default: prompts longer than ``chunk_prefill`` tokens run
chunk by chunk between decode ticks, as ``ChunkedPrefillPolicy`` allots);
the shared-prefix KV cache with copy-on-write (``prefix_cache``); cancel,
timeouts, shedding and preemption with exact restore; ``load_report``;
fused decode windows with one host sync per window, and device-resident
sampling keyed by (seed, absolute position); request span tracing
(``tracing``), ``metrics_registry`` and a ``torch.profiler`` hook
(``profile_dir``), as the reference's.

Where the reference jits pure functions and donates buffers, the port
updates the page pools, page table, rings, recurrent states, positions,
token carry and sampling state IN PLACE (the engine is their only owner)
and, on a CUDA device, captures each step once per shape key into a CUDA
graph and replays it (``serving/graphs.py``): the single decode tick, the
fused ``sync_every`` window, the bucketed prefill with its page scatter
(paged) or its copy into the slot (rolling), the chunk step over the
engine's one (1, max_seq) working buffer, and a prefix hit's suffix step
with its gather and its scatter. Exact-length prefill (recurrentgemma,
whose recurrent state forbids end padding) runs eagerly, on a key per
prompt length that is counted as the reference counts its retrace
(``prefill/exact{L}``) and never captured. The probes ``prefill_traces``
and ``decode_traces`` count the keys as the reference counts its traces;
on the CPU the same steps run eagerly.

Tracing stamps host clocks the caller passes in, at the engine's existing
sync points only: it adds no device sync and no step, and with it off a
request's ``trace`` stays None and each stamp site is one attribute
check. Host-decided
writes (a page-table entry, a released slot's row and position) stay
small eager writes in place. The kernels of the path (prefill attention,
paged or rolling-cache decode attention, which also serves every chunk and
suffix step, the RG-LRU scan, the sampler; under an int8
``PrecisionConfig`` the int8 paged decode and the int8-weight matmul) are
reached through ``repro_torch.kernels.ops``: plain PyTorch on a CPU
device, the hand-written Hopper kernels on CUDA.

Seeded streams match the reference's bits: the uniform of a stochastic
slot is ``uniform(fold_in(PRNGKey(seed), pos))`` from the port's
threefry (``serving/prng.py``) in the ``jax_threefry_partitionable`` mode
the engine is built with.
"""
from __future__ import annotations

import itertools
import math
import os
import time
import weakref
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.costmodel import (
    collective_s_per_axis,
    estimate_backlog_s,
    estimate_decode,
    estimate_prefill,
    kv_bytes_per_token,
)
from repro_torch.core.device import resolve_device
from repro_torch.core.hardware import H100_SXM, Chip
from repro_torch.core.misd.batching import BatchAccumulator, plan_admission
from repro_torch.core.misd.scheduler import ChunkedPrefillPolicy
from repro_torch.kernels import ops
from repro_torch.models import (
    decode_step,
    dtype_of,
    forward,
    init_cache,
    init_paged_cache,
    layer_types,
    paged_ok,
    quantize_weights,
)
from repro_torch.models.blocks import KV_CACHE_BLOCKS, quantize_kv
from repro_torch.serving import prng
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.graphs import StepGraphs
from repro_torch.serving.metrics import MetricsRegistry, latency_histogram
from repro_torch.serving.paging import PageAllocator, PrefixHit, PrefixIndex
from repro_torch.serving.request import (
    Request,
    RequestRejected,
    RequestState,
    SamplingParams,
    ServeMetrics,
)
from repro_torch.serving.telemetry import LoadReport
from repro_torch.serving.tracing import Trace, Tracer

__all__ = [
    "EngineConfig", "LoadReport", "PREEMPT_POLICIES", "ServingEngine",
    "cache_insert", "decode_scan_step", "decode_tick", "init_sampling_state",
    "page_table_append", "paged_prefill_step", "pages_insert",
    "pages_insert_prefix", "prefill_chunk_step", "prefix_seed_cache",
    "prompt_bucket", "resolve_device", "rolling_prefill_step",
    "sampling_row", "sampling_set", "slot_release",
]


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------


def prompt_bucket(n: int, *, min_bucket: int = 16) -> int:
    """Power-of-two bucket for a prompt of ``n`` tokens."""
    return max(min_bucket, 1 << max(n - 1, 1).bit_length())


def _dev_index(x, device):
    """A host int, or a tensor already on ``device``, as a (1,) int64
    tensor there: slot ids and lengths that live on the device let one
    captured step serve every value."""
    return torch.as_tensor(x, device=device).to(torch.int64).reshape(1)


def rolling_prefill_step(cfg, params, tokens, true_len, *, window: int):
    """Prefill a prompt into a fresh rolling cache (``init_cache``, rings
    of ``window``): tokens (B, L) is the prompt at its exact length
    (L = ``true_len``, the reference's ``prefill_step``: archs with
    recurrent state, which end padding would corrupt) or padded at the end
    to a bucket no larger than the smallest ring (its
    ``bucketed_prefill_step``). Causality keeps the pads out of the true
    tokens' keys; ``pos`` is clamped to ``true_len``, so decode's validity
    mask hides the pad rows until its writes replace them. ``true_len`` is
    an int or a (1,) device tensor (the engine's captured buckets).
    Returns (first greedy token (B,) int32, last-true-position logits
    (B, V), cache)."""
    b = tokens.shape[0]
    cache = init_cache(cfg, b, window, device=tokens.device)
    n = _dev_index(true_len, tokens.device)
    last, _ = forward(cfg, params, tokens, logits_at=(n - 1).expand(b),
                      cache=cache)
    cache["pos"].copy_(n.expand(b))
    return torch.argmax(last, dim=-1).to(torch.int32), last, cache


def cache_insert(cache, single, slot):
    """Admit a prefilled request into a rolling cache: copy its B=1 rings,
    RG-LRU conv windows and states and its position into the rows of
    ``slot`` (an int or a (1,) device tensor), in place (every leaf of the
    slot is overwritten, so nothing of the slot's previous request
    survives)."""
    at = _dev_index(slot, cache["pos"].device)
    for big, small in zip(cache["layers"], single["layers"]):
        for name, leaf in big.items():
            leaf.index_copy_(0, at, small[name])
    cache["pos"].index_copy_(0, at, single["pos"])


def paged_prefill_step(cfg, params, tokens, true_len):
    """Prefill a prompt padded at the end to a bucket: tokens (1, L). The
    pad keys are hidden from the true tokens by causality. ``true_len`` is
    an int or a (1,) device tensor, so one captured bucket serves every
    prompt length in it (the reference's traced ``true_len``). Returns
    (first greedy token (1,) int32, last-true-position logits (1, V),
    per-layer (k, v) of all L positions for the page scatter)."""
    n = _dev_index(true_len, tokens.device)
    last, kv = forward(cfg, params, tokens,
                       logits_at=(n - 1).expand(tokens.shape[0]),
                       want_kv=True)
    return torch.argmax(last, dim=-1).to(torch.int32), last, kv


def pages_insert(cache, kv, pages, slot, true_len, *, scale_group: int = 0):
    """Admit a prefilled request: scatter its K/V (the n pages' worth of
    positions) into the pool pages ``pages`` (n,), point the table row of
    ``slot`` at them (trash page 0 after) and set its position to
    ``true_len``. In place; ``slot`` and ``true_len`` are ints or (1,)
    device tensors, so the engine captures the scatter with its bucket's
    prefill. Int8 pools get the quantized values and their scales,
    quantized over all n pages' positions pads included (as the
    reference's prefill quantizes its whole padded window): one scale per
    ``scale_group`` tokens (the page, under the "page" granularity) or,
    with 0, per token."""
    n = pages.shape[0]
    for layer, (k, v) in zip(cache["layers"], kv):
        ps = layer["k"].shape[1]
        for name, t in (("k", k), ("v", v)):
            t = t[0, :n * ps]
            if name + "_scale" in layer:
                t, scale = quantize_kv(t, group=scale_group)
                layer[name + "_scale"][pages] = scale.reshape(
                    n, ps, *scale.shape[1:])
            layer[name][pages] = t.reshape(n, ps, *t.shape[1:]).to(
                layer[name].dtype)
    table, pos = cache["page_table"], cache["pos"]
    row = torch.zeros_like(table[:1])
    row[0, :n] = pages
    at = _dev_index(slot, pos.device)
    table.index_copy_(0, at, row)
    pos.index_copy_(0, at, _dev_index(true_len, pos.device).to(pos.dtype))


def prefill_chunk_step(cfg, params, cache, tokens, true_len):
    """One chunk of incremental prefill into a B=1 linear buffer (or a
    ring the padded prompt fits in) through the multi-token decode path:
    tokens (1, C) may carry end padding on the final chunks; the advanced
    position is clamped to ``true_len`` (an int or a (1,) device tensor),
    so the pad keys stay masked. Returns (greedy token (1,) int32 and
    logits (1, V) at the last true position, clamped into the chunk); the
    cache advances in place (the reference's ``prefill_chunk_step``)."""
    b, c = tokens.shape
    start = cache["pos"].to(torch.int64)  # a copy: decode_step advances pos
    n = _dev_index(true_len, tokens.device)
    at = torch.clamp(n - 1 - start, 0, c - 1)
    last = decode_step(cfg, params, cache, tokens, logits_at=at)
    cache["pos"].copy_(torch.minimum(cache["pos"],
                                     n.to(cache["pos"].dtype)))
    return torch.argmax(last, dim=-1).to(torch.int32), last


def prefix_seed_cache(paged_cache, linear, pages, start):
    """Gather a cached page chain into the B=1 linear buffer ``linear`` of
    ``max_pages`` x page_size rows, in place: page i of ``pages``
    (max_pages,) (the hit's full pages and its copy-on-write tail source,
    trash-padded, so one shape serves every hit) lands at rows [i ps,
    (i+1) ps); int8 pools bring their codes and scales as they are. The
    buffer's position becomes ``start`` (an int or a (1,) device tensor),
    which masks the trash rows and the donor's tokens past the restart.
    Reads the pools only (the reference's ``prefix_seed_cache``)."""
    for big, small in zip(paged_cache["layers"], linear["layers"]):
        for name, pool in big.items():
            chain = pool[pages]  # (n, ps, kv, d)
            small[name][0].copy_(chain.reshape(-1, *chain.shape[2:]))
    pos = linear["pos"]
    pos.copy_(_dev_index(start, pos.device).to(pos.dtype))


def pages_insert_prefix(paged_cache, linear, scatter_pages, table_pages,
                        slot, true_len):
    """Admit a request from the B=1 linear buffer ``linear`` (max_pages x
    page_size rows): page i of the buffer goes to pool page
    ``scatter_pages[i]`` (the trash page at every position the slot
    aliases, so a shared page is never written: copy-on-write lands here,
    the shared tail's matched tokens riding the buffer into the private
    page), the slot's table row becomes ``table_pages`` in full and its
    position ``true_len``. Codes and scales of an int8 buffer go in as
    they are. In place; ``slot`` and ``true_len`` are ints or (1,) device
    tensors, the page rows (max_pages,) device tensors, so one captured
    step serves every hit shape (the reference's ``pages_insert_prefix``;
    a chunked prompt without a hit takes it too, its pages then trash)."""
    n = scatter_pages.shape[0]
    for big, small in zip(paged_cache["layers"], linear["layers"]):
        for name, pool in big.items():
            ps = pool.shape[1]
            pool[scatter_pages] = small[name][0, :n * ps].reshape(
                n, ps, *pool.shape[2:]).to(pool.dtype)
    table, pos = paged_cache["page_table"], paged_cache["pos"]
    at = _dev_index(slot, pos.device)
    table.index_copy_(0, at, table_pages.reshape(1, -1).to(table.dtype))
    pos.index_copy_(0, at, _dev_index(true_len, pos.device).to(pos.dtype))


def page_table_append(cache, slot: int, idx: int, page: int):
    """Grant one more page to a slot mid-decode: table[slot, idx] = page."""
    cache["page_table"][slot, idx] = page


def slot_release(cache, slot: int):
    """Zero a retired slot's position and, in a paged cache, point its
    whole table row at the trash page: it keeps riding in the decode
    batch, but its writes can no longer land in a reclaimed page, and its
    decode attention reads one row instead of a whole ring."""
    if "page_table" in cache:
        cache["page_table"][slot].zero_()
    cache["pos"][slot] = 0


def init_sampling_state(slots: int, device) -> dict:
    """Per-slot device sampling state, all-greedy by default. ``key`` holds
    each slot's ``PRNGKey(seed)`` pair as int64 values of 32 bits."""
    return {
        "greedy": torch.ones((slots,), dtype=torch.bool, device=device),
        "temperature": torch.ones((slots,), dtype=torch.float32,
                                  device=device),
        "top_k": torch.zeros((slots,), dtype=torch.int32, device=device),
        "top_p": torch.ones((slots,), dtype=torch.float32, device=device),
        "key": torch.zeros((slots, 2), dtype=torch.int64, device=device),
    }


def sampling_row(sp: Optional[SamplingParams]) -> dict:
    """Host-side one-slot values for ``init_sampling_state`` leaves.
    Greedy rows skip the key: their lane never draws."""
    sp = sp or SamplingParams()
    greedy = sp.greedy
    return {
        "greedy": bool(greedy),
        "temperature": 1.0 if greedy else max(sp.temperature, 1e-6),
        "top_k": 0 if greedy else int(sp.top_k),
        "top_p": 1.0 if greedy else float(sp.top_p),
        "key": (0, 0) if greedy else prng.prng_key(sp.seed),
    }


def sampling_set(samp, slot: int, row: dict):
    """Write one slot's sampling values into the per-slot state, in place."""
    for name, leaf in samp.items():
        leaf[slot] = torch.as_tensor(row[name], dtype=leaf.dtype)


def window_uniforms(samp, pos, n: int, *, partitionable: bool = True):
    """The uniforms of ``n`` decode ticks at once, (n, B): tick i draws
    the token at position ``pos + i + 1`` (every slot advances by one per
    tick), so its uniform is ``uniform(fold_in(key, pos + i + 1))``. One
    threefry pass per window instead of one per tick."""
    at = (pos.to(torch.int64)[None, :]
          + torch.arange(1, n + 1, device=pos.device)[:, None])
    return prng.uniform(prng.fold_in(samp["key"][None], at), partitionable)


def draw_tokens(last, samp, pos, *, partitionable: bool = True,
                uniform=None):
    """Pick each row's next token from its logits ``last`` (B, V) through
    the sampler kernel. ``pos`` (B,) is the absolute position of the token
    being drawn; a stochastic row's uniform is ``uniform(fold_in(key,
    pos))``, unless the caller drew it already (``uniform``). Every row
    gets a uniform, whatever the mix: the kernel picks greedy rows by the
    device mask, and their tokens do not depend on it (one step for any
    mix, as the reference's one trace)."""
    if uniform is None:
        uniform = prng.uniform(prng.fold_in(samp["key"], pos),
                               partitionable)
    return ops.sample_tokens(last.to(torch.float32).contiguous(),
                             samp["greedy"], samp["temperature"],
                             samp["top_k"], samp["top_p"], uniform)


def decode_tick(cfg, params, cache, tokens, samp, *,
                partitionable: bool = True, uniform=None):
    """One decode step for every slot: ``tokens`` (B,) is the device-
    resident last-token carry. The token drawn lands at the post-step
    position, the same fold key the first token uses (pos = prompt_len).
    Returns next tokens (B,) int32; the cache advances in place."""
    logits = decode_step(cfg, params, cache, tokens[:, None])
    return draw_tokens(logits[:, -1], samp, cache["pos"],
                       partitionable=partitionable, uniform=uniform)


def decode_scan_step(cfg, params, cache, tokens, samp, *, n: int,
                     out=None, partitionable: bool = True):
    """``n`` decode ticks back to back with no host sync between them (the
    reference's fused ``lax.scan`` window). Returns (final tokens (B,),
    token history (n, B) int32) — the caller syncs the history once. The
    history is written into ``out`` when given (the engine's static
    buffer, which a captured window overwrites in place)."""
    us = window_uniforms(samp, cache["pos"], n, partitionable=partitionable)
    hist = out if out is not None else torch.empty(
        (n, tokens.shape[0]), dtype=torch.int32, device=tokens.device)
    for i in range(n):
        tokens = decode_tick(cfg, params, cache, tokens, samp,
                             partitionable=partitionable, uniform=us[i])
        hist[i].copy_(tokens)
    return tokens, hist


def _padded_len(n: int, chunk: int) -> int:
    return ((n + chunk - 1) // chunk) * chunk


def _compile_key(kind: str, name: str, n: int) -> Optional[str]:
    """The reference's trace key of a step key: ``decode/tick``,
    ``decode/scan{n}``, ``prefill/{paged,bucket,suffix,exact}{n}``,
    ``prefill/chunk{n}``; None for the helper steps (the working buffer's
    gather, the activations' scatters), which the reference does not
    count."""
    if kind == "decode":
        return "decode/tick" if name == "tick" else f"decode/scan{n}"
    if kind == "prefill":
        return f"prefill/{name}{n}"
    if name == "chunk":
        return f"prefill/chunk{n}"
    return None


# ---------------------------------------------------------------------------
# continuous-batching executor
# ---------------------------------------------------------------------------


def _attn_only(cfg) -> bool:
    """Every block's decode cache is a KV ring (no recurrent state): the
    precondition for end-padded bucketed prefill and chunked prefill."""
    return all(bt in KV_CACHE_BLOCKS for bt in layer_types(cfg))


def _min_cache_window(cfg, window: int) -> int:
    """The smallest KV ring of the model: a bucketed or chunked prefill
    must fit in it."""
    if "local_attn" in layer_types(cfg):
        return min(window, cfg.local_window)
    return window


@dataclass
class _PrefillJob:
    """A request mid-way through chunked prefill (slot and pages reserved).
    Only the head job of the queue advances, in the engine's one working
    buffer: a job takes the buffer when it becomes the head (``started``),
    and a prefix hit's job gathers its page chain into it then, keeping
    its copy-on-write tail source pinned until that gather."""

    req: Request
    slot: int
    tokens: np.ndarray  # (1, padded_len) the end-padded prompt
    true_len: int
    next_off: int = 0
    started: bool = False
    restore: bool = False  # a preempted request's re-admission
    # a prefix hit: the (max_pages,) gather chain (gathered from the
    # restart offset, next_off, when the job starts) and the pinned tail
    # source (-1 when none, or once gathered)
    seed: Optional[np.ndarray] = None
    tail_page: int = -1
    # the first token's greedy pick and logits, from the chunk holding
    # position true_len - 1 (trailing chunks can be pure padding)
    tok: Optional[torch.Tensor] = None
    logits: Optional[torch.Tensor] = None


@dataclass
class _HitAdmission:
    """A prefix hit's page rows, staged between reservation and
    activation: the scatter row (trash at aliased positions) and the
    slot's full table row."""

    scatter_pages: np.ndarray  # (max_pages,)
    table_pages: np.ndarray  # (max_pages,)
    n_tabled: int  # owned pages written into the row (decode tail too)


# ---------------------------------------------------------------------------
# preemption victim policies (name -> chooser), as the reference's
# ---------------------------------------------------------------------------


def _urgency(req: Request):
    """Total order on urgency: higher priority beats any deadline, then the
    earlier TTFT deadline. Smaller is more urgent."""
    return (-req.priority, req.ttft_deadline)


def _victim_latest_deadline(engine, eligible: List[int]) -> int:
    """Evict the least urgent slot (ties: the most remaining budget)."""
    return max(eligible,
               key=lambda i: (_urgency(engine.active[i]),
                              engine.active[i].remaining_tokens, i))


def _victim_most_remaining(engine, eligible: List[int]) -> int:
    """Evict the slot with the most budget left (ties: latest deadline)."""
    return max(eligible,
               key=lambda i: (engine.active[i].remaining_tokens,
                              _urgency(engine.active[i]), i))


PREEMPT_POLICIES = {
    "latest-deadline": _victim_latest_deadline,
    "most-remaining": _victim_most_remaining,
}


class _Profiler:
    """One ``torch.profiler`` run shared by every engine of the process
    (the profiler is process-wide): the first ``start`` opens it, the last
    ``stop`` closes it and writes its Chrome trace into that engine's
    directory."""

    prof = None
    users = 0
    _runs = itertools.count()

    @classmethod
    def start(cls, device: torch.device):
        if cls.prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            cls.prof = torch.profiler.profile(activities=acts)
            cls.prof.start()
        cls.users += 1

    @classmethod
    def stop(cls, out_dir: str) -> Optional[str]:
        cls.users -= 1
        if cls.users > 0:
            return None
        prof, cls.prof = cls.prof, None
        prof.stop()
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(
            out_dir, f"torch_trace.{os.getpid()}.{next(cls._runs)}.json")
        prof.export_chrome_trace(path)
        return path


class ServingEngine:
    """Single-card engine with continuous batching over a paged KV cache,
    or over rolling caches (the reference's ``ServingEngine``; see its
    docstring for the knobs). ``paged`` None serves from pages whenever
    every block can, else from rolling caches; ``paged=True`` on an arch
    that cannot page raises, as the reference. ``device`` defaults to CUDA
    and raises when no card is present unless ``device="cpu"`` is asked
    for. ``threefry_partitionable`` selects the
    ``jax_threefry_partitionable`` mode whose bits seeded streams
    reproduce. ``chip`` is the card the cost model prices (admission
    plan, chunk interleave, ``load_report``; the tests pass the
    reference's TPU constants). ``prefill_traces`` and ``decode_traces``
    are the reference's compile-count probes (``graphs.StepGraphs``), and
    ``compile_events`` counts the captured steps under the reference's
    key names.

    ``params`` may already hold ``lm_head_f32`` and int8 weight leaves
    (another engine's ``params``): they are kept, not made again, so
    replicas built from one engine's params share every weight tensor."""

    def __init__(self, cfg, params, config: Optional[EngineConfig] = None,
                 *, device="cuda", threefry_partitionable: bool = True,
                 chip: Chip = H100_SXM):
        if config is None:
            config = EngineConfig()
        config.validate(cfg)
        self.config = config
        self.cfg = cfg
        self.device = resolve_device(device)
        self.partitionable = bool(threefry_partitionable)
        self.chip = chip
        if config.precision.quantized_weights:
            # weight-only int8 at load: attention/MLP matmul weights
            # become {"w_q", "scale"} dicts (blocks.linear dispatches);
            # leaves quantized already are kept
            params = quantize_weights(cfg, params)
        params = dict(params)
        if dtype_of(cfg) != torch.float32 and "lm_head_f32" not in params:
            # the lm head's float32 product (the reference's preferred
            # element type), kept once instead of upcast every tick
            head = params.get("lm_head")
            if head is None:
                head = params["embed"].T
            params["lm_head_f32"] = head.to(torch.float32)
        self.params = params
        # validate() refused paged=True on an arch that cannot page
        self.paged = (paged_ok(cfg) if config.paged is None
                      else bool(config.paged))
        # the reference's own refusals, with its messages
        if config.prefix_cache and not self.paged:
            raise ValueError(
                f"{cfg.name}: prefix_cache requires the paged KV cache "
                f"(rolling windows cannot alias another slot's KV)")
        if config.preemption and not self.paged:
            raise ValueError(
                f"{cfg.name}: preemption requires the paged KV cache (a "
                f"victim's pages must be releasable mid-stream)")
        if config.preempt_policy not in PREEMPT_POLICIES:
            raise ValueError(f"unknown preempt_policy "
                             f"{config.preempt_policy!r} (want one of "
                             f"{sorted(PREEMPT_POLICIES)})")
        self.preemption = config.preemption
        self.preempt_policy = config.preempt_policy
        self._preempt_victim_fn = PREEMPT_POLICIES[config.preempt_policy]
        self.shed_overdue = config.shed_overdue
        page_size = config.page_size
        if page_size <= 0 or page_size & (page_size - 1):
            raise ValueError(f"page_size must be a power of two, got "
                             f"{page_size}")
        self.page_size = page_size
        # int8 KV pages; "page" scale granularity groups the prefill's
        # scales by page (the reference's kv_scale_page trace hint)
        self.kv_dtype = config.precision.kv_cache_dtype
        self.kv_scale_group = (
            page_size if self.kv_dtype
            and config.precision.kv_scale_granularity == "page" else 0)
        self.window = config.window
        self.max_seq = _padded_len(int(config.max_seq or config.window),
                                   page_size)
        self.max_pages = self.max_seq // page_size
        self.plan = plan_admission(
            cfg, context=config.window, sla_s=config.sla_s,
            n_chips=config.n_chips, kv_hbm_budget_bytes=config.kv_hbm_budget,
            mean_context=((config.expected_len or None) if self.paged
                          else config.window),
            kv_cache_dtype=self.kv_dtype, chip=chip)
        slots = config.slots or self.plan.slots
        self.slots = slots
        self.n_chips = config.n_chips
        # the mesh of a sharded replica; None on one card (validate()
        # refuses sharded topologies until multi-GPU serving is ported)
        self._mesh_axes = (config.topology.mesh_axes
                           if config.topology.sharded else None)
        self._tick_est_s = estimate_decode(
            cfg, slots, config.window, chip=chip, n_chips=self.n_chips,
            mesh_axes=self._mesh_axes).latency_s
        # collective seconds per mesh axis of a tick: none on one card
        self._axis_collective_s = (
            collective_s_per_axis(cfg, slots, mesh_axes=self._mesh_axes,
                                  chip=chip) if self._mesh_axes else {})
        self.eos_id = config.eos_id
        self.sync_every = 1 if config.eos_id >= 0 else max(1,
                                                           config.sync_every)
        # end-padded buckets and chunks need KV rings only (a recurrent
        # state would run over the pads); in rolling mode a bucket or a
        # chunked prompt must fit the smallest ring
        self._attn_only = _attn_only(cfg)
        self.bucket_prompts = config.bucket_prompts and self._attn_only
        self._min_window = _min_cache_window(cfg, config.window)
        chunk = config.chunk_prefill
        if config.prefill_policy is not None:  # the policy's chunk wins
            chunk = config.prefill_policy.chunk
        self.chunk = chunk if (chunk and self._attn_only) else 0
        self.prefill_policy = config.prefill_policy or ChunkedPrefillPolicy(
            chunk=self.chunk or 64, chip=chip)
        # chunked-prefill buffers must be both chunk- and page-aligned
        self._chunk_quantum = (math.lcm(self.chunk, page_size)
                               if self.chunk else page_size)
        self.edf_backlog = config.edf_backlog
        self.metrics = ServeMetrics()
        # --- span tracing and profiling, as the reference's: host clocks
        # the caller passes in, stamped at existing sync points only
        self._trace_on = bool(config.tracing)
        # head sampling: trace rids with rid % trace_sample_n == 0
        self._trace_every = max(1, config.trace_sample_n)
        self.tracer = Tracer(enabled=self._trace_on, ring=config.trace_ring)
        self._win_t0 = 0.0  # caller clock at the open decode window's start
        self._last_now = 0.0  # the latest caller clock (compile events)
        self._tick_wall = latency_histogram()  # step() wall s (tracing on)
        self._profiling = False
        if self.paged:
            self.pool_pages = config.pool_pages or slots * self.max_pages + 1
            self.allocator = PageAllocator(self.pool_pages, page_size)
            self.prefix_index = (PrefixIndex(self.allocator, page_size)
                                 if config.prefix_cache else None)
            self.cache = init_paged_cache(
                cfg, slots, self.pool_pages, page_size, self.max_pages,
                device=self.device, kv_dtype=self.kv_dtype)
        else:
            self.pool_pages, self.allocator = 0, None
            self.prefix_index = None
            self.cache = init_cache(cfg, slots, config.window,
                                    device=self.device)
        # the B=1 working buffers: one for chunk jobs (only the head job
        # advances), linear over max_seq (paged) or a ring of the window
        # (rolling), and one for a prefix hit's synchronous suffix step,
        # which may run while a chunk job holds the first; int8 codes and
        # float32 scales under int8 pages
        width = self.max_seq if self.paged else self.window
        self._lin = (init_cache(cfg, 1, width, device=self.device,
                                kv_dtype=self.kv_dtype)
                     if self.chunk else None)
        self._lin_sfx = (init_cache(cfg, 1, width, device=self.device,
                                    kv_dtype=self.kv_dtype)
                         if self.prefix_index is not None else None)
        self._pos_h: List[int] = [0] * slots  # host mirror of cache pos
        self._tabled: List[int] = [0] * slots  # table entries written
        # static buffers the captured steps read and write in place
        self._tokens = torch.zeros((slots,), dtype=torch.int32,
                                   device=self.device)
        self._samp = init_sampling_state(slots, self.device)
        # row k: the tokens of the k-th deferred tick; a fused window
        # writes all sync_every rows
        self._hist = torch.zeros((self.sync_every, slots), dtype=torch.int32,
                                 device=self.device)
        # per prompt bucket (or suffix width): its (1, L) token buffer and
        # its int64 arguments
        self._prefill_in: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._suffix_in: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        i64 = dict(dtype=torch.int64, device=self.device)
        # the chunk step's tokens and true length; a seed's start and
        # chain; an activation's true length, slot and page rows
        self._chunk_in = (torch.zeros((1, max(1, self.chunk)),
                                      dtype=torch.int32, device=self.device),
                          torch.zeros((1,), **i64))
        self._seed_in = torch.zeros((1 + self.max_pages,), **i64)
        self._insert_in = torch.zeros((2 + 2 * self.max_pages,), **i64)
        self.graphs = StepGraphs(self.device)
        # through a weak reference: a bound method would make the engine
        # and its graphs a cycle, whose device memory only the garbage
        # collector frees once the engine is dropped
        note = weakref.WeakMethod(self._note_compile)
        self.graphs.on_new_key = lambda *key: note()(*key)
        self._samp_greedy_h: List[bool] = [True] * slots
        self.active: List[Optional[Request]] = [None] * slots
        self.decoding: List[bool] = [False] * slots
        self._unsynced = 0  # deferred ticks whose tokens wait in _hist
        self._finished: List[Request] = []
        self._jobs: Deque[_PrefillJob] = deque()
        # staged prefix-hit admissions of chunk jobs, by slot
        self._hit_pending: Dict[int, _HitAdmission] = {}
        self.backlog: Deque[Request] = deque()
        self.admission = BatchAccumulator(
            target_batch=slots, deadline_s=self.plan.flush_deadline_s)
        self.prefill_calls = 0

    @property
    def prefill_traces(self) -> int:
        return self.graphs.prefill_traces

    @property
    def decode_traces(self) -> int:
        return self.graphs.decode_traces

    @property
    def compile_events(self) -> Dict[str, int]:
        """Compiled steps by the reference's trace keys: ``decode/tick``,
        ``decode/scan{n}``, ``prefill/paged{L}`` (or ``bucket{L}``),
        ``prefill/suffix{W}`` and ``prefill/chunk{C}``; one per captured
        graph (on the CPU, per key first run). The working buffer's gather
        and the activations' scatters are captured too, uncounted, as the
        reference's helper steps are."""
        out: Dict[str, int] = {}
        for kind, name, n in self.graphs.keys:
            key = _compile_key(kind, name, n)
            if key is not None:
                out[key] = out.get(key, 0) + 1
        return out

    # -- observability -------------------------------------------------------
    def _note_compile(self, kind: str, name: str, n: int):
        """A step key seen for the first time: the reference's ``compile``
        event, stamped at the latest caller clock."""
        key = _compile_key(kind, name, n)
        if self._trace_on and key is not None:
            self.tracer.event("compile", self._last_now, key=key)

    def _tr(self, req: Request) -> Optional[Trace]:
        """The trace to stamp for ``req``: its own (a tracing frontend may
        have made it), a new one when tracing is on and the rid is in the
        sample (``rid % trace_sample_n == 0``), else None."""
        t = req.trace
        if (t is None and self._trace_on
                and req.rid % self._trace_every == 0):
            t = req.trace = Trace(req.rid)
        return t

    def _tr_admit(self, req: Request, now: float, path: str, slot: int):
        """Close the queued span and open the prefill span at admission."""
        t = self._tr(req)
        if t is None:
            return
        if t.is_open("queued"):
            t.end("queued", now)
        t.begin("prefill", now, path=path, slot=slot)

    def _tr_terminal(self, req: Request, now: float, kind: str, **meta):
        """Stamp a terminal event (rejected, abort) and fold the trace into
        the engine's rollup."""
        t = req.trace
        if t is None:
            return
        t.close_all(now)
        t.event(kind, now, **meta)
        self.tracer.collect(t)

    def start_profile(self) -> bool:
        """Arm ``torch.profiler`` (CPU, and CUDA on a card) into
        ``config.profile_dir``; False (no-op) without a directory or when
        this engine profiles already."""
        if not self.config.profile_dir or self._profiling:
            return False
        _Profiler.start(self.device)
        self._profiling = True
        if self._trace_on:
            self.tracer.event("profile_start", self._last_now,
                              dir=self.config.profile_dir)
        return True

    def stop_profile(self) -> bool:
        """Disarm the profiler; the last engine to stop writes the run's
        Chrome trace into its ``profile_dir``."""
        if not self._profiling:
            return False
        _Profiler.stop(self.config.profile_dir)
        self._profiling = False
        if self._trace_on:
            self.tracer.event("profile_stop", self._last_now)
        return True

    def metrics_registry(self) -> MetricsRegistry:
        """This engine's metrics as a registry (exposition-ready): the
        ServeMetrics counters and histograms plus compile events per key,
        span totals per kind and the step wall time."""
        reg = self.metrics.registry()
        reg.set_counter("serving_prefill_traces_total", self.prefill_traces)
        reg.set_counter("serving_decode_traces_total", self.decode_traces)
        for key, n in sorted(self.compile_events.items()):
            reg.set_counter(
                f"serving_compile_events_total{{key=\"{key}\"}}", n)
        for kind, (c, s) in sorted(self.tracer.span_totals.items()):
            reg.set_counter(f"serving_span_count_total{{kind=\"{kind}\"}}", c)
            reg.set_gauge(f"serving_span_seconds{{kind=\"{kind}\"}}", s)
        if self._tick_wall.count:
            reg.register("serving_step_wall_seconds", self._tick_wall)
        return reg

    # -- admission ---------------------------------------------------------
    def submit(self, req: Request, now: float) -> bool:
        """Admit at once while a slot is free; once saturated, queue and
        batch admissions up to the cost-model deadline. An unservable
        request comes back FAILED from the next ``step`` (and ``False`` is
        returned) instead of raising."""
        self._last_now = now
        t = self._tr(req)
        if t is not None and not t.is_open("queued"):
            t.begin("queued", now)
        try:
            self._check_servable(req)
        except RequestRejected as e:
            self._reject(req, now, str(e))
            return False
        if (not self.backlog and not self.admission.pending
                and self.try_admit(req, now)):
            return True
        flushed = self.admission.add(req, now)
        if flushed:
            self.backlog.extend(flushed)
            self._drain_backlog(now)
        return True

    def _reject(self, req: Request, now: float, reason: str):
        req.state = RequestState.FAILED
        req.fail_reason = reason
        req.finish_time = now
        self.metrics.rejected += 1
        if req.tenant:
            self.metrics.tenant(req.tenant).rejected += 1
        self._tr_terminal(req, now, "rejected", reason=reason[:120])
        self._finished.append(req)

    def _pump_admissions(self, now: float):
        flushed = self.admission.poll(now)
        if flushed:
            self.backlog.extend(flushed)
        self._drain_backlog(now)

    def _drain_backlog(self, now: float):
        while self.backlog:
            idx = 0
            if self.edf_backlog:
                idx = min(range(len(self.backlog)),
                          key=lambda k: (self.backlog[k].ttft_deadline, k))
            if not self._admit_or_preempt(self.backlog[idx], now):
                break
            del self.backlog[idx]

    def _admit_or_preempt(self, req: Request, now: float) -> bool:
        """Admit ``req``; when admission backpressures and preemption is
        on, evict strictly less urgent victims (policy-chosen) until it
        fits or none is eligible. Victims requeue at the back of the
        backlog."""
        if self.try_admit(req, now):
            return True
        if not self.preemption:
            return False
        while True:
            slot = self._choose_victim(req)
            if slot is None:
                return False
            victim = self.preempt(slot, now)
            if victim is not None:
                self.backlog.append(victim)
            if self.try_admit(req, now):
                return True

    def _choose_victim(self, cand: Request) -> Optional[int]:
        """A decoding slot whose request is STRICTLY less urgent than
        ``cand``, chosen by the policy; None: do not preempt."""
        eligible = [i for i, (r, d) in enumerate(zip(self.active,
                                                     self.decoding))
                    if r is not None and d and _urgency(cand) < _urgency(r)]
        if not eligible:
            return None
        return self._preempt_victim_fn(self, eligible)

    def preempt(self, slot: int, now: float) -> Optional[Request]:
        """Evict the decoding request in ``slot`` and return it, PREEMPTED,
        for requeueing. Deferred tokens are flushed first; the generated
        tokens fold into its prompt and, with the prefix cache on, every
        full page of valid KV is registered before the slot's references
        drop, so the restore prefills only the suffix. Seeded noise is
        keyed by absolute position, so the restored stream equals an
        unpreempted one. None when the flush finished the request. Touches
        host state and the slot's table row and position only."""
        if not self.paged:
            raise ValueError("preemption requires the paged KV cache")
        self._flush(now)
        req = self.active[slot]
        if req is None or not self.decoding[slot]:
            return None
        req.fold_output_into_prompt()
        if self.prefix_index is not None:
            # KV is valid through position pos - 1 (the newest token lives
            # only in the carry): only pages wholly inside are indexable
            ps = self.page_size
            owned = self.allocator.owned(slot)
            n = min(self._pos_h[slot] // ps, len(owned))
            if n > 0:
                self.prefix_index.register(req.prompt[:n * ps], owned[:n])
        self.release_slot(slot)
        req.state = RequestState.PREEMPTED
        req.preemptions += 1
        self.metrics.preempted += 1
        t = req.trace
        if t is not None:
            if t.is_open("decode"):
                t.end("decode", now, tokens=len(req.output))
            t.event("preempt", now, slot=slot, policy=self.preempt_policy)
            t.begin("queued", now)  # the victim requeues for its restore
        return req

    def _check_servable(self, req: Request):
        if self.paged and req.prompt_len > self.max_seq:
            raise RequestRejected(
                f"prompt of {req.prompt_len} tokens exceeds max_seq="
                f"{self.max_seq}; raise EngineConfig(max_seq=...)")

    def try_admit(self, req: Request, now: float) -> bool:
        """Claim a free slot and, in paged mode, the request's worst-case
        pages (padded prompt + token budget, capped at max_seq; a prefix
        hit shares its cached pages), then prefill: a hit's suffix, a long
        prompt's chunks (interleaved with decode), or single-shot. An
        exhausted pool refuses the admission (backpressure)."""
        self._check_servable(req)
        for i, r in enumerate(self.active):
            if r is None and not any(j.slot == i for j in self._jobs):
                hit = None
                if self.prefix_index is not None:
                    hit = self.prefix_index.lookup(req.prompt)
                if self.paged and not self._reserve_pages(req, i, hit):
                    return False
                if hit is not None:
                    self._admit_prefix(req, i, hit, now)
                elif self._chunkable(req):
                    self._start_chunked(req, i, now)
                else:
                    self._admit_now(req, i, now)
                return True
        return False

    def _chunkable(self, req: Request) -> bool:
        cap = self.max_seq if self.paged else self._min_window
        quantum = self._chunk_quantum if self.paged else self.chunk
        return (self.chunk > 0
                and req.prompt_len > self.chunk
                and _padded_len(req.prompt_len, quantum) <= cap)

    def _bucket_for(self, plen: int) -> Optional[int]:
        """The power-of-two bucket of a prompt when it fits max_seq (paged)
        or the smallest ring (rolling), else None."""
        if not self.bucket_prompts:
            return None
        if self.paged:
            b = prompt_bucket(plen, min_bucket=max(16, self.page_size))
            return b if b <= self.max_seq else None
        b = prompt_bucket(plen)
        return b if b <= self._min_window else None

    def _prefill_len(self, req: Request) -> int:
        """Padded prompt length: the chunk-aligned prompt when chunked,
        else the bucket, else the page-rounded prompt (paged) or the exact
        prompt (rolling)."""
        plen = req.prompt_len
        if self._chunkable(req):
            quantum = self._chunk_quantum if self.paged else self.chunk
            return _padded_len(plen, quantum)
        bucket = self._bucket_for(plen)
        if bucket is not None:
            return bucket
        return _padded_len(plen, self.page_size) if self.paged else plen

    def _suffix_chunked(self, req: Request, hit: PrefixHit) -> bool:
        """Whether a hit's suffix runs as interleaved chunks (long suffix)
        instead of one synchronous bucketed suffix step."""
        return (self.chunk > 0
                and req.prompt_len - hit.tokens > self.chunk
                and _padded_len(req.prompt_len, self._chunk_quantum)
                <= self.max_seq)

    def _suffix_plan(self, req: Request, hit: PrefixHit):
        """(start, end) of a hit's suffix prefill in the linear buffer:
        tokens [start, end) are (re)computed; start <= hit.tokens keeps the
        span on the chunk grid or the bucket width, and end stays within
        max_seq."""
        plen, h = req.prompt_len, hit.tokens
        if self._suffix_chunked(req, hit):
            s = (h // self.chunk) * self.chunk
            return s, _padded_len(plen, self._chunk_quantum)
        c = min(prompt_bucket(plen - h, min_bucket=max(16, self.page_size)),
                self.max_seq)
        s = min(h, self.max_seq - c)
        return s, s + c

    def _alloc_evicting(self, slot: int, n: int) -> bool:
        """All-or-nothing grant, evicting idle cached prefixes (oldest
        first) to cover a shortfall before refusing."""
        if (not self.allocator.can_alloc(n)
                and self.prefix_index is not None):
            self.prefix_index.evict(n - self.allocator.free_pages)
        return self.allocator.alloc(slot, n) is not None

    def _reserve_pages(self, req: Request, slot: int,
                       hit: Optional[PrefixHit] = None) -> bool:
        """Grant ``req``'s worst-case lifetime pages to ``slot``: the padded
        prompt plus its remaining budget (capped at max_seq). With a prefix
        ``hit`` its full pages are shared into the slot (a reference each,
        no pool spend), its copy-on-write tail source is pinned, and only
        the rest is allocated; under pool pressure idle cached prefixes are
        evicted before the admission is refused."""
        if self.allocator.owned(slot):
            slot_release(self.cache, slot)
            self.allocator.free_slot(slot)
            self._pos_h[slot] = 0
            self._tabled[slot] = 0
            self._hit_pending.pop(slot, None)
        # restore-aware: a preempted request's folded tokens are inside
        # both prompt_len and max_new_tokens
        lifetime = min(req.prompt_len + max(1, req.remaining_tokens) - 1,
                       self.max_seq)
        if hit is None:
            n = self.allocator.pages_for(max(self._prefill_len(req),
                                             lifetime))
            return self._alloc_evicting(slot, n)
        # share first: a shared page is no longer evictable
        shared = self.allocator.share(slot, list(hit.full_pages))
        if hit.tail_page >= 0:
            self.allocator.retain(hit.tail_page)  # pin the COW source
        _, end = self._suffix_plan(req, hit)
        n_priv = self.allocator.pages_for(max(end, lifetime)) - len(shared)
        if not self._alloc_evicting(slot, n_priv):
            if hit.tail_page >= 0:
                self.allocator.release(hit.tail_page)
            self.allocator.free_slot(slot)  # drop the shares
            return False
        return True

    def _admit_now(self, req: Request, slot: int, now: float):
        """Single-shot prefill: page-aligned linear prefill and page
        scatter (paged), or a bucket or the exact prompt into fresh
        rolling caches copied into the slot (an exact-length prompt: one
        eager step per length, counted as the reference's retrace)."""
        self._tr_admit(req, now, "full", slot)
        plen = req.prompt_len
        padded = np.zeros((1, self._prefill_len(req)), np.int32)
        padded[0, :plen] = req.prompt
        if self.paged or self._bucket_for(plen) is not None:
            tok, last = self._prefill_bucket(padded, plen, slot)
        else:
            def exact():
                tok, last, single = rolling_prefill_step(
                    self.cfg, self.params, torch.from_numpy(padded).to(
                        self.device), plen, window=self.window)
                cache_insert(self.cache, single, slot)
                return tok, last

            tok, last = self.graphs.run("prefill", "exact", plen, exact,
                                        capture=False)
        self.prefill_calls += 1
        n_tabled = (self.allocator.pages_for(padded.shape[1]) if self.paged
                    else 0)
        self._activate(req, slot, tok, last, now, n_tabled)

    def _prefill_bucket(self, padded: np.ndarray, plen: int, slot: int):
        """The padded prompt's prefill step, with the page scatter (paged)
        or the copy into the slot (rolling), as one step keyed by its
        length: the prompt, its true length, the slot and its pages go
        into the bucket's static buffers first. Returns (first greedy
        token (1,), logits (1, V)), the step's outputs."""
        length = padded.shape[1]
        n_pages = self.allocator.pages_for(length) if self.paged else 0
        if length not in self._prefill_in:
            self._prefill_in[length] = (
                torch.zeros((1, length), dtype=torch.int32,
                            device=self.device),
                torch.zeros((2 + n_pages,), dtype=torch.int64,
                            device=self.device))
        tokens, args = self._prefill_in[length]
        tokens.copy_(torch.from_numpy(padded))
        pages = self.allocator.owned(slot)[:n_pages] if self.paged else []
        args.copy_(torch.tensor([plen, slot, *pages], dtype=torch.int64))
        true_len, at = args[0:1], args[1:2]

        def paged():
            tok, last, kv = paged_prefill_step(self.cfg, self.params, tokens,
                                               true_len)
            pages_insert(self.cache, kv, args[2:], at, true_len,
                         scale_group=self.kv_scale_group)
            return tok, last

        def bucket():
            tok, last, single = rolling_prefill_step(
                self.cfg, self.params, tokens, true_len, window=self.window)
            cache_insert(self.cache, single, at)
            return tok, last

        if self.paged:
            return self.graphs.run("prefill", "paged", length, paged)
        return self.graphs.run("prefill", "bucket", length, bucket)

    def _admit_prefix(self, req: Request, slot: int, hit: PrefixHit,
                      now: float):
        """Admit a request whose prefix is cached: its table row aliases
        the matched full pages (no prefill for them), the chain is
        gathered into the working buffer, and only the suffix is
        prefilled from an offset: synchronously in one bucketed step
        (gather, suffix, scatter: one captured step per suffix width), or
        as interleaved chunks when the suffix is long. A partly matched
        tail page is never aliased: its matched tokens ride the buffer
        into a private page (copy-on-write)."""
        self._tr_admit(req, now, "prefix", slot)
        if req.trace is not None:
            req.trace.spans[-1].meta["prefix_hit"] = hit.tokens
        plen = req.prompt_len
        n_full = len(hit.full_pages)
        owned = self.allocator.owned(slot)  # [shared full..., private...]
        start, end = self._suffix_plan(req, hit)
        chain = list(hit.full_pages)
        if hit.tail_page >= 0:
            chain.append(hit.tail_page)
        gpages = np.zeros((self.max_pages,), np.int64)
        gpages[:len(chain)] = chain
        trow = np.zeros((self.max_pages,), np.int64)
        trow[:len(owned)] = owned
        srow = np.zeros((self.max_pages,), np.int64)
        srow[n_full:len(owned)] = owned[n_full:]
        info = _HitAdmission(srow, trow, len(owned))
        req.prefix_hit_tokens = hit.tokens
        self.metrics.prefix_hits += 1
        self.metrics.prefix_hit_tokens += hit.tokens
        padded = np.zeros((1, end), np.int32)
        padded[0, :plen] = req.prompt
        if self._suffix_chunked(req, hit):
            self._hit_pending[slot] = info
            self._jobs.append(_PrefillJob(
                req=req, slot=slot, tokens=padded, true_len=plen,
                next_off=start, restore=req.state is RequestState.PREEMPTED,
                seed=gpages, tail_page=hit.tail_page))
            req.state = RequestState.PREFILL
            self.active[slot] = req  # reserved (decoding stays False)
            return
        tok, last = self._prefill_suffix(padded[:, start:], plen, start,
                                         gpages, info, slot)
        if hit.tail_page >= 0:
            self.allocator.release(hit.tail_page)  # gathered: unpin
        self.prefill_calls += 1
        self._activate(req, slot, tok, last, now, info.n_tabled)

    def _prefill_suffix(self, toks: np.ndarray, plen: int, start: int,
                        gpages: np.ndarray, info: _HitAdmission, slot: int):
        """A hit's synchronous suffix as one step keyed by its width: the
        chain gathered into the suffix buffer, the suffix tokens run from
        ``start``, the buffer scattered into the private pages and the
        slot's table row written. Returns (first greedy token, logits)."""
        width, p = toks.shape[1], self.max_pages
        if width not in self._suffix_in:
            self._suffix_in[width] = (
                torch.zeros((1, width), dtype=torch.int32,
                            device=self.device),
                torch.zeros((3 + 3 * p,), dtype=torch.int64,
                            device=self.device))
        tokens, args = self._suffix_in[width]
        tokens.copy_(torch.from_numpy(toks))
        args.copy_(torch.from_numpy(np.concatenate([
            np.array([start, plen, slot], np.int64), gpages,
            info.scatter_pages, info.table_pages])))

        def suffix():
            lin = self._lin_sfx
            prefix_seed_cache(self.cache, lin, args[3:3 + p], args[0:1])
            tok, last = prefill_chunk_step(self.cfg, self.params, lin,
                                           tokens, args[1:2])
            pages_insert_prefix(self.cache, lin, args[3 + p:3 + 2 * p],
                                args[3 + 2 * p:], args[2:3], args[1:2])
            return tok, last

        return self.graphs.run("prefill", "suffix", width, suffix)

    def _start_chunked(self, req: Request, slot: int, now: float):
        """Reserve the slot for chunked prefill: the prompt, padded to the
        chunk quantum, waits in the job queue (its pages are reserved)."""
        self._tr_admit(req, now, "chunked", slot)
        padded = np.zeros((1, self._prefill_len(req)), np.int32)
        padded[0, :req.prompt_len] = req.prompt
        self._jobs.append(_PrefillJob(
            req=req, slot=slot, tokens=padded, true_len=req.prompt_len,
            restore=req.state is RequestState.PREEMPTED))
        req.state = RequestState.PREFILL
        self.active[slot] = req  # reserved (decoding stays False)

    def _run_prefill_chunks(self, now: float):
        """Run as many chunks as the policy allots this tick, all of the
        head job's (the one working buffer), activating each job whose
        last chunk ran."""
        if not self._jobs:
            return
        pending = sum((j.tokens.shape[1] - j.next_off) // self.chunk
                      for j in self._jobs)
        n = self.prefill_policy.chunks_this_tick(
            self.cfg, n_decoding=self.n_decoding, pending_chunks=pending,
            context=self.window)
        tokens, args = self._chunk_in
        for _ in range(n):
            if not self._jobs:
                break
            job = self._jobs[0]
            if not job.started:
                self._take_buffer(job)
            off = job.next_off
            tokens.copy_(torch.from_numpy(job.tokens[:, off:off
                                                     + self.chunk]))
            args.copy_(torch.tensor([job.true_len], dtype=torch.int64))
            tok, last = self.graphs.run("aux", "chunk", self.chunk,
                                        self._chunk_step)
            job.next_off += self.chunk
            if off <= job.true_len - 1 < job.next_off:
                # the first token's logits live in the chunk holding
                # position true_len - 1; later chunks are pure padding
                job.tok, job.logits = tok.clone(), last.clone()
            self.metrics.prefill_chunks += 1
            if job.req.trace is not None:
                job.req.trace.event("prefill_chunk", now, offset=off,
                                    slot=job.slot)
            if job.next_off >= job.tokens.shape[1]:
                self._jobs.popleft()
                self._finish_job(job, now)

    def _chunk_step(self):
        tokens, args = self._chunk_in
        return prefill_chunk_step(self.cfg, self.params, self._lin, tokens,
                                  args)

    def _take_buffer(self, job: _PrefillJob):
        """The head job takes the working buffer: a prefix hit gathers its
        chain into it (and unpins its tail source), any other job starts
        it at position 0. What an earlier job left in rows past that
        position is masked, and overwritten before it is read."""
        job.started = True
        if job.seed is None:
            self._lin["pos"].zero_()
            return
        self._seed_in.copy_(torch.from_numpy(np.concatenate([
            np.array([job.next_off], np.int64), job.seed])))
        self.graphs.run("aux", "seed", self.max_pages, self._seed_step)
        if job.tail_page >= 0:
            self.allocator.release(job.tail_page)
            job.tail_page = -1

    def _seed_step(self):
        prefix_seed_cache(self.cache, self._lin, self._seed_in[1:],
                          self._seed_in[0:1])

    def _finish_job(self, job: _PrefillJob, now: float):
        """Install a job whose chunks all ran: scatter the working buffer
        into its pages and write its table row (paged: one captured step
        for every job, hit or not), or copy the ring into its slot
        (rolling); then activate it."""
        slot, n_tabled = job.slot, 0
        if self.paged:
            info = self._hit_pending.pop(slot, None)
            if info is None:  # the prompt's pages; the rest is trash
                n_pref = self.allocator.pages_for(job.tokens.shape[1])
                row = np.zeros((self.max_pages,), np.int64)
                row[:n_pref] = self.allocator.owned(slot)[:n_pref]
                info = _HitAdmission(row, row, n_pref)
            self._insert_in.copy_(torch.from_numpy(np.concatenate([
                np.array([job.true_len, slot], np.int64),
                info.scatter_pages, info.table_pages])))
            self.graphs.run("aux", "insert", self.max_pages,
                            self._insert_step)
            n_tabled = info.n_tabled
        else:
            self._insert_in[1] = slot
            self.graphs.run("aux", "ring", self.window, self._ring_step)
        self.prefill_calls += 1
        self._activate(job.req, slot, job.tok, job.logits, now, n_tabled,
                       restore=job.restore)

    def _insert_step(self):
        p, args = self.max_pages, self._insert_in
        pages_insert_prefix(self.cache, self._lin, args[2:2 + p],
                            args[2 + p:], args[1:2], args[0:1])

    def _ring_step(self):
        cache_insert(self.cache, self._lin, self._insert_in[1:2])

    def _activate(self, req: Request, slot: int, tok, last, now: float,
                  n_tabled: int = 0, restore: bool = False):
        """Install a prefilled request (its cache rows, table row and
        position already written): sampling state, first token (drawn at
        position prompt_len for a stochastic request, whatever path
        prefilled it), ``n_tabled`` table entries, the prompt's full pages
        into the prefix index, the budget cap, token carry. Flushes
        deferred tokens first so a fused window only ever spans a fixed
        slot membership. ``restore``: a preempted request re-admitted
        through chunks (its state went PREFILL meanwhile), counted as a
        restore like one prefilled at once (the reference counts only
        the latter: ROADMAP.md queue 3)."""
        self._flush(now)
        sp = req.sampling or SamplingParams()
        row = sampling_row(sp)
        if not (sp.greedy and self._samp_greedy_h[slot]):
            sampling_set(self._samp, slot, row)
        self._samp_greedy_h[slot] = sp.greedy
        if not sp.greedy:
            self.metrics.sampled_requests += 1
            samp1 = {k: v[slot:slot + 1] for k, v in self._samp.items()}
            pos1 = torch.full((1,), req.prompt_len, dtype=torch.int64,
                              device=self.device)
            tok = draw_tokens(last, samp1, pos1,
                              partitionable=self.partitionable)
        if self.paged:
            self._tabled[slot] = n_tabled
            if self.prefix_index is not None:
                # the finished prompt's FULL pages only: an indexed page
                # is never appended to again (the copy-on-write invariant)
                n_full = req.prompt_len // self.page_size
                if n_full:
                    self.prefix_index.register(
                        req.prompt, self.allocator.owned(slot)[:n_full])
            # the page table caps a request's lifetime tokens at max_seq;
            # restore-aware: only the remaining budget counts
            already = len(req.output)
            cap = max(1, self.max_seq - req.prompt_len)
            if req.max_new_tokens - already > cap:
                req.max_new_tokens = already + cap
                req.budget_capped = True
        self._pos_h[slot] = req.prompt_len
        self._tokens[slot] = tok[0]
        req.output.append(int(tok[0]))
        if req.prefill_done < 0:
            req.prefill_done = now
            self.metrics.ttfts.append(req.ttft)
            if req.browned_out_tokens:
                self.metrics.browned_out += 1
            if req.tenant:
                tm = self.metrics.tenant(req.tenant)
                tm.admitted += 1
                tm.ttfts.append(req.ttft)
                if req.browned_out_tokens:
                    tm.browned_out += 1
                    tm.brownout_trimmed_tokens += req.browned_out_tokens
        restored = restore or req.state is RequestState.PREEMPTED
        if restored:
            self.metrics.preempt_restores += 1
        t = req.trace
        if t is not None:
            if t.is_open("queued"):  # direct try_admit paths skip submit
                t.end("queued", now)
            if t.is_open("prefill"):
                t.end("prefill", now, tokens=req.prompt_len)
            if not sp.greedy:
                t.event("sample", now, seed=sp.seed)
            if restored:
                t.event("restore", now, slot=slot,
                        preemptions=req.preemptions)
            t.begin("decode", now, slot=slot)
        req.state = RequestState.DECODE
        self.active[slot] = req
        self.decoding[slot] = True
        if req.done:
            self._finalize_request(req, slot, now)

    # -- decode --------------------------------------------------------------
    def step(self, now: float) -> List[Request]:
        """One engine tick: abort doomed requests, pump queued admissions,
        run prefill chunks per the interleave policy, then batched decode.
        In steady state the whole ``sync_every`` window runs with one host
        sync. Returns the requests that finished this tick, aborted ones
        included (in a terminal state, with ``fail_reason``). With tracing
        on, the call's host wall time (``perf_counter``, no device sync)
        goes into the step-wall histogram."""
        self._last_now = now
        if not self._trace_on:
            return self._step(now)
        w0 = time.perf_counter()
        try:
            return self._step(now)
        finally:
            self._tick_wall.observe(time.perf_counter() - w0)

    def _step(self, now: float) -> List[Request]:
        self._reap_doomed(now)
        self._pump_admissions(now)
        self._run_prefill_chunks(now)
        if not any(self.decoding):
            return self._take_finished()
        if self._fusable():
            if self.paged:
                self._ensure_headroom(self.sync_every, now)
            self.graphs.run("decode", "scan", self.sync_every, self._window)
            self.metrics.decode_ticks += self.sync_every
            self._advance_pos(self.sync_every)
            self._distribute(self._hist.cpu().numpy(), now)
            return self._take_finished()
        if self.paged:
            self._ensure_headroom(1, now)
        self.graphs.run("decode", "tick", 1, self._tick)
        # the carry is the tick's output: keep it before the next step
        self._hist[self._unsynced].copy_(self._tokens)
        self._unsynced += 1
        self.metrics.decode_ticks += 1
        self._advance_pos(1)
        pend = self._unsynced
        if (pend >= self.sync_every
                or any(r is not None and d
                       and len(r.output) + pend >= r.max_new_tokens
                       for r, d in zip(self.active, self.decoding))):
            self._flush(now)
        return self._take_finished()

    def _tick(self):
        """The single decode tick, as a step: the carry in, the carry out."""
        nxt = decode_tick(self.cfg, self.params, self.cache, self._tokens,
                          self._samp, partitionable=self.partitionable)
        self._tokens.copy_(nxt)

    def _window(self):
        """The fused window, as a step: the carry in, ``_hist`` and the
        carry out."""
        toks, _ = decode_scan_step(
            self.cfg, self.params, self.cache, self._tokens, self._samp,
            n=self.sync_every, out=self._hist,
            partitionable=self.partitionable)
        self._tokens.copy_(toks)

    # -- lifecycle: cancel / timeout / shed ----------------------------------
    def _reap_doomed(self, now: float):
        """Abort every doomed request (cancelled, past its whole-request
        deadline, or, with ``shed_overdue``, still unprefilled past its
        TTFT deadline) wherever it sits: the backlog, the admission
        accumulator, a chunk job or a decode slot. Its slot and pages go
        back the same tick."""

        def doom(req: Request) -> Optional[RequestState]:
            d = req.overdue(now)
            if d is not None:
                return d
            if (self.shed_overdue and req.prefill_done < 0
                    and now > req.ttft_deadline):
                return RequestState.TIMED_OUT  # shed (counted apart)
            return None

        for queue in (self.backlog, self.admission.pending):
            doomed = [r for r in queue if doom(r) is not None]
            for req in doomed:
                queue.remove(req)
                self._abort(req, now, doom(req))
        for job in [j for j in self._jobs if doom(j.req) is not None]:
            self._jobs.remove(job)
            state = doom(job.req)
            if job.tail_page >= 0:  # never gathered: drop the pin
                self.allocator.release(job.tail_page)
            self.release_slot(job.slot)
            self._abort(job.req, now, state)
        # live slots: flush deferred tokens first, so the decision (and
        # every other slot's stream) sees complete outputs
        if any(r is not None and d and doom(r) is not None
               for r, d in zip(self.active, self.decoding)):
            self._flush(now)
            for i, (r, d) in enumerate(zip(self.active, self.decoding)):
                if r is None or not d:
                    continue
                state = doom(r)
                if state is not None:
                    self.release_slot(i)
                    self._abort(r, now, state)

    def _abort(self, req: Request, now: float, state: RequestState):
        """Terminal bookkeeping of an aborted request (its slot and pages
        already released by the caller)."""
        shed = (state is RequestState.TIMED_OUT
                and not req.cancel_requested and now <= req.jct_deadline)
        req.state = state
        req.finish_time = now
        if state is RequestState.CANCELLED:
            req.fail_reason = req.fail_reason or "cancelled by client"
            self.metrics.cancelled += 1
        elif shed:
            req.fail_reason = (f"shed: TTFT deadline "
                               f"{req.ttft_deadline:.4f} unreachable at "
                               f"{now:.4f} (overload)")
            self.metrics.shed += 1
            if req.tenant:
                self.metrics.tenant(req.tenant).shed += 1
        else:
            req.fail_reason = req.fail_reason or (
                f"timed out: exceeded timeout_s={req.timeout_s:.4f} "
                f"after arrival")
            self.metrics.timed_out += 1
        self._tr_terminal(req, now, "abort", state=state.value,
                          reason=req.fail_reason[:120])
        self._finished.append(req)

    def _fail_slot(self, slot: int, now: float, reason: str):
        """Fail ONLY the request in ``slot`` (mid-stream resource loss):
        the engine and every other stream keep running."""
        req = self.active[slot]
        self.release_slot(slot)
        req.state = RequestState.FAILED
        req.fail_reason = reason
        req.finish_time = now
        self.metrics.failed += 1
        self._tr_terminal(req, now, "abort", state="failed",
                          reason=reason[:120])
        self._finished.append(req)

    def takeover_queue(self) -> List[Request]:
        """Hand back every queued, unstarted request (backlog, then the
        admission accumulator, in drain order): the migration primitive
        of a retiring replica. Slots and chunk jobs stay and finish
        here."""
        out = list(self.backlog)
        self.backlog.clear()
        out.extend(self.admission.flush())
        return out

    def _advance_pos(self, n: int):
        for i, d in enumerate(self.decoding):
            if d:
                self._pos_h[i] += n

    def _ensure_headroom(self, n: int, now: float = 0.0):
        """Write every decoding slot's table entries for ``n`` more tokens
        before the window runs (table writes are host decisions). The
        pages come from the admission-time reservation; allocating here is
        the fallback for a bypassed reservation. A shortfall, after idle
        cached prefixes are evicted, fails ONLY the starved slot, with an
        ``OutOfPagesError`` text naming the sizing fix."""
        for i, (r, d) in enumerate(zip(self.active, self.decoding)):
            if r is None or not d:
                continue
            end = min(self._pos_h[i] + n, self.max_seq)
            need = self.allocator.pages_for(end)
            if need <= self._tabled[i]:
                continue
            owned = self.allocator.owned(i)
            if need > len(owned):
                if not self._alloc_evicting(i, need - len(owned)):
                    self._fail_slot(i, now, (
                        f"OutOfPagesError: slot {i} needs "
                        f"{need - len(owned)} page(s) mid-decode but the "
                        f"pool is exhausted ({self.allocator.pages_in_use}/"
                        f"{self.allocator.capacity} in use); size pool_pages "
                        f"for decode headroom "
                        f"(slots * max_seq / page_size + 1)"))
                    continue
                owned = self.allocator.owned(i)
            for k in range(self._tabled[i], need):
                page_table_append(self.cache, i, k, owned[k])
            self._tabled[i] = need

    def _fusable(self) -> bool:
        return (self.sync_every > 1
                and not self._unsynced
                and not self._jobs
                and not self.backlog
                and not self.admission.pending
                and all(r.max_new_tokens - len(r.output) >= self.sync_every
                        for r, d in zip(self.active, self.decoding)
                        if r is not None and d))

    def _flush(self, now: float = None):
        """One host sync for the deferred ticks' tokens."""
        if not self._unsynced:
            return
        toks = self._hist[:self._unsynced].cpu().numpy()
        self._unsynced = 0
        self._distribute(toks, now)

    def _distribute(self, toks: np.ndarray, now: float = None):
        """Hand a (T, B) host token block to the per-slot requests."""
        self.metrics.host_syncs += 1
        t_now = time.time() if now is None else now
        for i, r in enumerate(self.active):
            if r is None or not self.decoding[i]:
                continue
            tr = r.trace
            n0 = len(r.output) if tr is not None else 0
            done = False
            for t in range(toks.shape[0]):
                if r.done:
                    break
                tok = int(toks[t, i])
                r.output.append(tok)
                if r.done or tok == self.eos_id:
                    done = True
                    break
            if tr is not None and len(r.output) > n0:
                # one span per window whose sync delivered tokens here; t0
                # floors at the trace's latest span, so a request activated
                # (or restored) mid-window never starts before its decode
                # span; added before finalization so the collect sees it
                t0 = max(self._win_t0, r.prefill_done)
                if tr.spans:
                    t0 = max(t0, tr.spans[-1].t0)
                tr.add("decode_window", min(t0, t_now), t_now,
                       tokens=len(r.output) - n0)
            if done:
                self._finalize_request(r, i, t_now)
        self._win_t0 = t_now

    def _finalize_request(self, req: Request, slot: int, now: float):
        req.state = RequestState.FINISHED
        req.finish_time = now
        self._finished.append(req)
        self.release_slot(slot)
        self.metrics.completed += 1
        self.metrics.total_tokens += len(req.output)
        if req.tenant:
            tm = self.metrics.tenant(req.tenant)
            tm.completed += 1
            tm.total_tokens += len(req.output)
        jct = now - req.arrival_time
        self.metrics.jcts.append(jct)
        self.metrics.latencies.append(jct)
        if req.tpot > 0:
            self.metrics.tpots.append(req.tpot)
        self.metrics.record_slo(req)
        t = req.trace
        if t is not None:
            if t.is_open("decode"):
                t.end("decode", now, tokens=len(req.output))
            self.tracer.collect(t)

    def release_slot(self, slot: int):
        """Retire ``slot``: reset a stochastic lane to greedy (so a vacated
        slot's garbage lane never draws), zero its position and, in paged
        mode, return its pages (shared ones lose a reference) and point
        its table row at the trash page."""
        self.active[slot] = None
        self.decoding[slot] = False
        self._hit_pending.pop(slot, None)
        if not self._samp_greedy_h[slot]:
            sampling_set(self._samp, slot, sampling_row(None))
            self._samp_greedy_h[slot] = True
        slot_release(self.cache, slot)
        if self.paged:
            self.allocator.free_slot(slot)
        self._pos_h[slot] = 0
        self._tabled[slot] = 0

    def _take_finished(self) -> List[Request]:
        out, self._finished = self._finished, []
        return out

    def drain(self, now: float):
        """Flush any deferred tokens (end-of-run bookkeeping)."""
        self._flush(now)
        return self._take_finished()

    def reset(self):
        """Return the engine to an empty state — every slot vacated (pages
        reclaimed), chunk jobs, queues, the prefix index and metrics
        cleared — while keeping its compiled steps warm, so bench and test
        rounds reuse one engine without paying captures again (the
        reference's ``reset``). State is zeroed in place and no cache
        tensor is reallocated: the graphs hold their addresses. In-flight
        requests are abandoned, not finished."""
        self.drain(0.0)
        for job in self._jobs:
            if job.tail_page >= 0:
                self.allocator.release(job.tail_page)
        for i in range(self.slots):
            if self.active[i] is not None:
                self.release_slot(i)
        self._jobs.clear()
        self._hit_pending.clear()
        if self.prefix_index is not None:
            self.prefix_index.clear()  # cached pages back to the pool
        # vacated slots went on riding the batch: every slot back to a
        # fresh engine's position, table row and carry
        self.cache["pos"].zero_()
        if self.paged:
            self.cache["page_table"].zero_()
        self._tokens.zero_()
        self.backlog.clear()
        self.admission.flush()
        self._unsynced = 0
        self._finished = []
        self.metrics = ServeMetrics()
        # new span rollups and step walls; compile events persist, as the
        # compiled steps they count do
        self.tracer = Tracer(enabled=self._trace_on,
                             ring=self.config.trace_ring)
        self._tick_wall = latency_histogram()
        self._win_t0 = 0.0

    # -- prefix cache --------------------------------------------------------
    def prefix_match_len(self, tokens) -> int:
        """Cached-prefix length a prompt would hit here (0 with the index
        off): the router's affinity probe. Read-only."""
        if self.prefix_index is None:
            return 0
        return self.prefix_index.match_len(tokens)

    def clear_prefix_cache(self) -> int:
        """Drop every cached prefix (pages no slot aliases return to the
        pool at once). Returns the pages freed."""
        if self.prefix_index is None:
            return 0
        return self.prefix_index.clear()

    # -- telemetry -----------------------------------------------------------
    def load_report(self) -> LoadReport:
        """Snapshot of the engine's load for routing: free slots and pages,
        queued prefill tokens, unfinished decode budgets (per slot and per
        queued request too), and the cost model's seconds to drain it all.
        Host-side arithmetic only: no device sync."""
        queued = list(self.backlog) + list(self.admission.pending)
        if self.edf_backlog:
            queued.sort(key=lambda r: r.ttft_deadline)
        chunks_left = {j.slot: -(-(j.tokens.shape[1] - j.next_off)
                                 // max(1, self.chunk))
                       for j in self._jobs}
        remaining = []
        for i, r in enumerate(self.active):
            if r is None:
                continue
            rem = max(0, r.max_new_tokens - len(r.output))
            remaining.append(rem + chunks_left.get(i, 0))
        q_pref = sum(r.prompt_len for r in queued)
        q_pref += sum(max(0, j.tokens.shape[1] - j.next_off)
                      for j in self._jobs)
        dec_rem = sum(remaining) + sum(r.max_new_tokens for r in queued)
        pre_s = (estimate_prefill(self.cfg, 1, q_pref, chip=self.chip,
                                  n_chips=self.n_chips,
                                  mesh_axes=self._mesh_axes).latency_s
                 if q_pref > 0 else 0.0)
        dec_s = estimate_backlog_s(
            self.cfg, queued_prefill_tokens=0,
            decode_tokens_remaining=dec_rem, slots=self.slots,
            context=self.window, chip=self.chip, n_chips=self.n_chips,
            mesh_axes=self._mesh_axes)
        idx = self.prefix_index
        m = self.metrics
        tick = self._tick_est_s
        axis_cs = tuple(sorted(self._axis_collective_s.items()))
        return LoadReport(
            slots=self.slots,
            free_slots=sum(r is None for r in self.active),
            queued_requests=len(queued),
            queued_prefill_tokens=q_pref,
            decode_tokens_remaining=dec_rem,
            free_pages=self.allocator.free_pages if self.paged else -1,
            total_pages=self.allocator.capacity if self.paged else 0,
            backlog_s=pre_s + dec_s,
            tick_est_s=self._tick_est_s,
            queued_prefill_s=pre_s,
            active_remaining=tuple(remaining),
            queued_budgets=tuple(r.max_new_tokens for r in queued),
            prefix_cached_pages=idx.cached_pages if idx else 0,
            prefix_cached_tokens=idx.cached_tokens if idx else 0,
            prefix_hits=m.prefix_hits,
            prefix_hit_tokens=m.prefix_hit_tokens,
            rejected=m.rejected, cancelled=m.cancelled,
            timed_out=m.timed_out, shed=m.shed, failed=m.failed,
            preempted=m.preempted,
            mesh_axes=self.config.topology.mesh_axes,
            axis_collective_s=axis_cs,
            axis_util=tuple((a, s / tick if tick > 0 else 0.0)
                            for a, s in axis_cs),
            histograms=m.histogram_wire(),
            span_totals=self.tracer.totals_wire(),
            compile_events=tuple(sorted(self.compile_events.items())),
            browned_out=m.browned_out,
            tenant_stats=m.tenant_wire(),
            kv_bytes_per_token=kv_bytes_per_token(self.cfg, self.kv_dtype),
            kv_cache_dtype=self.kv_dtype,
            weight_dtype=self.config.precision.weight_dtype)

    @property
    def mesh_axes(self):
        """((name, size), ...) of a sharded replica's mesh; None on one
        card, as the reference's: the cost model's key for collective
        terms."""
        return self._mesh_axes

    @property
    def idle(self) -> bool:
        """No active, prefilling or queued work."""
        return (self.n_active == 0 and not self._jobs and not self.backlog
                and not self.admission.pending and not self._unsynced)

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.active)

    @property
    def n_decoding(self) -> int:
        return sum(self.decoding)

    @property
    def n_prefilling(self) -> int:
        return len(self._jobs)
