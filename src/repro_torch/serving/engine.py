"""Serving engine of the PyTorch port: the main path of the JAX package's
``repro/serving/engine.py`` — continuous batching over a paged KV cache on
dense archs, or over rolling caches (KV rings and recurrent states) on
archs that cannot page (recurrentgemma) and on dense archs with
``paged=False``; single-shot prefill (bucketed, or at the exact prompt
length where a recurrent state forbids end padding), fused decode windows
with one host sync per window, and device-resident sampling keyed by
(seed, absolute position).

Where the reference jits pure functions and donates buffers, the port
updates the page pools, page table, rings, recurrent states, positions,
token carry and sampling state IN PLACE (the engine is their only owner)
and, on a CUDA device, captures each step once per shape key into a CUDA
graph and replays it (``serving/graphs.py``): the single decode tick, the
fused ``sync_every`` window, and the bucketed prefill with its page
scatter (paged) or its copy into the slot (rolling). Exact-length prefill
(recurrentgemma, whose recurrent state forbids end padding) runs eagerly
and is not counted: the reference retraces it per prompt length. The
probes ``prefill_traces`` and ``decode_traces`` count the keys as the
reference counts its traces; on the CPU the same steps run eagerly. The
kernels of the path (prefill attention, paged or rolling-cache decode
attention, the RG-LRU scan, the sampler; under an int8 ``PrecisionConfig``
the int8 paged decode and the int8-weight matmul) are reached through
``repro_torch.kernels.ops``: plain PyTorch on a CPU device, the
hand-written Hopper kernels on CUDA.

Seeded streams match the reference's bits: the uniform of a stochastic
slot is ``uniform(fold_in(PRNGKey(seed), pos))`` from the port's
threefry (``serving/prng.py``) in the ``jax_threefry_partitionable`` mode
the engine is built with.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.costmodel import estimate_decode
from repro_torch.core.device import resolve_device
from repro_torch.core.misd.batching import BatchAccumulator, plan_admission
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
from repro_torch.serving.paging import PageAllocator
from repro_torch.serving.request import (
    Request,
    RequestRejected,
    RequestState,
    SamplingParams,
    ServeMetrics,
)

__all__ = [
    "EngineConfig", "ServingEngine", "cache_insert", "decode_scan_step",
    "decode_tick", "init_sampling_state", "page_table_append",
    "paged_prefill_step", "pages_insert", "prompt_bucket", "resolve_device",
    "rolling_prefill_step", "sampling_row", "sampling_set", "slot_release",
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


# ---------------------------------------------------------------------------
# continuous-batching executor
# ---------------------------------------------------------------------------


def _attn_only(cfg) -> bool:
    """Every block's decode cache is a KV ring (no recurrent state): the
    precondition for end-padded bucketed prefill."""
    return all(bt in KV_CACHE_BLOCKS for bt in layer_types(cfg))


def _min_cache_window(cfg, window: int) -> int:
    """The smallest KV ring of the model: a bucketed prefill must fit in
    it."""
    if "local_attn" in layer_types(cfg):
        return min(window, cfg.local_window)
    return window


class ServingEngine:
    """Single-card engine with continuous batching over a paged KV cache,
    or over rolling caches (the reference's ``ServingEngine`` main path;
    see its docstring for the knobs). ``paged`` None serves from pages
    whenever every block can, else from rolling caches; ``paged=True`` on
    an arch that cannot page raises, as the reference. ``device`` defaults
    to CUDA and raises when no card is present unless ``device="cpu"`` is
    asked for. ``threefry_partitionable`` selects the
    ``jax_threefry_partitionable`` mode whose bits seeded streams
    reproduce. ``prefill_traces`` and ``decode_traces`` are the
    reference's compile-count probes (``graphs.StepGraphs``)."""

    def __init__(self, cfg, params, config: Optional[EngineConfig] = None,
                 *, device="cuda", threefry_partitionable: bool = True):
        if config is None:
            config = EngineConfig()
        config.validate(cfg)
        self.config = config
        self.cfg = cfg
        self.device = resolve_device(device)
        self.partitionable = bool(threefry_partitionable)
        if config.precision.quantized_weights:
            # weight-only int8 at load: attention/MLP matmul weights
            # become {"w_q", "scale"} dicts (blocks.linear dispatches)
            params = quantize_weights(cfg, params)
        params = dict(params)
        if dtype_of(cfg) != torch.float32:
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
            kv_cache_dtype=self.kv_dtype)
        slots = config.slots or self.plan.slots
        self.slots = slots
        self._tick_est_s = estimate_decode(cfg, slots, config.window).latency_s
        self.eos_id = config.eos_id
        self.sync_every = 1 if config.eos_id >= 0 else max(1,
                                                           config.sync_every)
        # end-padded buckets need KV rings only (a recurrent state would
        # run over the pads); in rolling mode a bucket must fit the
        # smallest ring
        self.bucket_prompts = config.bucket_prompts and _attn_only(cfg)
        self._min_window = _min_cache_window(cfg, config.window)
        self.edf_backlog = config.edf_backlog
        self.metrics = ServeMetrics()
        if self.paged:
            self.pool_pages = config.pool_pages or slots * self.max_pages + 1
            self.allocator = PageAllocator(self.pool_pages, page_size)
            self.cache = init_paged_cache(
                cfg, slots, self.pool_pages, page_size, self.max_pages,
                device=self.device, kv_dtype=self.kv_dtype)
        else:
            self.pool_pages, self.allocator = 0, None
            self.cache = init_cache(cfg, slots, config.window,
                                    device=self.device)
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
        # per prompt bucket: its (1, L) token buffer and its int64
        # (true_len, slot, pages...) arguments
        self._prefill_in: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.graphs = StepGraphs(self.device)
        self._samp_greedy_h: List[bool] = [True] * slots
        self.active: List[Optional[Request]] = [None] * slots
        self.decoding: List[bool] = [False] * slots
        self._unsynced = 0  # deferred ticks whose tokens wait in _hist
        self._finished: List[Request] = []
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

    # -- admission ---------------------------------------------------------
    def submit(self, req: Request, now: float) -> bool:
        """Admit at once while a slot is free; once saturated, queue and
        batch admissions up to the cost-model deadline. An unservable
        request comes back FAILED from the next ``step`` (and ``False`` is
        returned) instead of raising."""
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
            if not self.try_admit(self.backlog[idx], now):
                break
            del self.backlog[idx]

    def _check_servable(self, req: Request):
        if self.paged and req.prompt_len > self.max_seq:
            raise RequestRejected(
                f"prompt of {req.prompt_len} tokens exceeds max_seq="
                f"{self.max_seq}; raise EngineConfig(max_seq=...)")

    def try_admit(self, req: Request, now: float) -> bool:
        """Claim a free slot and, in paged mode, the request's worst-case
        pages (padded prompt + token budget, capped at max_seq), then
        prefill. An exhausted pool refuses the admission (backpressure)."""
        self._check_servable(req)
        for i, r in enumerate(self.active):
            if r is None:
                if self.paged and not self._reserve_pages(req, i):
                    return False
                self._admit_now(req, i, now)
                return True
        return False

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
        """Padded prompt length: the bucket, else the page-rounded prompt
        (paged) or the exact prompt (rolling)."""
        plen = req.prompt_len
        bucket = self._bucket_for(plen)
        if bucket is not None:
            return bucket
        return _padded_len(plen, self.page_size) if self.paged else plen

    def _reserve_pages(self, req: Request, slot: int) -> bool:
        if self.allocator.owned(slot):
            slot_release(self.cache, slot)
            self.allocator.free_slot(slot)
            self._pos_h[slot] = 0
            self._tabled[slot] = 0
        lifetime = min(req.prompt_len + max(1, req.remaining_tokens) - 1,
                       self.max_seq)
        n = self.allocator.pages_for(max(self._prefill_len(req), lifetime))
        return self.allocator.alloc(slot, n) is not None

    def _admit_now(self, req: Request, slot: int, now: float):
        """Prefill: page-aligned linear prefill and page scatter (paged),
        or a bucket or the exact prompt into fresh rolling caches copied
        into the slot."""
        plen = req.prompt_len
        padded = np.zeros((1, self._prefill_len(req)), np.int32)
        padded[0, :plen] = req.prompt
        if self.paged or self._bucket_for(plen) is not None:
            tok, last = self._prefill_bucket(padded, plen, slot)
        else:
            tok, last, single = rolling_prefill_step(
                self.cfg, self.params, torch.from_numpy(padded).to(
                    self.device), plen, window=self.window)
            cache_insert(self.cache, single, slot)
        self.prefill_calls += 1
        self._activate(req, slot, tok, last, now)

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

    def _activate(self, req: Request, slot: int, tok, last, now: float):
        """Install a prefilled request (its cache rows already written):
        sampling state, first token (drawn at position prompt_len for a
        stochastic request), the table entries written, token carry.
        Flushes deferred tokens first so a fused window only ever spans a
        fixed slot membership."""
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
            self._tabled[slot] = self.allocator.pages_for(
                self._prefill_len(req))
            # the page table caps a request's lifetime tokens at max_seq
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
        req.state = RequestState.DECODE
        self.active[slot] = req
        self.decoding[slot] = True
        if req.done:
            self._finalize_request(req, slot, now)

    # -- decode --------------------------------------------------------------
    def step(self, now: float) -> List[Request]:
        """One engine tick: pump queued admissions, then batched decode. In
        steady state the whole ``sync_every`` window runs with one host
        sync. Returns the requests that finished this tick."""
        self._pump_admissions(now)
        if not any(self.decoding):
            return self._take_finished()
        if self._fusable():
            if self.paged:
                self._ensure_headroom(self.sync_every)
            self.graphs.run("decode", "scan", self.sync_every, self._window)
            self.metrics.decode_ticks += self.sync_every
            self._advance_pos(self.sync_every)
            self._distribute(self._hist.cpu().numpy(), now)
            return self._take_finished()
        if self.paged:
            self._ensure_headroom(1)
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

    def _advance_pos(self, n: int):
        for i, d in enumerate(self.decoding):
            if d:
                self._pos_h[i] += n

    def _ensure_headroom(self, n: int):
        """Write every decoding slot's table entries for ``n`` more tokens
        before the window runs (table writes are host decisions). The
        pages come from the admission-time reservation."""
        for i, (r, d) in enumerate(zip(self.active, self.decoding)):
            if r is None or not d:
                continue
            end = min(self._pos_h[i] + n, self.max_seq)
            need = self.allocator.pages_for(end)
            if need <= self._tabled[i]:
                continue
            owned = self.allocator.owned(i)
            for k in range(self._tabled[i], min(need, len(owned))):
                page_table_append(self.cache, i, k, owned[k])
            self._tabled[i] = min(need, len(owned))

    def _fusable(self) -> bool:
        return (self.sync_every > 1
                and not self._unsynced
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
            done = False
            for t in range(toks.shape[0]):
                if r.done:
                    break
                tok = int(toks[t, i])
                r.output.append(tok)
                if r.done or tok == self.eos_id:
                    done = True
                    break
            if done:
                self._finalize_request(r, i, t_now)

    def _finalize_request(self, req: Request, slot: int, now: float):
        req.state = RequestState.FINISHED
        req.finish_time = now
        self._finished.append(req)
        self.release_slot(slot)
        self.metrics.completed += 1
        self.metrics.total_tokens += len(req.output)
        jct = now - req.arrival_time
        self.metrics.jcts.append(jct)
        self.metrics.latencies.append(jct)
        if req.tpot > 0:
            self.metrics.tpots.append(req.tpot)
        self.metrics.record_slo(req)

    def release_slot(self, slot: int):
        """Retire ``slot``: reset a stochastic lane to greedy (so a vacated
        slot's garbage lane never draws), zero its position and, in paged
        mode, return its pages and neutralize its table row."""
        self.active[slot] = None
        self.decoding[slot] = False
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
        reclaimed), queues and metrics cleared — while keeping its compiled
        steps warm, so bench and test rounds reuse one engine without
        paying captures again (the reference's ``reset``). State is zeroed
        in place and no cache tensor is reallocated: the graphs hold their
        addresses. In-flight requests are abandoned, not finished."""
        self.drain(0.0)
        for i in range(self.slots):
            if self.active[i] is not None:
                self.release_slot(i)
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

    @property
    def idle(self) -> bool:
        return (self.n_active == 0 and not self.backlog
                and not self.admission.pending and not self._unsynced)

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.active)

    @property
    def n_decoding(self) -> int:
        return sum(self.decoding)
