#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order (phases 7 and 8 run after phase 5, on granite's
weights, before phase 6; phase 8's profiled round (e) runs last); any
failure exits non-zero:

1. Print the card (``nvidia-smi``), build every CUDA kernel of the port
   from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in
   parallel) and print the build seconds.
2. Hold each kernel against its plain PyTorch version on the card at
   granite-8b's full-width shapes (32 q heads over 8 kv heads, head_dim
   128, pages of 16, vocab 49152) in bfloat16 and float32: max abs error
   with its tolerance, the kernel's and the plain version's device time
   (20 calls in one CUDA graph, timed with CUDA events), the least time
   the card could take for the same work, and a PyTorch library call's
   time where one computes the same function, and the achieved TFLOP/s
   of each time for prefill attention and the int8 matmul. The int8
   kernels (paged decode over int8 pools, the int8-weight matmul)
   likewise, at the same shapes and at granite's projection shapes
   (decode M 8, the chunk steps' M 64, and prefill M 512). Rolling-cache
   decode attention also at the chunk and suffix steps' shapes: S 64 and
   S 512 queries of granite's width over one (1, 1024) linear buffer (256
   and 2048 query rows per kv head, in groups of 64), bf16 in units of
   2^-8 sum p|v| and bit for bit on a repeat call, float32 to 2e-5, with
   its time and bound. bf16 paged decode over model-dtype
   and int8 pools (the one-launch twin-order kernel) also prints its
   error in units of 2^-8 sum p|v| and must repeat bit for bit. Then recurrentgemma-9b's
   shapes: windowed prefill attention (S 2560, 16 q heads over 1 kv head,
   head_dim 256, window 2048), rolling-cache decode attention (8 rings of
   2048, S 1 and 4, rings partly filled to wrapped; bf16 on the one-pass
   kernel, also in units of 2^-8 sum p|v| and repeated bit for bit, and
   float32 on the three-launch one), the RG-LRU scan (L 4096, bit for
   bit) and the sampler at vocab 256000. The int8 matmul's bf16 decode
   tile is timed at M 8, 16 and 32. The sampler is timed at both
   vocabularies under two mixes (phase 2's, and the bursts': 4 greedy
   rows, 4 at T 0.8, top-k 50, top-p 0.95), with the rows each of its
   paths served.
3. Serve the same greedy and seeded requests through the port's
   ``ServingEngine`` on granite-8b ``reduced()`` (float32, 2 kv heads) on
   the card and on the CPU, in the model dtype, with int8 KV pages and
   int8 weights, and from rolling caches (``paged=False``); then
   recurrentgemma-9b ``reduced()`` cut to 5 layers (float32, window 64)
   with prompts longer than the window; then granite with chunked prefill
   (chunk 16: paged, ``paged=False`` and over int8 KV pages), prefix hits
   (a synchronous and a chunked suffix) and a preempted-and-restored
   seeded stream (with and without the prefix cache), which must also
   equal the same request's stream unpreempted; then a cluster of two
   granite replicas built from one set of weights behind the
   ``predicted`` policy with span tracing on, on a virtual clock, and
   the same cluster through ``FaultyEngine`` proxies with one replica
   killed mid-decode (its ledger replayed on the survivor); the streams
   must be token-identical (on the card, through the engine's CUDA
   graphs), and the cluster's must equal one engine's.
   Phases 4-6 pass ``chunk_prefill=0``: single-shot prefill, their cells
   as before chunked prefill was ported.
4. Serve granite-8b at full width (36 layers, bfloat16, random weights
   from a fixed seed): 8 slots, 16 requests of 20-600 prompt tokens and 64
   new tokens, half greedy and half seeded. One engine serves every
   round: a warm-up round captures its compiled steps (the decode tick,
   the fused window, a prefill per padded prompt length; captures and
   their seconds printed), then each round starts with ``reset()`` and
   replays them. Every request must finish with its budget, the measured
   round and a second one must give the warm-up round's streams, every
   kernel of the path must have launched (replays count the launches
   their capture recorded), and the probes must keep the reference's
   rule (a prefill graph per padded length, at most two decode graphs,
   none captured after the warm-up round). Prints TTFT p50 and p90 (host
   clock), tokens/s and peak device memory (allocated, and reserved with
   the graphs' pools); then serves 8 of the requests on the 8 slots at
   once and prints the steady decode rate and tick time.
5. Serve the same 16 requests at full width under quantized precision,
   each configuration on its own engine after its warm-up round, with
   the same gates on its graphs: int8 KV pages alone (every request
   finishes; each first token equals phase 4's, since prefill attends the
   unquantized K/V), then int8 KV pages and int8 weights (every request
   finishes, a second run gives the same streams, the int8 kernels
   launched; TTFT, tokens/s, peak memory, resident weight bytes, and the
   steady decode tick beside phase 4's).
6. With granite's weights freed, serve recurrentgemma-9b at full width
   (38 layers, bfloat16, random weights from a fixed seed) from rolling
   caches (rings of its native window 2048, 8 slots): phase 4's 16
   prompts and one of 2500 tokens (longer than the window, not a multiple
   of it), 64 new tokens each, half greedy and half seeded, on one engine
   after its warm-up round as in phase 4 (its prefill runs at the exact
   prompt length, eagerly: only decode is captured). Every request
   must finish, a second run must give the same streams, the prefill,
   rolling-decode, RG-LRU scan and sampler kernels must have launched,
   and the 2500-token prompt's first decode logits must match the full
   forward over the prompt and that token. Prints TTFT, tokens/s, peak
   memory and the steady decode tick of 8 slots beside its floor.

7. Before granite's weights go (it runs after phase 5, before phase 6):
   the reference's remaining admission paths at full width in bf16. (a)
   Chunked prefill with the reference's defaults (chunk 64,
   ``ChunkedPrefillPolicy()``): phase 4's 16 requests on one engine after
   its warm-up round; every request finishes with its 64 tokens, a second
   run gives the same streams, rolling-cache decode attention launched on
   the chunks, the graph rule holds (the chunk step and its activation
   scatter are captured, uncounted); prints prefill_chunks, TTFT p50 and
   p90, tok/s and the ms per decode tick while chunks interleave (every
   step synchronized), beside phase 4's engine served and timed the same
   way. (b) The prefix cache: two waves of 8 requests, each a shared
   512-token prefix (numpy seed 7) and its own suffix of 16-300 tokens;
   every request of the second wave hits 512 tokens or more, the pool
   then holds just the cached pages and nothing after
   ``clear_prefix_cache()``, nothing is captured after the warm-up round;
   prints each wave's TTFT. (c) A pool of half the full headroom with
   preemption on: 8 requests without a deadline, two cancelled
   mid-decode and one timing out (one tick a step), then 4 with a TTFT
   deadline that evict; at least one preemption, as many restores, every
   other request finished, and every page back.

8. Before granite's weights go (after phase 7): the cluster frontend at
   full width in bf16 on phase 4's weights: two replicas built from the
   one parameter dict (8 slots, max_seq 1024, the reference's defaults,
   span tracing on), 32 requests (phase 4's 16 prompts twice, two waves
   of 16, 64 new tokens, half seeded) on a virtual clock of one cost-model
   tick a step. Each replica pays its captures in a warm-up round that
   serves the 32 alone (which also gives one replica's streams); every
   later round starts with ``reset()`` and may capture nothing. (a)
   Routing under ``predicted``: every request finishes with its budget,
   every page comes back, the streams equal one replica's (a mismatch
   prints its first divergent token and top-2 logit gap); launches of
   each kernel per replica. (b) Replica 1 killed mid-decode through
   ``FaultyEngine`` proxies: round (a)'s streams, ``failed_over`` equal
   to the dead replica's ledger, every page back on the survivor. (c)
   Tenants ``gold=1:4`` and a rate-limited ``bulk`` under its offered
   load with the overload detector and circuit breaker armed: every gold
   request finishes, bulk shows typed rejections with a finite
   ``retry_after_s``, admitted streams equal (a)'s. (d) (a)'s Chrome
   trace validates, every finished request's trace holds queued, prefill
   and decode spans and (b)'s failed-over ones the failover events; two
   more replicas with tracing off, warmed the same way, serve (a)'s round
   with the same streams, host syncs and launches. (e), run after phase
   6 because a profiler session slows every later launch of the process:
   ``start_profile`` / ``stop_profile`` around a cluster round of a new
   pair (phase 4's seed) leave a non-empty directory. Prints
   per replica routed requests, utilization and residual, a wall-timed
   burst's tok/s and TTFT, span totals by kind, the step wall p50 and
   peak memory.

``--profile DIR`` repeats the steady-decode serve (8 requests on 8
slots) of phases 4, 5 and 6, and recurrentgemma's 2500-token prompt
alone (its prefill and one tick), under ``torch.profiler``, prints the
device's busy share, the kernel launches of each run and the device
time of the RG-LRU scan and the sampler, and writes its device-time table
by kernel into DIR.

The last two lines are the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``. With no CUDA device, or without the
repository's ``src/repro_torch`` beside it, the script exits non-zero and
prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BW = 3.35e12  # H100 SXM device memory, bytes/s (data sheet)
PEAK = {"bfloat16": 989e12, "float32": 67e12}  # dense FLOP/s (data sheet)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# The int8 paged decode kernel against its plain version. bfloat16 holds
# it to 1e-3 absolute, not 2e-2: a kernel that dequantizes in float32 and
# never rounds code * scale to q's dtype (the Pallas body's semantics)
# lies about 8e-3 away, so 2e-2 could not tell it from the twin.
INT8_DECODE_TOL = {"float32": 2e-5, "bfloat16": 1e-3}
# bf16 prefill attention is also held to its error in units of 2^-8 of
# sum_j p_j |v_j| (the attention of |v|, the scale of a row's rounding
# error): the kernel rounds P = exp(s - m) and the output to bf16, the
# twin the normalized p and the output, and each rounding moves a row by at
# most one unit of that scale, so they differ by about two units at any
# |o| (one bf16 step at the top of a binade), where the absolute 2e-2
# above is loose for long rows (|o| ~ 0.05) and tight at |o| >= 4. bf16
# rolling-cache decode attention rounds the same way and is held to the
# same units (against the decode attention of |v|).
BF16_UNIT, BF16_UNITS_TOL = 2.0 ** -8, 4.0
# The RG-LRU scan against its plain version: the reference suite's
# tolerance for its scan kernel (tests/test_kernels.py), printed beside
# the error; the gate is bit equality (the kernel rounds as the plain
# version does, in the same order).
SCAN_TOL = 1e-4
# recurrentgemma-9b's decode logits against its full forward, in float32
# at full width, relative to the largest logit: the two paths sum in
# another order (products of 1 and of S rows, the decode kernel against
# the prefill kernel) through 38 layers; in bfloat16 that rounding alone
# moves the logits by a few percent (printed, not a gate).
F32_DECODE_TOL = 1e-3


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", flush=True)
    return 1


def time_ms(torch, fn, iters: int = 20, warm: int = 3) -> float:
    """Device milliseconds of one ``fn(i)``: ``iters`` calls (i = 0, 1,
    ...) captured in one CUDA graph, so no host time falls between the
    launches; the median of 5 timed replays (CUDA events) over ``iters``.
    ``fn`` may cycle through several input sets by ``i`` to keep them
    out of the L2 cache, as the main path finds them."""
    for i in range(warm):
        fn(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) / iters)
    del graph
    return statistics.median(times)


def tflops(flops: float, ms: float) -> str:
    """The achieved rate of ``flops`` in ``ms`` milliseconds."""
    return f"{flops / ms / 1e9:.1f} TFLOP/s"


def bound(nbytes: float, flops: float, dtype: str):
    t_b, t_f = nbytes / HBM_BW, flops / PEAK[dtype]
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def bf16_units(got, want, q, k, v, *, causal=True, window=0):
    """max |got - want| / (2^-8 * attention(q, k, |v|)), the attention of
    |v| in float32 by the plain version."""
    from repro_torch.kernels import plain

    scale = plain.dense_attention(q.float(), k.float(), v.float().abs(),
                                  causal=causal, window=window)
    return ((got.float() - want.float()).abs() / scale).max().item() \
        / BF16_UNIT


def phase_kernels(torch, rec):
    """Phase 2: every kernel against its plain version, full width."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers as L

    dev = "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    H, KVH, D = 32, 8, 128
    ok = True

    # -- prefill attention --------------------------------------------------
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        for s in (16, 128, 512, 2048):
            q = torch.randn((1, s, H, D), generator=gen, device=dev).to(dt)
            k = torch.randn((1, s, KVH, D), generator=gen, device=dev).to(dt)
            v = torch.randn((1, s, KVH, D), generator=gen, device=dev).to(dt)
            got = ops.flash_attention(q, k, v, causal=True)
            want = L.dense_attention(q, k, v, causal=True)
            oracle = ref.ref_attention(
                q.transpose(1, 2).reshape(H, s, D),
                k.repeat_interleave(H // KVH, 2).transpose(1, 2).reshape(
                    H, s, D),
                v.repeat_interleave(H // KVH, 2).transpose(1, 2).reshape(
                    H, s, D)).reshape(1, H, s, D).transpose(1, 2)
            err = (got.float() - want.float()).abs().max().item()
            err_ref = (got.float() - oracle.float()).abs().max().item()
            tol = TOL[dt_name]
            good = err <= tol and err_ref <= tol
            units = ""
            if dt_name == "bfloat16":
                u, u_ref = (bf16_units(got, x, q, k, v)
                            for x in (want, oracle))
                good &= max(u, u_ref) <= BF16_UNITS_TOL
                units = (f" scaled {u:.3g} (vs ref {u_ref:.3g}) units of "
                         f"2^-8 sum p|v| tol={BF16_UNITS_TOL:g}")
            ok &= good
            ms = time_ms(torch, lambda i: ops.flash_attention(q, k, v))
            plain = time_ms(torch, lambda i: L.dense_attention(q, k, v,
                                                               causal=True))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib = time_ms(torch, lambda i: torch.nn.functional
                          .scaled_dot_product_attention(
                              qt, kt, vt, is_causal=True, enable_gqa=True))
            esz = q.element_size()
            nbytes = esz * (2 * q.numel() + k.numel() + v.numel())
            flops = 4.0 * H * D * s * (s + 1) / 2
            b_ms, b_by = bound(nbytes, flops, dt_name)
            print(f"prefill {dt_name} S={s}: max_abs_err={err:.3g} "
                  f"(vs ref.ref_attention {err_ref:.3g}) tol={tol}{units} "
                  f"{'ok' if good else 'FAIL'} ms={ms:.4f} "
                  f"({tflops(flops, ms)}) plain_ms={plain:.4f} "
                  f"({tflops(flops, plain)}) sdpa_ms={lib:.4f} "
                  f"({tflops(flops, lib)}) bound_ms={b_ms:.5f} ({b_by})",
                  flush=True)
            key = {512: "flash_attention", 2048: "flash_attention_s2048"}
            if dt_name == "bfloat16" and s in key:
                rec[key[s]].update(
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib)

    # -- paged decode attention ------------------------------------------------
    ps, n_pages, B = 16, 64, 8
    P = B * n_pages + 1
    ctx = [1, 15, 16, 17, 200, 513, 1000, 1024]  # partial and full pages
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        # 4 pool pairs (over 130 MB in bfloat16, more than the 50 MB L2):
        # the timed launches cycle through them, as the main path reads
        # each layer's pools cold
        pools = [tuple(torch.randn((P, ps, KVH, D), generator=gen,
                                   device=dev).to(dt) for _ in range(2))
                 for _ in range(4)]
        kp, vp = pools[0]
        perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
        table = perm[:B * n_pages].reshape(B, n_pages).to(torch.int32)
        table_rel = table.clone()
        table_rel[3] = 0  # a released slot: every entry the trash page
        for s in (1, 4, 8):
            for name, tab, pos_list in (
                    ("live", table, [max(c, s) for c in ctx]),
                    ("released", table_rel,
                     [max(c, s) if i != 3 else s for i, c in
                      enumerate(ctx)])):
                pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
                q = torch.randn((B, s, H, D), generator=gen,
                                device=dev).to(dt)
                got = ops.paged_decode_attention(q, kp, vp, tab, pos)
                want = L.paged_decode_attention(q, kp, vp, tab, pos)
                oracle = ref.ref_paged_decode_attention(q, kp, vp, tab, pos)
                err = (got.float() - want.float()).abs().max().item()
                err_ref = (got.float() - oracle.float()).abs().max().item()
                tol = TOL[dt_name]
                good = err <= tol and err_ref <= tol
                units = ""
                if dt_name == "bfloat16":
                    u = paged_units(got, want, q, kp, vp, tab, pos)
                    same = bool(torch.equal(
                        got, ops.paged_decode_attention(q, kp, vp, tab,
                                                        pos)))
                    good &= same
                    units = (f" scaled {u:.3g} units of 2^-8 sum p|v|, a "
                             f"second call bit-identical: {same}")
                ok &= good
                line = (f"paged decode {dt_name} S={s} {name}: "
                        f"max_abs_err={err:.3g} (vs ref {err_ref:.3g}) "
                        f"tol={tol}{units} {'ok' if good else 'FAIL'}")
                if name == "live" and s in (1, 4):
                    ms = time_ms(torch, lambda i: ops.paged_decode_attention(
                        q, *pools[i % 4], tab, pos))
                    plain = time_ms(torch, lambda i: L.paged_decode_attention(
                        q, *pools[i % 4], tab, pos))
                    esz = q.element_size()
                    valid = sum(min(p, n_pages * ps) for p in pos_list)
                    nbytes = (esz * (2 * valid * KVH * D + 2 * q.numel())
                              + 4 * (tab.numel() + B))
                    flops = 4.0 * valid * H * D * s
                    b_ms, b_by = bound(nbytes, flops, dt_name)
                    line += (f" ms={ms:.4f} plain_ms={plain:.4f} "
                             f"bound_ms={b_ms:.5f} ({b_by})")
                    if dt_name == "bfloat16" and s == 1:
                        rec["paged_decode_attention"].update(
                            max_abs_err=err, ms=ms, plain_ms=plain,
                            bound_ms=b_ms, bound_by=b_by, library_ms=None)
                print(line, flush=True)

    ok &= chunk_decode_kernel(torch, rec, gen, H, KVH, D)
    ok &= int8_decode_kernel(torch, rec, gen, H, KVH, D)
    ok &= int8_matmul_kernel(torch, rec, gen)

    # -- sampler -----------------------------------------------------------------
    V = 49152
    logits = torch.randn((B, V), generator=gen, device=dev) * 4.0
    logits[0, 7] = logits[0, 9] = logits[0].max() + 1.0  # an argmax tie
    good, res = sampler_check(torch, logits, 1000, 100, 7)
    ok &= good
    mism, _, ms, plain, b_ms, b_by = res["phase 2"]
    rec["sample_tokens"].update(max_abs_err=float(mism), ms=ms,
                                plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                                library_ms=None)
    temp = sampler_mixes(torch, dev, B)["phase 2"][1]

    kk = torch.randint(1, V + 1, (B,), generator=gen, device=dev,
                       dtype=torch.int32)
    kk[0], kk[1] = 1, V
    uu = torch.rand((B, V), generator=gen, device=dev)
    got = ops.topk_sample(logits, kk, temp, uu)
    want_ref = ref.ref_topk_sample(logits, kk, temp, uu)
    want = L.topk_sample(logits, kk, temp, uu)
    good = bool((got == want_ref).all()) and bool((got == want).all())
    ok &= good
    ms = time_ms(torch, lambda i: ops.topk_sample(logits, kk, temp, uu))
    plain = time_ms(torch, lambda i: L.topk_sample(logits, kk, temp, uu))
    print(f"topk_sample (Pallas semantics) B={B} V={V}: exact vs "
          f"ref.ref_topk_sample and plain: {'ok' if good else 'FAIL'} "
          f"ms={ms:.4f} plain_ms={plain:.4f}", flush=True)
    ok &= hybrid_kernels(torch, rec, gen)
    return ok


def sampler_mixes(torch, dev, B):
    """(greedy, temperature, top_k, top_p) of phase 2's mix (every path of
    the kernel) and of the bursts' (half greedy, half T 0.8, top-k 50,
    top-p 0.95)."""
    return {
        "phase 2": (torch.tensor([1, 0, 0, 1, 0, 0, 0, 1], dtype=torch.bool,
                                 device=dev),
                    torch.tensor([1.0, 0.7, 1.3, 1.0, 0.9, 1.0, 0.5, 1.0],
                                 device=dev),
                    torch.tensor([0, 50, 0, 0, 200, 0, 1, 0],
                                 dtype=torch.int32, device=dev),
                    torch.tensor([1.0, 1.0, 0.9, 1.0, 0.95, 1.0, 1.0, 1.0],
                                 device=dev)),
        "burst": (torch.arange(B, device=dev) < B // 2,
                  torch.full((B,), 0.8, device=dev),
                  torch.full((B,), 50, dtype=torch.int32, device=dev),
                  torch.full((B,), 0.95, device=dev)),
    }


def sampler_check(torch, logits, seed0, pos0, tie):
    """Each mix: 16 draws against the plain sampler (row r's uniforms at
    key ``seed0 + r`` and positions ``pos0 ..``; exact tokens, row 0 of
    phase 2's mix at the argmax tie ``tie``), a repeat call
    bit-identical, the rows each path served in one call, and the device
    time. Returns (ok, {mix: (mismatches, draws, ms, plain ms)})."""
    from repro_torch.kernels import ops, plain
    from repro_torch.serving import prng

    dev, (B, V) = logits.device, logits.shape
    keys = torch.tensor([prng.prng_key(seed0 + i) for i in range(B)],
                        dtype=torch.int64, device=dev)
    ok, out = True, {}
    for name, (greedy, temp, top_k, top_p) in sampler_mixes(
            torch, dev, B).items():
        n_draws, mismatches, same = 0, 0, True
        for step in range(16):
            pos = torch.full((B,), pos0 + step, dtype=torch.int64,
                             device=dev)
            u = prng.uniform(prng.fold_in(keys, pos), True)
            got = ops.sample_tokens(logits, greedy, temp, top_k, top_p, u)
            want = plain.sample_tokens(logits, greedy, temp, top_k, top_p, u)
            mismatches += int((got.long() != want.long()).sum())
            same &= bool(torch.equal(got, ops.sample_tokens(
                logits, greedy, temp, top_k, top_p, u)))
            n_draws += B
        ops.reset_launches()
        ops.sample_tokens(logits, greedy, temp, top_k, top_p, u)
        paths = ops.path_rows()
        good = mismatches == 0 and same
        if name == "phase 2":
            good &= int(got[0]) == tie
        ok &= good
        ms = time_ms(torch, lambda i: ops.sample_tokens(
            logits, greedy, temp, top_k, top_p, u))
        pl_ms = time_ms(torch, lambda i: plain.sample_tokens(
            logits, greedy, temp, top_k, top_p, u))
        b_ms, b_by = bound(4 * B * V + 4 * 6 * B, 0.0, "float32")
        print(f"sample_tokens B={B} V={V} {name} mix: token mismatches "
              f"{mismatches}/{n_draws} (exact equality required), repeat "
              f"calls bit-identical: {same}, rows by path "
              + ", ".join(f"{k}={v}" for k, v in paths.items())
              + f" {'ok' if good else 'FAIL'} ms={ms:.4f} plain_ms="
              f"{pl_ms:.4f} bound_ms={b_ms:.5f} ({b_by})", flush=True)
        out[name] = (mismatches, n_draws, ms, pl_ms, b_ms, b_by)
    return ok, out


def paged_units(got, want, q, k_pool, v_pool, table, pos):
    """max |got - want| / (2^-8 * paged decode attention of |v|), the
    attention of |v| in float32 by the plain version; an element equal in
    both counts 0 (int8 codes of 0 make the attention of |v| 0 where a
    query sees one row)."""
    import torch
    from repro_torch.kernels import plain

    scale = plain.paged_decode_attention(q.float(), k_pool.float(),
                                         v_pool.float().abs(), table, pos)
    diff = (got.float() - want.float()).abs()
    return torch.where(diff > 0, diff / scale,
                       torch.zeros_like(diff)).max().item() / BF16_UNIT


def ring_units(got, want, q, k, v, pos):
    """max |got - want| / (2^-8 * decode attention of |v|) over rolling
    caches, the attention of |v| in float32 by the plain version."""
    from repro_torch.kernels import plain

    scale = plain.decode_attention(q.float(), k.float(), v.float().abs(),
                                   pos)
    return ((got.float() - want.float()).abs() / scale).max().item() \
        / BF16_UNIT


def hybrid_kernels(torch, rec, gen):
    """recurrentgemma-9b's kernel shapes: windowed prefill attention at
    head_dim 256, rolling-cache decode attention, the RG-LRU scan and the
    sampler at vocab 256000, each against its plain version."""
    from repro_torch.kernels import ops, plain, ref

    dev = "cuda"
    H, KVH, D, WIN = 16, 1, 256, 2048
    ok = True

    # -- prefill attention over the local window ---------------------------
    S = 2560
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        q = torch.randn((1, S, H, D), generator=gen, device=dev).to(dt)
        k = torch.randn((1, S, KVH, D), generator=gen, device=dev).to(dt)
        v = torch.randn((1, S, KVH, D), generator=gen, device=dev).to(dt)
        got = ops.flash_attention(q, k, v, causal=True, window=WIN)
        want = plain.dense_attention(q, k, v, causal=True, window=WIN)
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL[dt_name]
        good = err <= tol
        units = ""
        if dt_name == "bfloat16":
            u = bf16_units(got, want, q, k, v, window=WIN)
            good &= u <= BF16_UNITS_TOL
            units = (f" scaled {u:.3g} units of 2^-8 sum p|v| "
                     f"tol={BF16_UNITS_TOL:g}")
        ok &= good
        ms = time_ms(torch, lambda i: ops.flash_attention(
            q, k, v, causal=True, window=WIN))
        pl_ms = time_ms(torch, lambda i: plain.dense_attention(
            q, k, v, causal=True, window=WIN), iters=4)
        pos = torch.arange(S, device=dev)
        band = (pos[None, :] <= pos[:, None]) & (pos[None, :]
                                                 > pos[:, None] - WIN)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = time_ms(torch, lambda i: torch.nn.functional
                      .scaled_dot_product_attention(
                          qt, kt, vt, attn_mask=band, enable_gqa=True))
        pairs = sum(min(t + 1, WIN) for t in range(S))
        nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        flops = 4.0 * H * D * pairs
        b_ms, b_by = bound(nbytes, flops, dt_name)
        print(f"prefill local {dt_name} S={S} H={H}/{KVH} D={D} "
              f"window={WIN}: max_abs_err={err:.3g} tol={tol}{units} "
              f"{'ok' if good else 'FAIL'} ms={ms:.4f} "
              f"({tflops(flops, ms)}) plain_ms={pl_ms:.4f} "
              f"({tflops(flops, pl_ms)}) sdpa_mask_ms={lib:.4f} "
              f"({tflops(flops, lib)}) bound_ms={b_ms:.5f} ({b_by})",
              flush=True)
        if dt_name == "bfloat16":
            rec["flash_attention_local"].update(
                max_abs_err=err, ms=ms, plain_ms=pl_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib)
        del q, k, v, got, want, band

    # -- decode attention over rolling caches --------------------------------
    B, W = 8, 2048
    ctx = [1, 100, 777, 2047, 2048, 2049, 3000, 5000]  # up to wrapped rings
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        # 4 ring pairs (67 MB in bfloat16, more than the 50 MB L2), cycled
        # by the timed launches as the main path reads each layer's cold
        rings = [tuple(torch.randn((B, W, KVH, D), generator=gen,
                                   device=dev).to(dt) for _ in range(2))
                 for _ in range(4)]
        kc, vc = rings[0]
        for s in (1, 4):
            pos = torch.tensor([max(c, s) for c in ctx], dtype=torch.int32,
                               device=dev)
            q = torch.randn((B, s, H, D), generator=gen, device=dev).to(dt)
            got = ops.decode_attention(q, kc, vc, pos)
            want = plain.decode_attention(q, kc, vc, pos)
            err = (got.float() - want.float()).abs().max().item()
            line = ""
            if s == 1:  # the oracle takes one query row per (slot, head)
                oracle = ref.ref_decode_attention(
                    q.transpose(1, 2).reshape(B * H, s, D),
                    kc.expand(B, W, H, D).transpose(1, 2).reshape(
                        B * H, W, D),
                    vc.expand(B, W, H, D).transpose(1, 2).reshape(
                        B * H, W, D),
                    torch.clamp(pos, max=W).repeat_interleave(H))
                e_ref = (got.float() - oracle.reshape(B, H, s, D)
                         .transpose(1, 2).float()).abs().max().item()
                line = f" (vs ref {e_ref:.3g})"
                err = max(err, e_ref)
            tol = TOL[dt_name]
            good = err <= tol
            units = ""
            if dt_name == "bfloat16":
                u = ring_units(got, want, q, kc, vc, pos)
                same = bool(torch.equal(
                    got, ops.decode_attention(q, kc, vc, pos)))
                good &= u <= BF16_UNITS_TOL and same
                units = (f" scaled {u:.3g} units of 2^-8 sum p|v| "
                         f"tol={BF16_UNITS_TOL:g}, a second call "
                         f"bit-identical: {same}")
            ok &= good
            ms = time_ms(torch, lambda i: ops.decode_attention(
                q, *rings[i % 4], pos))
            pl_ms = time_ms(torch, lambda i: plain.decode_attention(
                q, *rings[i % 4], pos))
            n_s = torch.arange(s, device=dev)
            valid = torch.clamp(pos[:, None] - (s - 1) + n_s, max=W)
            mask = (torch.arange(W, device=dev)[None, None, None, :]
                    < valid[:, None, :, None])  # (B, 1, S, W)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, kc, vc))
            lib = time_ms(torch, lambda i: torch.nn.functional
                          .scaled_dot_product_attention(
                              qt, kt, vt, attn_mask=mask, enable_gqa=True))
            rows = int(torch.clamp(pos, max=W).sum())
            esz = q.element_size()
            nbytes = esz * (2 * rows * KVH * D + 2 * q.numel()) + 4 * B
            b_ms, b_by = bound(nbytes, 4.0 * rows * H * D * s, dt_name)
            print(f"rolling decode {dt_name} B={B} W={W} S={s} H={H}/{KVH} "
                  f"D={D} pos {ctx[0]}..{ctx[-1]}: max_abs_err={err:.3g}"
                  f"{line} tol={tol}{units} {'ok' if good else 'FAIL'} "
                  f"ms={ms:.4f} plain_ms={pl_ms:.4f} sdpa_mask_ms={lib:.4f}"
                  f" bound_ms={b_ms:.5f} ({b_by})", flush=True)
            if dt_name == "bfloat16" and s == 1:
                rec["decode_attention"].update(
                    max_abs_err=err, ms=ms, plain_ms=pl_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib)
        del rings, kc, vc

    # -- the RG-LRU scan -----------------------------------------------------
    for b, s, l in ((1, 2560, 4096), (2, 384, 4096)):
        sets = [(torch.rand((b, s, l), generator=gen, device=dev) * 0.2
                 + 0.79, torch.randn((b, s, l), generator=gen, device=dev),
                 torch.randn((b, l), generator=gen, device=dev))
                for _ in range(2)]
        a, x, h0 = sets[0]
        y, h = ops.rglru_scan(a, x, h0)
        y_want, h_want = plain.rglru_scan(a, x, h0)
        err = max((y - y_want).abs().max().item(),
                  (h - h_want).abs().max().item())
        good = err == 0.0
        ok &= good
        ms = time_ms(torch, lambda i: ops.rglru_scan(*sets[i % 2]))
        pl_ms = time_ms(torch, lambda i: plain.rglru_scan(*sets[i % 2]),
                        iters=2, warm=1)
        b_ms, b_by = bound(3.0 * b * s * l * 4 + 2 * b * l * 4,
                           2.0 * b * s * l, "float32")
        print(f"rglru_scan B={b} S={s} L={l}: max_abs_err={err:.3g} "
              f"(exactly 0 required; the reference's tolerance {SCAN_TOL}) "
              f"{'ok' if good else 'FAIL'} ms={ms:.4f} "
              f"plain_ms={pl_ms:.4f} bound_ms={b_ms:.5f} ({b_by}); no "
              f"library call computes this recurrence", flush=True)
        if s == 2560:
            rec["rglru_scan"].update(
                max_abs_err=err, ms=ms, plain_ms=pl_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)
        del sets, a, x, h0, y, h, y_want, h_want

    # -- the sampler at vocab 256000 -----------------------------------------
    V = 256000
    logits = torch.randn((B, V), generator=gen, device=dev) * 4.0
    logits[0, V - 5] = logits[0, 3] = logits[0].max() + 1.0  # a tie
    good, res = sampler_check(torch, logits, 2000, 300, 3)
    mismatches, _, ms, pl_ms, b_ms, b_by = res["phase 2"]
    temp = sampler_mixes(torch, dev, B)["phase 2"][1]
    kk = torch.randint(1, V + 1, (B,), generator=gen, device=dev,
                       dtype=torch.int32)
    kk[0], kk[1] = 1, V
    uu = torch.rand((B, V), generator=gen, device=dev)
    topk_good = bool((ops.topk_sample(logits, kk, temp, uu)
                      == ref.ref_topk_sample(logits, kk, temp, uu)).all())
    good &= topk_good
    ok &= good
    print(f"topk_sample (Pallas semantics) B={B} V={V}: exact vs "
          f"ref.ref_topk_sample: {topk_good} {'ok' if good else 'FAIL'}",
          flush=True)
    rec["sample_tokens_v256k"].update(
        max_abs_err=float(mismatches), ms=ms, plain_ms=pl_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    return ok


def chunk_decode_kernel(torch, rec, gen, H, KVH, D):
    """Rolling-cache decode attention at the chunk and suffix steps'
    shapes: S queries of granite's width over one (1, 1024) linear buffer
    (G * S query rows in groups of 64), S 64 (a chunk of prefill, the
    buffer's last) and S 512 (a suffix of 512 from 512), held to the
    plain version: bf16 in units of 2^-8 sum p|v| and bit for bit on a
    repeat call, float32 to 2e-5."""
    from repro_torch.kernels import ops, plain

    dev, W = "cuda", 1024
    ok = True
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        # 4 buffer pairs, cycled by the timed launches: the chunk steps
        # read each layer's buffer cold
        bufs = [tuple(torch.randn((1, W, KVH, D), generator=gen,
                                  device=dev).to(dt) for _ in range(2))
                for _ in range(4)]
        kc, vc = bufs[0]
        for s in (64, 512):
            pos = torch.tensor([W], dtype=torch.int32, device=dev)
            q = torch.randn((1, s, H, D), generator=gen, device=dev).to(dt)
            got = ops.decode_attention(q, kc, vc, pos)
            want = plain.decode_attention(q, kc, vc, pos)
            err = (got.float() - want.float()).abs().max().item()
            tol = TOL[dt_name]
            if dt_name == "bfloat16":
                u = ring_units(got, want, q, kc, vc, pos)
                same = bool(torch.equal(
                    got, ops.decode_attention(q, kc, vc, pos)))
                good = u <= BF16_UNITS_TOL and same
                units = (f" scaled {u:.3g} units of 2^-8 sum p|v| "
                         f"tol={BF16_UNITS_TOL:g}, a second call "
                         f"bit-identical: {same}")
            else:
                good, units = err <= tol, f" tol={tol}"
            ok &= good
            ms = time_ms(torch, lambda i: ops.decode_attention(
                q, *bufs[i % 4], pos))
            pl_ms = time_ms(torch, lambda i: plain.decode_attention(
                q, *bufs[i % 4], pos), iters=4)
            n_s = torch.arange(s, device=dev)
            valid = torch.clamp(pos[:, None] - (s - 1) + n_s, max=W)
            mask = (torch.arange(W, device=dev)[None, None, None, :]
                    < valid[:, None, :, None])
            qt, kt, vt = (x.transpose(1, 2) for x in (q, kc, vc))
            lib = time_ms(torch, lambda i: torch.nn.functional
                          .scaled_dot_product_attention(
                              qt, kt, vt, attn_mask=mask, enable_gqa=True))
            esz = q.element_size()
            nbytes = esz * (2 * W * KVH * D + 2 * q.numel()) + 4
            b_ms, b_by = bound(nbytes, 4.0 * H * D * int(valid.sum()),
                               dt_name)
            print(f"chunk decode {dt_name} (1, {W}) buffer S={s} "
                  f"H={H}/{KVH} D={D} ({H // KVH * s} query rows per kv "
                  f"head): max_abs_err={err:.3g}{units} "
                  f"{'ok' if good else 'FAIL'} ms={ms:.4f} "
                  f"plain_ms={pl_ms:.4f} sdpa_mask_ms={lib:.4f} "
                  f"bound_ms={b_ms:.5f} ({b_by})", flush=True)
            if dt_name == "bfloat16" and s == 64:
                rec["decode_attention_chunk"].update(
                    max_abs_err=err, ms=ms, plain_ms=pl_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib)
        del bufs, kc, vc
    return ok


def int8_decode_kernel(torch, rec, gen, H, KVH, D):
    """The int8 paged decode kernel against its plain version (the twin
    ``layers.paged_decode_attention_int8``), the oracle, the Pallas body's
    float32-dequant semantics (printed), and within
    ``int8_attention_output_bound`` (plus the type's tolerance, for the
    rounding of both outputs) of the model-dtype kernel on the unquantized
    K/V."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers as L
    from repro_torch.models.blocks import dequantize_kv, quantize_kv

    dev = "cuda"
    ps, n_pages, B = 16, 64, 8
    P = B * n_pages + 1
    ctx = [1, 15, 16, 17, 200, 513, 1000, 1024]  # partial and full pages
    ok = True
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        tol, tol_twin = TOL[dt_name], INT8_DECODE_TOL[dt_name]
        raw = [torch.randn((P * ps, KVH, D), generator=gen,
                           device=dev).to(dt) for _ in range(2)]
        perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
        table = perm[:B * n_pages].reshape(B, n_pages).to(torch.int32)
        table_rel = table.clone()
        table_rel[3] = 0  # a released slot: every entry the trash page
        for gran in ("page", "token"):
            group = ps if gran == "page" else 0
            # 4 pool sets (about 70 MB, more than the 50 MB L2) for the
            # timed launches, as the main path reads each layer's cold
            sets = []
            for i in range(4):
                pools = []
                for t in raw:
                    if i:
                        t = torch.randn(t.shape, generator=gen,
                                        device=dev).to(dt)
                    q8, sc = quantize_kv(t, group=group)
                    pools += [q8.reshape(P, ps, KVH, D),
                              sc.reshape(P, ps, KVH, 1)]
                sets.append((pools[0], pools[2], pools[1], pools[3]))
            k8, v8, ks, vs = sets[0]
            kraw, vraw = (t.reshape(P, ps, KVH, D) for t in raw)
            for s in (1, 4):
                for name, tab, pos_list in (
                        ("live", table, [max(c, s) for c in ctx]),
                        ("released", table_rel,
                         [max(c, s) if i != 3 else s for i, c in
                          enumerate(ctx)])):
                    pos = torch.tensor(pos_list, dtype=torch.int32,
                                       device=dev)
                    q = torch.randn((B, s, H, D), generator=gen,
                                    device=dev).to(dt)
                    args = (k8, v8, ks, vs, tab, pos)
                    got = ops.paged_decode_attention_int8(q, *args)
                    want = L.paged_decode_attention_int8(q, *args)
                    oracle = ref.ref_paged_decode_attention_int8(q, *args)
                    pallas = ref.ref_paged_decode_attention(
                        q, dequantize_kv(k8, ks, torch.float32),
                        dequantize_kv(v8, vs, torch.float32), tab, pos)
                    exact = ops.paged_decode_attention(q, kraw, vraw, tab,
                                                       pos)
                    bnd = float(ref.int8_attention_output_bound(
                        q, ks, vs, dequantize_kv(v8, vs, dt)))

                    def err(x):
                        return (got.float() - x.float()).abs().max().item()

                    e, e_ref, e_pal, e_ex = (err(want), err(oracle),
                                             err(pallas), err(exact))
                    good = (e <= tol_twin and e_ref <= tol
                            and e_ex <= bnd + tol)
                    units = ""
                    if dt_name == "bfloat16":
                        u = paged_units(got, want, q, dequantize_kv(
                            k8, ks, dt), dequantize_kv(v8, vs, dt), tab, pos)
                        same = bool(torch.equal(
                            got, ops.paged_decode_attention_int8(q, *args)))
                        good &= same
                        units = (f"; scaled {u:.3g} units of 2^-8 sum "
                                 f"p|v|, a second call bit-identical: "
                                 f"{same}")
                    ok &= good
                    line = (f"paged decode int8 {dt_name} {gran} scales "
                            f"S={s} {name}: max_abs_err={e:.3g} "
                            f"tol={tol_twin} (vs ref {e_ref:.3g} "
                            f"tol={tol}); vs float32-dequant "
                            f"(Pallas body) {e_pal:.3g}; vs unquantized "
                            f"kernel {e_ex:.3g} <= bound {bnd:.3g} + tol"
                            f"{units} {'ok' if good else 'FAIL'}")
                    if name == "live":
                        ms = time_ms(torch, lambda i: (
                            ops.paged_decode_attention_int8(
                                q, *sets[i % 4], tab, pos)))
                        plain = time_ms(torch, lambda i: (
                            L.paged_decode_attention_int8(
                                q, *sets[i % 4], tab, pos)))
                        valid = sum(min(p, n_pages * ps) for p in pos_list)
                        nbytes = (2 * valid * KVH * (D + 4)
                                  + 2 * q.element_size() * q.numel()
                                  + 4 * (tab.numel() + B))
                        flops = 4.0 * valid * H * D * s
                        b_ms, b_by = bound(nbytes, flops, dt_name)
                        line += (f" ms={ms:.4f} plain_ms={plain:.4f} "
                                 f"bound_ms={b_ms:.5f} ({b_by})")
                        if dt_name == "bfloat16" and s == 1 \
                                and gran == "page":
                            rec["paged_decode_attention_int8"].update(
                                max_abs_err=e, ms=ms, plain_ms=plain,
                                bound_ms=b_ms, bound_by=b_by,
                                library_ms=None)
                    print(line, flush=True)
            del sets
    return ok


def int8_matmul_kernel(torch, rec, gen):
    """The int8-weight matmul against its plain version at granite's
    projection shapes, decode (M = 8) and prefill (M = 512); the library
    yardstick is torch.matmul with the same weight held in x's dtype (the
    projection the kernel replaces)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers as L

    dev = "cuda"
    ok = True
    for dt_name in ("bfloat16", "float32"):
        dt = getattr(torch, dt_name)
        tol = TOL[dt_name]
        for k, n in ((4096, 4096), (4096, 1024), (4096, 14336),
                     (14336, 4096)):
            # enough weight sets to exceed the 50 MB L2 between launches
            n_sets = max(1, -(-120_000_000 // (k * n)))
            ws = [ops.quantize_int8(torch.randn((k, n), generator=gen,
                                                device=dev))
                  for _ in range(n_sets)]
            w_lib = [(q.to(torch.float32) * s).to(dt) for q, s in ws]
            w_q, scale = ws[0]
            for m in ((8, 16, 32, 64, 512) if dt_name == "bfloat16"
                      else (8, 512)):
                x = torch.randn((m, k), generator=gen, device=dev).to(dt)
                got = ops.int8_matmul(x, w_q, scale)
                want = L.int8_matmul(x, w_q, scale)
                oracle = ref.ref_int8_matmul(x, w_q, scale)
                e = (got.float() - want.float()).abs().max().item()
                rel = e / want.float().abs().max().item()
                e_ref = (got.float() - oracle.float()).abs().max().item()
                # float32 sums of K products in another order: relative
                good = rel <= tol
                ok &= good
                ms = time_ms(torch, lambda i: ops.int8_matmul(
                    x, *ws[i % n_sets]))
                plain = time_ms(torch, lambda i: L.int8_matmul(
                    x, *ws[i % n_sets]))
                lib = time_ms(torch, lambda i: torch.matmul(
                    x, w_lib[i % n_sets]))
                esz = x.element_size()
                nbytes = k * n + esz * (m * k + m * n) + 4 * n
                flops = 2.0 * m * k * n
                b_ms, b_by = bound(nbytes, flops, dt_name)
                print(f"int8_matmul {dt_name} M={m} K={k} N={n}: "
                      f"max_abs_err={e:.3g} (relative {rel:.3g}, vs "
                      f"ref.ref_int8_matmul {e_ref:.3g}) tol={tol} "
                      f"{'ok' if good else 'FAIL'} ms={ms:.4f} "
                      f"({tflops(flops, ms)}) plain_ms={plain:.4f} "
                      f"({tflops(flops, plain)}) "
                      f"matmul_{dt_name}_ms={lib:.4f} "
                      f"({tflops(flops, lib)}) bound_ms={b_ms:.5f} "
                      f"({b_by})", flush=True)
                key = {(8, 4096, 14336): "int8_matmul",
                       (512, 14336, 4096): "int8_matmul_prefill"}
                if dt_name == "bfloat16" and (m, k, n) in key:
                    rec[key[m, k, n]].update(
                        max_abs_err=e, ms=ms, plain_ms=plain, bound_ms=b_ms,
                        bound_by=b_by, library_ms=lib)
            del ws, w_lib
    return ok


def serve(torch, cfg, params, prompts, *, device, max_new, slots, max_seq,
          sync_every=8, seeded=lambda i: i % 2 == 1, precision=None,
          eng=None, reset=True, step_log=None, **engine):
    """Serve ``prompts`` at once; ``engine`` holds further EngineConfig
    fields (``paged``, ``window``, ``chunk_prefill``, ``prefix_cache``).
    ``eng``: an engine of an earlier round, served on again after its
    ``reset()`` (its CUDA graphs captured; ``reset=False`` keeps its
    state, a prefix cache's index with it), in place of a new one. With
    ``step_log`` a list, every ``step`` is synchronized and logged as
    (seconds, chunks, decode ticks, prefills activated). The engine comes
    back in the stats."""
    from repro_torch.serving import (
        EngineConfig,
        PrecisionConfig,
        Request,
        SamplingParams,
        ServingEngine,
    )

    if eng is None:
        eng = ServingEngine(cfg, params,
                            EngineConfig(slots=slots, max_seq=max_seq,
                                         sync_every=sync_every,
                                         precision=PrecisionConfig(
                                             **(precision or {})),
                                         **engine),
                            device=device)
    elif reset:
        eng.reset()
    reqs = [Request(rid=i, prompt=p, max_new_tokens=max_new,
                    sampling=(SamplingParams(temperature=0.8, top_k=50,
                                             top_p=0.95, seed=1000 + i)
                              if seeded(i) else SamplingParams()))
            for i, p in enumerate(prompts)]
    # TTFT on the host clock: a request's first token exists once the
    # submit or step call that admitted it returns (the engine's own
    # ``ttft`` stamps the time the call began, before its prefill ran)
    ttft = {}

    def stamp():
        now = time.perf_counter() - t0
        for r in reqs:
            if r.output and r.rid not in ttft:
                ttft[r.rid] = now

    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r, time.perf_counter() - t0)
        stamp()
    t_admitted = time.perf_counter() - t0
    done = 0
    while done < len(reqs):
        m = eng.metrics
        before = (m.prefill_chunks, m.decode_ticks, eng.prefill_calls)
        t_step = time.perf_counter()
        done += len(eng.step(time.perf_counter() - t0))
        if step_log is not None:
            torch.cuda.synchronize()
            step_log.append((time.perf_counter() - t_step,
                             m.prefill_chunks - before[0],
                             m.decode_ticks - before[1],
                             eng.prefill_calls - before[2]))
        stamp()
    done += len(eng.drain(time.perf_counter() - t0))
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    weight_bytes = sum(
        t.numel() * t.element_size() for t in _leaves(eng.params))
    return reqs, {"wall": wall, "ttft": [ttft[r.rid] for r in reqs],
                  "after_submit": wall - t_admitted,
                  "ticks": eng.metrics.decode_ticks,
                  "weight_bytes": weight_bytes, "engine": eng}


def warm_round(torch, label, cfg, params, prompts, run):
    """The warm-up round of a served path: a new engine serves
    ``prompts``, paying every capture of its compiled steps. Returns
    (requests, stats); prints the captures and their host seconds."""
    reqs, st = serve(torch, cfg, params, prompts, **run)
    g = st["engine"].graphs
    print(f"{label} warm-up round: {g.captures} CUDA graphs captured in "
          f"{g.capture_s:.2f}s of {st['wall']:.3f}s wall (keys "
          + ", ".join(f"{name}{n}" for _, name, n in g.keys) + ")",
          flush=True)
    st["captures"] = g.captures
    return reqs, st


def graphs_ok(label, warm, st):
    """The reference's compile-count rule on an engine after its measured
    rounds: at most one prefill graph per padded prompt length the warm-up
    round captured single-shot (bucketed, or page-rounded past the
    buckets), one counted eager key per exact prompt length (never
    captured), at most two decode graphs (tick and window), one capture
    per key (the uncounted "aux" steps of chunked prefill included: one
    chunk step, its activation scatter), and none after the warm-up
    round."""
    eng = st["engine"]
    exact = {r.prompt_len for r in warm if not eng._chunkable(r)
             and not eng.paged and eng._bucket_for(r.prompt_len) is None}
    seen = {eng._prefill_len(r) for r in warm if not eng._chunkable(r)
            and (eng.paged or eng._bucket_for(r.prompt_len) is not None)}
    g = eng.graphs
    aux = sorted(f"{name}{n}" for kind, name, n in g.keys if kind == "aux")
    captured = eng.prefill_traces - g.eager
    ok = (captured <= len(seen) and g.eager <= len(exact)
          and eng.decode_traces <= 2
          and g.captures == captured + eng.decode_traces
          + len(aux) == st["captures"])
    print(f"{label} graphs: prefill_traces={eng.prefill_traces} (padded "
          f"lengths seen {len(seen)}; exact-length eager keys {g.eager} of "
          f"{len(exact)} lengths), decode_traces={eng.decode_traces} "
          f"(at most 2), aux {aux}, captures {g.captures} (after the "
          f"warm-up round {st['captures']}), replays {g.replays}, capture "
          f"{g.capture_s:.2f}s {'ok' if ok else 'FAIL'}", flush=True)
    return ok


def memory(torch) -> str:
    """Peak device memory since the last reset of the peak: allocated by
    tensors, and reserved by the allocator (the graphs' pools, whose
    temporaries no tensor holds between replays, are counted only
    there)."""
    gib = 2 ** 30
    return (f"peak device memory {torch.cuda.max_memory_allocated() / gib:.2f}"
            f" GiB allocated, {torch.cuda.max_memory_reserved() / gib:.2f} "
            f"GiB reserved")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def phase_reduced(torch):
    """Phase 3: reduced float32 streams, CUDA vs CPU: granite in the model
    dtype, with int8 KV pages and int8 weights, and from rolling caches;
    recurrentgemma (5 layers, rings of 64) with prompts past the window."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params, quantize_weights

    cfg = dataclasses.replace(get_config("granite-8b").reduced(),
                              num_kv_heads=2)
    hybrid = dataclasses.replace(get_config("recurrentgemma-9b").reduced(),
                                 num_layers=5)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 23, 40, 17, 64, 9)]
    long_prompts = [rng.integers(0, hybrid.vocab_size, n).astype(np.int32)
                    for n in (100, 5, 130, 64, 23, 70)]
    weights = {}
    ok = True
    for label, arch, precision, engine in (
            ("granite f32", cfg, None, {}),
            ("granite int8 kv + int8 weights", cfg,
             dict(kv_cache_dtype="int8", weight_dtype="int8"), {}),
            ("granite f32 paged=False", cfg, None, dict(paged=False)),
            ("granite f32 chunked 16", cfg, None, dict(chunk_prefill=16)),
            ("granite f32 paged=False chunked 16", cfg, None,
             dict(paged=False, chunk_prefill=16)),
            ("granite int8 kv chunked 16", cfg,
             dict(kv_cache_dtype="int8"), dict(chunk_prefill=16)),
            ("recurrentgemma 5 layers f32, rings of 64", hybrid, None, {})):
        if arch.name not in weights:
            p_cpu = init_params(arch, seed=0, device="cpu")
            weights[arch.name] = (p_cpu, _to(torch, p_cpu, "cuda"))
        p_cpu, p_gpu = weights[arch.name]
        ps = long_prompts if arch is hybrid else prompts
        run = dict(max_new=24, slots=3, max_seq=128, precision=precision,
                   **engine)
        a, st_a = serve(torch, arch, p_gpu, ps, device="cuda", **run)
        b, _ = serve(torch, arch, p_cpu, ps, device="cpu", **run)
        p_ref = (quantize_weights(arch, p_cpu) if precision else p_cpu)
        for ra, rb in zip(a, b):
            if ra.output == rb.output:
                continue
            i = next(j for j, (x, y) in enumerate(zip(ra.output, rb.output))
                     if x != y)
            toks = np.concatenate([rb.prompt, np.asarray(rb.output[:i],
                                                         np.int32)])
            logits, _ = forward(arch, p_ref, torch.from_numpy(toks)[None])
            top2 = torch.topk(logits[0, -1], 2).values
            gap = float(top2[0] - top2[1])
            kind = "seeded" if ra.sampling.temperature > 0 else "greedy"
            print(f"reduced {label} rid={ra.rid} ({kind}): first divergent "
                  f"token #{i}: cuda {ra.output[i]} vs cpu {rb.output[i]}, "
                  f"top-2 logit gap {gap:.3g}", flush=True)
            if gap > 1e-4:
                ok = False
        n_tok = sum(len(r.output) for r in a)
        chunks = st_a["engine"].metrics.prefill_chunks
        print(f"reduced {label}: {len(a)} requests (prompts "
              f"{min(map(len, ps))}-{max(map(len, ps))}), {n_tok} tokens, "
              f"cuda streams == cpu streams: "
              f"{all(x.output == y.output for x, y in zip(a, b))}"
              + (f", prefill_chunks {chunks}" if chunks else ""),
              flush=True)
        if engine.get("chunk_prefill") and not chunks:
            ok = False
            print(f"FAIL: reduced {label} ran no prefill chunk", flush=True)
    ok &= reduced_prefix_and_preempt(torch, cfg, *weights[cfg.name])
    ok &= reduced_cluster(torch, cfg, *weights[cfg.name])
    return ok


def cluster_round(ts, cfg, params, device, prompts, *, replicas=2,
                  kill_at=None):
    """Phase 3's cluster: ``replicas`` engines from one set of weights
    (the first engine's params) behind the ``predicted`` policy with span
    tracing on, through ``FaultyEngine`` proxies; ``kill_at``: the virtual
    step at which the last replica is killed. One step a tick of virtual
    time; every request arrives at 0. Returns (streams, frontend)."""
    engines = []
    for _ in range(replicas):
        engines.append(ts.ServingEngine(
            cfg, engines[0].params if engines else params,
            ts.EngineConfig(slots=3, max_seq=128, sync_every=4,
                            tracing=True), device=device))
    proxies = [ts.FaultyEngine(e) for e in engines]
    fe = ts.ClusterFrontend(proxies, policy="predicted", tracing=True,
                            max_retries=3)
    inj = ts.FaultInjector({i.name: p for i, p in zip(fe.instances,
                                                       proxies)})
    if kill_at is not None:
        inj.schedule(float(kill_at), fe.instances[-1].name, "kill")
    reqs = [ts.Request(rid=i, prompt=p, max_new_tokens=24,
                       sampling=(ts.SamplingParams(temperature=0.8, top_k=50,
                                                   top_p=0.95, seed=1000 + i)
                                 if i % 2 else ts.SamplingParams()))
            for i, p in enumerate(prompts)]
    for r in reqs:
        fe.submit(r, 0.0)
    t, done = 0.0, 0
    while done < len(reqs) and t < 2000:
        t += 1.0
        inj.tick(t)
        done += len(fe.step(t))
    fe.drain(t)
    return [r.output for r in reqs], fe


def reduced_cluster(torch, cfg, p_cpu, p_gpu):
    """Phase 3, the cluster frontend: two replicas on the card and on the
    CPU give the same streams, which equal one engine's; killed at step 6
    (mid-decode), the survivor replays the dead replica's ledger into the
    same streams."""
    import numpy as np

    from repro_torch import serving as ts

    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 23, 40, 17, 64, 9, 31, 12)]
    ok = True
    runs = {}
    for params, device in ((p_gpu, "cuda"), (p_cpu, "cpu")):
        runs[device, "single"], _ = cluster_round(ts, cfg, params, device,
                                                  prompts, replicas=1)
        runs[device, "cluster"], fe = cluster_round(ts, cfg, params, device,
                                                    prompts)
        routed = {i.name: i.routed for i in fe.instances}
        runs[device, "killed"], fk = cluster_round(ts, cfg, params, device,
                                                   prompts, kill_at=6)
        m = fk.merged_metrics()
        print(f"reduced granite f32 cluster on {device}: routed {routed}; "
              f"killed at step 6: failed {[i.name for i in fk.failed]}, "
              f"failed_over {m.failed_over}, retried {m.retried}, "
              f"survivor pages in use "
              f"{fk.instances[0].engine.allocator.pages_in_use}", flush=True)
        ok &= (len(fk.failed) == 1 and m.failed_over > 0
               and fk.instances[0].engine.allocator.pages_in_use == 0)
    same = len({str(v) for v in runs.values()}) == 1
    ok &= same
    print(f"reduced granite f32 cluster (2 replicas, predicted, tracing "
          f"on; and one killed mid-decode): cuda streams == cpu streams "
          f"== one engine's: {same} {'ok' if same else 'FAIL'}",
          flush=True)
    return ok


def prefix_round(ts, eng, now=None):
    """A 64-token template (chunked at 16), then, arriving together, a hit
    with a 5-token suffix (one suffix step), a hit with a 40-token suffix
    (chunks after the gather) and a cold 90-token prompt; half seeded.
    Returns each request's (stream, prefix-hit tokens)."""
    import numpy as np

    rng = np.random.default_rng(5)
    tpl = rng.integers(0, 500, 64).astype(np.int32)
    waves = [[tpl], [np.concatenate([tpl, rng.integers(0, 500, n)])
                     .astype(np.int32) for n in (5, 40)]
             + [rng.integers(0, 500, 90).astype(np.int32)]]
    out, t, rid = [], 0.0, 0
    for wave in waves:
        reqs = []
        for p in wave:
            reqs.append(ts.Request(rid=rid, prompt=p, max_new_tokens=12,
                                   sampling=(ts.SamplingParams(
                                       temperature=0.8, top_k=20,
                                       seed=300 + rid) if rid % 2
                                       else ts.SamplingParams())))
            eng.submit(reqs[-1], t)
            rid += 1
        while not all(r.done for r in reqs):
            t += 1.0
            eng.step(t)
        eng.drain(t)
        out += [(r.output, r.prefix_hit_tokens) for r in reqs]
    return out


def preempt_round(ts, eng, preempt: bool):
    """A seeded 20-token request decoding 10 tokens on one slot; with
    ``preempt``, a higher-priority request arrives after 3 ticks and
    evicts it. Returns (its stream, its preemptions)."""
    import numpy as np

    sp = ts.SamplingParams(temperature=0.7, top_k=20, top_p=0.95, seed=77)
    victim = ts.Request(0, np.random.default_rng(0).integers(
        0, 500, 20).astype(np.int32), max_new_tokens=10, sampling=sp,
        ttft_slo_s=100.0)
    assert eng.try_admit(victim, 0.0)
    reqs, t = [victim], 0.0
    for t in (1.0, 2.0, 3.0):
        eng.step(t)
    if preempt:
        hot = ts.Request(1, np.random.default_rng(9).integers(
            0, 500, 10).astype(np.int32), max_new_tokens=3, priority=1,
            ttft_slo_s=1.0)
        eng.submit(hot, t)
        reqs.append(hot)
    while not all(r.done for r in reqs):
        t += 1.0
        eng.step(t)
    return list(victim.output), victim.preemptions


def reduced_prefix_and_preempt(torch, cfg, p_cpu, p_gpu):
    """Phase 3, the prefix cache and preemption: prefix hits (a
    synchronous suffix and a chunked one) and a preempted-and-restored
    stream (with and without the prefix cache), on the card and on the
    CPU, token for token; the restored stream must also equal the same
    request's stream without preemption."""
    from repro_torch import serving as ts

    ok = True
    outs = {}
    for params, device in ((p_gpu, "cuda"), (p_cpu, "cpu")):
        eng = ts.ServingEngine(cfg, params, ts.EngineConfig(
            slots=3, max_seq=256, sync_every=3, chunk_prefill=16,
            prefix_cache=True), device=device)
        outs[device] = prefix_round(ts, eng)
    hits = [h for _, h in outs["cpu"]]
    good = outs["cuda"] == outs["cpu"] and hits == [0, 64, 64, 0]
    ok &= good
    print(f"reduced granite f32 prefix cache (chunk 16): prefix-hit tokens "
          f"{hits}, cuda streams == cpu streams: "
          f"{outs['cuda'] == outs['cpu']} {'ok' if good else 'FAIL'}",
          flush=True)
    kw = dict(slots=1, window=64, max_seq=64, sync_every=1, chunk_prefill=0)
    for prefix_cache in (False, True):
        runs = {}
        for params, device in ((p_gpu, "cuda"), (p_cpu, "cpu")):
            for preempt in (False, True):
                eng = ts.ServingEngine(cfg, params, ts.EngineConfig(
                    preemption=preempt, prefix_cache=prefix_cache, **kw),
                    device=device)
                runs[device, preempt] = preempt_round(ts, eng, preempt)
        stream = runs["cpu", False][0]
        good = (runs["cuda", True][1] >= 1
                and all(v[0] == stream for v in runs.values()))
        ok &= good
        print(f"reduced granite f32 preempted and restored (prefix cache "
              f"{prefix_cache}): preemptions {runs['cuda', True][1]}, "
              f"restored stream == unpreempted stream on cuda and cpu: "
              f"{good} {'ok' if good else 'FAIL'}", flush=True)
    return ok


def _to(torch, tree, device):
    if isinstance(tree, dict):
        return {k: _to(torch, v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(torch, v, device) for v in tree]
    return tree.to(device)


def phase_full(torch, rec, full, profile_dir=None):
    """Phase 4: granite-8b at full width through the engine. Leaves the
    weights, prompts, streams and steady tick in ``full`` for phase 5."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params

    cfg = get_config("granite-8b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_par = sum(p.numel() for lay in params["layers"]
                for sub in lay.values() for p in sub.values())
    n_par += params["embed"].numel() + params["lm_head"].numel()
    print(f"full width granite-8b: {n_par / 1e9:.3f} B params (bf16) "
          f"initialized in {time.perf_counter() - t0:.1f}s", flush=True)
    rng = np.random.default_rng(0)
    lens = rng.integers(20, 601, 16)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    run = dict(device="cuda", max_new=64, slots=8, max_seq=1024,
               chunk_prefill=0)
    warm, st0 = warm_round(torch, "granite bf16", cfg, params, prompts, run)
    run["eng"] = st0["engine"]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    reqs, st = serve(torch, cfg, params, prompts, **run)
    launches = dict(ops.LAUNCHES)
    mem = memory(torch)
    ok = True
    unfinished = [r.rid for r in reqs
                  if r.state.value != "finished" or len(r.output) != 64]
    if unfinished:
        ok = False
        print(f"FAIL: requests without their 64 tokens: {unfinished}")
    same = all(a.output == b.output for a, b in zip(warm, reqs))
    ok &= same
    print(f"measured round (replays) identical to the warm-up round (first "
          f"calls eager): {same}", flush=True)
    rec["flash_attention_s2048"]["launches"] = launches["flash_attention"]
    for name in ("flash_attention", "paged_decode_attention",
                 "sample_tokens"):
        rec[name]["launches"] = launches[name]
        if launches[name] <= 0:
            ok = False
            print(f"FAIL: kernel {name} never launched on the main path")
    n_tok = sum(len(r.output) for r in reqs)
    print(f"full width: {len(reqs)} requests at once on 8 slots (prompts "
          f"{int(lens.min())}-{int(lens.max())} tokens, 64 new, half "
          f"seeded), {n_tok} tokens in {st['wall']:.3f}s -> "
          f"{n_tok / st['wall']:.1f} tok/s, TTFT p50 "
          f"{statistics.median(st['ttft']) * 1e3:.1f} ms p90 "
          f"{np.percentile(st['ttft'], 90) * 1e3:.1f} ms, {mem}",
          flush=True)
    print("kernels (launches on the main path): "
          + ", ".join(f"{k}={v}" for k, v in launches.items())
          + "; sampler rows by path: "
          + ", ".join(f"{k}={v}" for k, v in ops.path_rows().items()),
          flush=True)

    reqs2, _ = serve(torch, cfg, params, prompts, **run)
    same = all(a.output == b.output for a, b in zip(reqs, reqs2))
    ok &= same
    print(f"second run identical: {same}", flush=True)

    # steady decode: 8 requests fill the 8 slots at once, so after the
    # submissions (8 prefills) every step is a decode window of 8 slots
    reqs3, st3 = serve(torch, cfg, params, prompts[:8], **run)
    dec_tok = sum(len(r.output) - 1 for r in reqs3)
    print(f"decode at 8 slots: {dec_tok} tokens in "
          f"{st3['after_submit']:.3f}s -> "
          f"{dec_tok / st3['after_submit']:.1f} tok/s, "
          f"{st3['after_submit'] / st3['ticks'] * 1e3:.2f} ms per tick "
          f"({st3['ticks']} ticks; before the engine's tracing hooks: "
          f"10.06 ms)", flush=True)
    print(f"burst launches beside those before the engine's tracing "
          f"hooks: flash_attention {launches['flash_attention']} (576), "
          f"paged_decode_attention {launches['paged_decode_attention']} "
          f"(4536), sample_tokens {launches['sample_tokens']} (134); per "
          f"decode tick {launches['paged_decode_attention'] / st['ticks']:.1f}"
          f" paged decode and {launches['sample_tokens'] / st['ticks']:.2f} "
          f"sampler launches ({st['ticks']} ticks)", flush=True)
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        ops.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, st4 = serve(torch, cfg, params, prompts[:8], **run)
        write_profile(prof, profile_dir, st4, "decode_kernels.txt")
    ok &= graphs_ok("granite bf16", warm, st0)
    del run["eng"]
    full.update(cfg=cfg, params=params, prompts=prompts, run=run,
                engine=st0["engine"], ttft=st["ttft"],
                tok_s=n_tok / st["wall"],
                outputs=[r.output for r in reqs],
                tick_ms=st3["after_submit"] / st3["ticks"] * 1e3)
    return ok


def phase_quant(torch, rec, full, profile_dir=None):
    """Phase 5: the same 16 requests at full width, int8 KV pages alone,
    then int8 KV pages and int8 weights (quantized by the engine at load,
    on the card)."""
    import numpy as np

    from repro_torch.kernels import ops

    cfg, params, prompts = full["cfg"], full["params"], full["prompts"]
    ok = True

    kv8 = dict(full["run"], precision=dict(kv_cache_dtype="int8"))
    warm, st0 = warm_round(torch, "granite int8 kv", cfg, params, prompts,
                           kv8)
    kv8["eng"] = st0["engine"]
    ops.reset_launches()
    reqs, st = serve(torch, cfg, params, prompts, **kv8)
    launches = dict(ops.LAUNCHES)
    finished = all(r.state.value == "finished" and len(r.output) == 64
                   for r in reqs)
    first = [r.output[0] for r in reqs] == [o[0] for o in full["outputs"]]
    ok &= finished and first and launches["paged_decode_attention"] == 0 \
        and launches["paged_decode_attention_int8"] > 0
    print(f"int8 kv: {len(reqs)} requests finished with 64 tokens: "
          f"{finished}; first tokens equal phase 4's: {first}; "
          f"{sum(len(r.output) for r in reqs) / st['wall']:.1f} tok/s; "
          "launches: " + ", ".join(f"{k}={v}" for k, v in launches.items()),
          flush=True)
    ok &= graphs_ok("granite int8 kv", warm, st0)
    del kv8, st0, st
    gc.collect()

    both = dict(full["run"], precision=dict(kv_cache_dtype="int8",
                                            weight_dtype="int8"))
    warm, st0 = warm_round(torch, "granite int8 kv + int8 weights", cfg,
                           params, prompts, both)
    both["eng"] = st0["engine"]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    reqs, st = serve(torch, cfg, params, prompts, **both)
    launches = dict(ops.LAUNCHES)
    mem = memory(torch)
    same = all(a.output == b.output for a, b in zip(warm, reqs))
    ok &= same
    print(f"int8 measured round (replays) identical to the warm-up round: "
          f"{same}", flush=True)
    unfinished = [r.rid for r in reqs
                  if r.state.value != "finished" or len(r.output) != 64]
    if unfinished:
        ok = False
        print(f"FAIL: int8 requests without their 64 tokens: {unfinished}")
    for name in ("paged_decode_attention_int8", "int8_matmul",
                 "int8_matmul_prefill", "flash_attention", "sample_tokens"):
        if launches[name] <= 0:
            ok = False
            print(f"FAIL: kernel {name} never launched on the int8 path")
    for name in ("paged_decode_attention_int8", "int8_matmul",
                 "int8_matmul_prefill"):
        rec[name]["launches"] = launches[name]
    n_tok = sum(len(r.output) for r in reqs)
    greedy = [i for i in range(len(reqs)) if i % 2 == 0]
    agree = sum(reqs[i].output == full["outputs"][i] for i in greedy)
    print(f"int8 kv + int8 weights: {len(reqs)} requests, {n_tok} tokens "
          f"in {st['wall']:.3f}s -> {n_tok / st['wall']:.1f} tok/s, TTFT "
          f"p50 {statistics.median(st['ttft']) * 1e3:.1f} ms p90 "
          f"{np.percentile(st['ttft'], 90) * 1e3:.1f} ms, {mem} (the "
          f"script's bf16 weights included), resident engine weights "
          f"{st['weight_bytes'] / 2 ** 30:.2f} GiB; greedy streams equal "
          f"to phase 4's: {agree}/{len(greedy)}", flush=True)
    print("kernels (launches on the int8 path): "
          + ", ".join(f"{k}={v}" for k, v in launches.items())
          + "; sampler rows by path: "
          + ", ".join(f"{k}={v}" for k, v in ops.path_rows().items()),
          flush=True)
    reqs2, _ = serve(torch, cfg, params, prompts, **both)
    same = all(a.output == b.output for a, b in zip(reqs, reqs2))
    ok &= same
    print(f"int8 second run identical: {same}", flush=True)
    reqs3, st3 = serve(torch, cfg, params, prompts[:8], **both)
    dec_tok = sum(len(r.output) - 1 for r in reqs3)
    tick = st3["after_submit"] / st3["ticks"] * 1e3
    print(f"int8 decode at 8 slots: {dec_tok} tokens in "
          f"{st3['after_submit']:.3f}s -> "
          f"{dec_tok / st3['after_submit']:.1f} tok/s, {tick:.2f} ms per "
          f"tick ({st3['ticks']} ticks); phase 4 (bf16): "
          f"{full['tick_ms']:.2f} ms per tick", flush=True)
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        ops.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, st4 = serve(torch, cfg, params, prompts[:8], **both)
        write_profile(prof, profile_dir, st4, "decode_kernels_int8.txt")
    ok &= graphs_ok("granite int8 kv + int8 weights", warm, st0)
    return ok


def tick_while(log, kind):
    """(ms per decode tick of the logged steps that ran ``kind`` work,
    "chunks" or "prefills", beside decode ticks; how many such steps),
    and the ms per tick of the steps that ran decode ticks alone."""
    col = 1 if kind == "chunks" else 3
    busy = [(r[0], r[2]) for r in log if r[col] > 0 and r[2] > 0]
    alone = [(r[0], r[2]) for r in log if r[2] > 0 and not r[1] and not r[3]]

    def per_tick(rows):
        ticks = sum(n for _, n in rows)
        return sum(dt for dt, _ in rows) / ticks * 1e3 if ticks else 0.0
    return per_tick(busy), len(busy), per_tick(alone)


def burst_line(label, reqs, st):
    """TTFT p50 / p90 (host clock) and tokens/s of a served burst."""
    import numpy as np

    n_tok = sum(len(r.output) for r in reqs)
    return (f"{label}: TTFT p50 {statistics.median(st['ttft']) * 1e3:.1f} "
            f"ms p90 {np.percentile(st['ttft'], 90) * 1e3:.1f} ms, "
            f"{n_tok} tokens in {st['wall']:.3f}s -> "
            f"{n_tok / st['wall']:.1f} tok/s")


def phase_admission(torch, rec, full):
    """Phase 7: granite-8b at full width in bf16 on phase 4's weights,
    through the reference's remaining admission paths: (a) chunked prefill
    with its defaults (chunk 64, ``ChunkedPrefillPolicy()``), beside phase
    4's single-shot engine; (b) the prefix cache over two waves sharing a
    512-token prefix; (c) preemption in a pool of half the full headroom,
    with cancels and a timeout."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.serving import (
        EngineConfig,
        Request,
        RequestState,
        SamplingParams,
        ServingEngine,
    )

    cfg, params, prompts = full["cfg"], full["params"], full["prompts"]
    ok = True

    # -- (a) chunked prefill, the reference's defaults ---------------------
    chunked = dict(full["run"], chunk_prefill=64)
    warm, st0 = warm_round(torch, "granite bf16 chunked", cfg, params,
                           prompts, chunked)
    chunked["eng"] = st0["engine"]
    ops.reset_launches()
    log = []
    reqs, st = serve(torch, cfg, params, prompts, step_log=log, **chunked)
    launches = dict(ops.LAUNCHES)
    eng = st["engine"]
    n_chunks = eng.metrics.prefill_chunks
    unfinished = [r.rid for r in reqs
                  if r.state.value != "finished" or len(r.output) != 64]
    if unfinished:
        ok = False
        print(f"FAIL: chunked requests without their 64 tokens: "
              f"{unfinished}", flush=True)
    same = all(a.output == b.output for a, b in zip(warm, reqs))
    ok &= same
    rec["decode_attention_chunk"]["launches"] = launches["decode_attention"]
    for name in ("decode_attention", "flash_attention",
                 "paged_decode_attention", "sample_tokens"):
        if launches[name] <= 0:
            ok = False
            print(f"FAIL: kernel {name} never launched on the chunked path",
                  flush=True)
    tick, n_busy, alone = tick_while(log, "chunks")
    print(f"chunked measured round (replays) identical to the warm-up "
          f"round: {same}; prefill_chunks {n_chunks}; "
          + burst_line("chunked", reqs, st)
          + f"; {tick:.2f} ms per tick while chunks interleave ({n_busy} "
          f"steps), {alone:.2f} ms per tick of decode alone", flush=True)
    print("kernels (launches on the chunked path): "
          + ", ".join(f"{k}={v}" for k, v in launches.items()), flush=True)
    reqs2, _ = serve(torch, cfg, params, prompts, **chunked)
    same = all(a.output == b.output for a, b in zip(reqs, reqs2))
    ok &= same
    print(f"chunked second run identical: {same}", flush=True)
    ok &= graphs_ok("granite bf16 chunked", warm, st0)
    # phase 4's single-shot engine, timed the same way in this phase
    base = dict(full["run"], eng=full["engine"])
    log0 = []
    reqs0, st_b = serve(torch, cfg, params, prompts, step_log=log0, **base)
    tick0, n_busy0, alone0 = tick_while(log0, "prefills")
    print(burst_line("phase 4's single-shot engine, same timing", reqs0,
                     st_b)
          + f"; {tick0:.2f} ms per tick while single-shot prefills "
          f"interleave ({n_busy0} steps), {alone0:.2f} ms per tick of "
          f"decode alone; phase 4's measured round: TTFT p50 "
          f"{statistics.median(full['ttft']) * 1e3:.1f} ms p90 "
          f"{np.percentile(full['ttft'], 90) * 1e3:.1f} ms, "
          f"{full['tok_s']:.1f} tok/s", flush=True)
    del chunked["eng"], base, st0, st, eng, warm, reqs, reqs2, reqs0
    gc.collect()

    # -- (b) the prefix cache ------------------------------------------------
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, cfg.vocab_size, 512).astype(np.int32)
    sfx = rng.integers(16, 301, 16)
    waves = [[np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n)])
              .astype(np.int32) for n in sfx[w * 8:(w + 1) * 8]]
             for w in range(2)]
    pref = dict(full["run"], chunk_prefill=64, prefix_cache=True)

    def two_waves(eng=None):
        r1, s1 = serve(torch, cfg, params, waves[0], eng=eng, **pref)
        eng = s1["engine"]
        r2, s2 = serve(torch, cfg, params, waves[1], eng=eng, reset=False,
                       **pref)
        return eng, r1, s1, r2, s2

    eng, *_ = two_waves()
    captures = eng.graphs.captures
    print(f"prefix warm-up round: {captures} CUDA graphs captured in "
          f"{eng.graphs.capture_s:.2f}s (keys "
          + ", ".join(f"{name}{n}" for _, name, n in eng.graphs.keys) + ")",
          flush=True)
    eng, r1, s1, r2, s2 = two_waves(eng)
    hits = [r.prefix_hit_tokens for r in r2]
    cached = eng.prefix_index.cached_pages
    in_use = eng.allocator.pages_in_use
    finished = all(r.state.value == "finished" and len(r.output) == 64
                   for r in r1 + r2)
    good = (finished and all(h >= 512 for h in hits)
            and sum(hits) >= 8 * 512 and in_use == cached
            and eng.graphs.captures == captures
            and not [r.prefix_hit_tokens for r in r1 if r.prefix_hit_tokens])
    eng.clear_prefix_cache()
    eng.reset()
    good &= eng.allocator.pages_in_use == 0
    ok &= good
    print(f"prefix cache: wave 2 prefix-hit tokens {hits} (sum "
          f"{sum(hits)}, at least {8 * 512}), wave 1 misses; all finished "
          f"with 64 tokens: {finished}; pages in use {in_use} == cached "
          f"{cached}, 0 after clear_prefix_cache(); no capture after the "
          f"warm-up: {eng.graphs.captures == captures} "
          f"{'ok' if good else 'FAIL'}", flush=True)
    print(burst_line("prefix miss wave (8 prompts of 512 + 16-300)", r1, s1)
          + "; " + burst_line("hit wave", r2, s2), flush=True)
    del eng, r1, r2, s1, s2
    gc.collect()

    # -- (c) lifecycle: preemption, cancels and a timeout ----------------------
    max_pages = 1024 // 16
    eng = ServingEngine(cfg, params, EngineConfig(
        slots=8, max_seq=1024, pool_pages=8 * max_pages // 2 + 1,
        preemption=True, sync_every=1), device=full["run"]["device"])
    sp = SamplingParams(temperature=0.8, top_k=50, top_p=0.95, seed=5)
    base_reqs = [Request(rid=i, prompt=prompts[i], max_new_tokens=64,
                         sampling=sp if i % 2 else SamplingParams())
                 for i in range(8)]
    base_reqs[5].timeout_s = 30.0  # times out mid-decode (one tick a step)
    base_reqs[5].priority = 1  # never a victim: it must time out decoding
    cancel = base_reqs[6:8]
    urgent = [Request(rid=100 + j, prompt=rng.integers(
        0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=16,
        ttft_slo_s=5.0) for j, n in enumerate((420, 480, 350, 500))]
    allreq = base_reqs + urgent
    for i in (6, 7, 0, 1, 2, 3, 4, 5):
        eng.submit(base_reqs[i], 0.0)
    t, sent, cancel_at = 0.0, False, {}
    while not all(r.state.terminal for r in allreq) and t < 2000:
        t += 1.0
        eng.step(t)
        for r in cancel:
            if (r.rid not in cancel_at and r.state is RequestState.DECODE
                    and len(r.output) >= 2):
                r.cancel()
                cancel_at[r.rid] = len(r.output)
        if not sent and all(r.state.terminal for r in cancel):
            for r in urgent:
                r.arrival_time = t
                eng.submit(r, t)
            sent = True
    eng.drain(t)
    m = eng.metrics
    states = {r.rid: r.state.value for r in allreq}
    served = [r for r in allreq if r not in cancel and r is not
              base_reqs[5]]
    good = (m.preempted >= 1 and m.preempt_restores == m.preempted
            and all(r.state.value == "finished"
                    and len(r.output) == r.max_new_tokens for r in served)
            and all(r.state is RequestState.CANCELLED
                    and 0 < len(r.output) < 64 for r in cancel)
            and base_reqs[5].state is RequestState.TIMED_OUT
            and 0 < len(base_reqs[5].output) < 64
            and m.cancelled == 2 and m.timed_out == 1
            and eng.allocator.pages_in_use == 0 and eng.n_active == 0)
    ok &= good
    print(f"lifecycle (pool of {eng.allocator.capacity} pages, half the "
          f"headroom, preemption on, one tick a step): {t:.0f} steps; "
          f"preempted {m.preempted}, restored {m.preempt_restores}; "
          f"cancelled {m.cancelled} (after {list(cancel_at.values())} "
          f"tokens), timed out {m.timed_out} (after "
          f"{len(base_reqs[5].output)} tokens); states {states}; pages in "
          f"use at the end {eng.allocator.pages_in_use} "
          f"{'ok' if good else 'FAIL'}", flush=True)
    return ok


def phase_cluster(torch, rec, full):
    """Phase 8: the cluster frontend at full width in bf16 on phase 4's
    weights: two replicas from one parameter dict, rounds (a)-(d) on a
    virtual clock of one cost-model tick a step, and a wall-timed burst."""
    import numpy as np

    from repro_torch import serving as ts
    from repro_torch.kernels import ops
    from repro_torch.models import forward

    cfg, params = full["cfg"], full["params"]
    prompts = list(full["prompts"]) * 2  # two waves of phase 4's 16
    kernels = ("flash_attention", "paged_decode_attention", "sample_tokens",
               "decode_attention")
    ok = True
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    class Counted(ts.FaultyEngine):
        """A replica's proxy that counts the kernel launches of its own
        calls (``ops.LAUNCHES`` before and after), on top of the fault
        modes of ``FaultyEngine``."""

        _LOCAL = ts.FaultyEngine._LOCAL | {"launches"}

        def __init__(self, engine):
            super().__init__(engine)
            object.__setattr__(self, "launches", {})

        def _counted(self, fn, *args):
            before = dict(ops.LAUNCHES)
            try:
                return fn(*args)
            finally:
                for k, v in ops.LAUNCHES.items():
                    if v != before.get(k, 0):
                        self.launches[k] = (self.launches.get(k, 0) + v
                                            - before.get(k, 0))

        def step(self, now):
            return self._counted(super().step, now)

        def submit(self, req, now):
            return self._counted(super().submit, req, now)

        def drain(self, now):
            return self._counted(super().drain, now)

    def build(tracing):
        config = ts.EngineConfig(slots=8, max_seq=1024, tracing=tracing)
        e0 = ts.ServingEngine(cfg, params, config, device="cuda")
        return [e0, ts.ServingEngine(cfg, e0.params, config, device="cuda")]

    pair = build(True)
    shared = all(a is b for a, b in zip(_leaves(pair[0].params),
                                        _leaves(pair[1].params)))
    ok &= shared
    print(f"phase 8 replicas: replica 1 holds replica 0's weight tensors "
          f"(the bf16 weights and the float32 head): {shared}; "
          + memory(torch), flush=True)
    dt = pair[0].load_report().tick_est_s
    wave2, kill_t = 40 * dt, 60 * dt
    tier = {"gold": ts.TenantClass("gold", tier=1, weight=4.0),
            "bulk": ts.TenantClass("bulk", tier=0, weight=1.0,
                                   rate_tokens_s=2000.0, burst_tokens=2048.0)}

    def make_reqs(tenants=False):
        sp = lambda i: (ts.SamplingParams(temperature=0.8, top_k=50,  # noqa
                                          top_p=0.95, seed=1000 + i)
                        if i % 2 else ts.SamplingParams())
        return [ts.Request(rid=i, prompt=p, max_new_tokens=64,
                           arrival_time=0.0 if i < 16 else wave2,
                           tenant=(("gold", "bulk")[(i // 2) % 2]
                                   if tenants else ""), sampling=sp(i))
                for i, p in enumerate(prompts)]

    def drive(server, reqs, inj=None, on_step=None):
        """Chaos-bench style: faults due, arrivals due, one step per dt."""
        pending = sorted(reqs, key=lambda r: (r.arrival_time, r.rid))
        resolved, i, now = {}, 0, 0.0
        for _ in range(100_000):
            if inj is not None:
                inj.tick(now)
            while i < len(pending) and pending[i].arrival_time <= now:
                server.submit(pending[i], now)
                i += 1
            if on_step is not None:
                on_step()
            for r in server.step(now):
                resolved[r.rid] = r
            if len(resolved) >= len(reqs):
                break
            now += dt
        for r in server.drain(now):
            resolved[r.rid] = r
        return [resolved[r.rid] for r in reqs]

    def divergence(label, got, want):
        """Print each mismatching stream's first divergent token and the
        top-2 logit gap there; True when every stream matches."""
        good = True
        for r, w in zip(got, want):
            if r.output == w:
                continue
            good = False
            i = next((j for j, (x, y) in enumerate(zip(r.output, w))
                      if x != y), min(len(r.output), len(w)))
            gap = float("nan")
            if i < min(len(r.output), len(w)):
                toks = np.concatenate([r.prompt, np.asarray(w[:i], np.int32)])
                with torch.no_grad():
                    logits, _ = forward(cfg, params, torch.from_numpy(
                        toks).to("cuda")[None])
                top2 = torch.topk(logits[0, -1].float(), 2).values
                gap = float(top2[0] - top2[1])
            print(f"{label} rid={r.rid}: first divergent token #{i}: "
                  f"{r.output[i] if i < len(r.output) else None} vs "
                  f"{w[i] if i < len(w) else None}, top-2 logit gap "
                  f"{gap:.3g}", flush=True)
        return good

    # -- warm-up: each replica serves the 32 alone (every key captured) ----
    warm = []
    for k, eng in enumerate(pair):
        t0 = time.perf_counter()
        reqs = drive(eng, make_reqs())
        g = eng.graphs
        warm.append([r.output for r in reqs])
        print(f"phase 8 replica {k} warm-up round (32 requests alone): "
              f"{g.captures} CUDA graphs captured in {g.capture_s:.2f}s of "
              f"{time.perf_counter() - t0:.3f}s wall", flush=True)
    captures = [e.graphs.captures for e in pair]
    pair[0].reset()
    single = [r.output for r in drive(pair[0], make_reqs())]
    same = single == warm[0] == warm[1]
    ok &= same
    print(f"phase 8 one replica's streams (replays) equal both warm-up "
          f"rounds: {same}", flush=True)

    def cluster(engines, tracing=True, **kw):
        for e in engines:
            e.reset()
        proxies = [Counted(e) for e in engines]
        return proxies, ts.ClusterFrontend(proxies, policy="predicted",
                                           tracing=tracing, **kw)

    # -- (a) routing -------------------------------------------------------
    proxies, fe = cluster(pair)
    ops.reset_launches()
    reqs_a = drive(fe, make_reqs())
    out_a = [r.output for r in reqs_a]
    syncs_a = [e.metrics.host_syncs for e in pair]
    launches_a = [dict(p.launches) for p in proxies]
    finished = all(r.state.value == "finished" and len(r.output) == 64
                   for r in reqs_a)
    pages = [e.allocator.pages_in_use for e in pair]
    streams = divergence("phase 8 (a)", reqs_a, single)
    launched = all(sum(lc.get(k, 0) for lc in launches_a) > 0
                   for k in kernels)
    good = finished and pages == [0, 0] and streams and launched
    ok &= good
    for k, (inst, lc) in enumerate(zip(fe.instances, launches_a)):
        print(f"phase 8 (a) {inst.name}: routed {inst.routed}, utilization "
              f"{inst.utilization:.3f}, residual "
              f"{inst.corrector.correction:+.6f}, host syncs {syncs_a[k]}, "
              f"launches " + ", ".join(f"{n}={lc.get(n, 0)}"
                                       for n in kernels), flush=True)
    # one record per kernel: the launches of both replicas, each replica's
    # share in its name (a replica that drew no short prompt launches no
    # prefill attention); the times are the same kernel's at phase 2
    for n in kernels:
        base = "decode_attention_chunk" if n == "decode_attention" else n
        r = dict(rec[base])
        r["name"] = (f"{n} (phase 8 cluster, launches per replica "
                     + ", ".join(f"{i.name} {lc.get(n, 0)}" for i, lc
                                 in zip(fe.instances, launches_a))
                     + f"; times from {rec[base]['name']})")
        r["launches"] = sum(lc.get(n, 0) for lc in launches_a)
        rec[f"{n}_phase8"] = r
    print(f"phase 8 (a) 32 requests in two waves under predicted, tracing "
          f"on: all finished with 64 tokens: {finished}; pages in use "
          f"{pages}; streams == one replica's: {streams}; kernels "
          f"{list(kernels)} launched: {launched}; {memory(torch)} "
          f"{'ok' if good else 'FAIL'}", flush=True)
    doc = ts.chrome_trace(ts.request_traces(reqs_a))
    problems = ts.validate_chrome_trace(doc)

    def phases_in_order(r):
        kinds = [sp.kind for sp in r.trace.spans]
        try:
            return (kinds.index("queued") < kinds.index("prefill")
                    < kinds.index("decode"))
        except ValueError:
            return False

    spans_ok = all(phases_in_order(r) for r in reqs_a)
    totals = {}
    for e in pair:
        for kind, (c, sec) in e.tracer.span_totals.items():
            cur = totals.setdefault(kind, [0, 0.0])
            cur[0] += c
            cur[1] += sec

    # -- (b) kill replica 1 mid-decode ---------------------------------------
    proxies, fe = cluster(pair, max_retries=3)
    victim = fe.instances[1].name
    inj = ts.FaultInjector({victim: proxies[1]})
    inj.schedule(kill_t, victim, "kill")
    ledger = {}

    def watch():
        if not fe.failed:
            ledger["before"] = len(fe._outstanding.get(victim, {}))
    reqs_b = drive(fe, make_reqs(), inj=inj, on_step=watch)
    m = fe.merged_metrics()
    survivor = fe.instances[0].engine
    streams = divergence("phase 8 (b)", reqs_b, out_a)
    failed_over = [r for r in reqs_b if r.retries > 0]
    events = all("failover_retry" in r.trace.kinds()
                 and "dispatch" in r.trace.kinds() for r in failed_over)
    good = (streams and len(fe.failed) == 1
            and m.failed_over == ledger.get("before", -1) > 0
            and survivor.allocator.pages_in_use == 0
            and all(r.state.value == "finished" for r in reqs_b))
    ok &= good
    print(f"phase 8 (b) {victim} killed at virtual {kill_t * 1e3:.2f} ms "
          f"(mid-decode): failed {[i.name for i in fe.failed]}, "
          f"failed_over {m.failed_over} == its ledger "
          f"{ledger.get('before')}, retried {m.retried}; survivor pages in "
          f"use {survivor.allocator.pages_in_use}; streams == (a)'s: "
          f"{streams} {'ok' if good else 'FAIL'}", flush=True)

    # -- (c) tenants and overload control -------------------------------------
    det = ts.OverloadDetector(ttft_slo_s=100 * dt)
    proxies, fe = cluster(pair, tenants=tier, overload=det,
                          breaker=ts.CircuitBreaker())
    reqs_c = drive(fe, make_reqs(tenants=True))
    gold = [r for r in reqs_c if r.tenant == "gold"]
    bulk = [r for r in reqs_c if r.tenant == "bulk"]
    rejected = [r for r in bulk if r.fail_reason.startswith("rejected")]
    served = [r for r in reqs_c if r.state.value == "finished"]
    good = (all(r.state.value == "finished" and len(r.output) == 64
                for r in gold)
            and rejected
            and all(0 < r.retry_after_s < float("inf") for r in rejected)
            and all(r.output == out_a[r.rid][:len(r.output)]
                    and len(r.output) == r.max_new_tokens for r in served))
    ok &= good
    mt = fe.merged_metrics()
    print(f"phase 8 (c) tenants gold=1:4, bulk=0:1:2000:2048 (offered "
          f"{sum(r.prompt_len + 64 for r in bulk)} bulk tokens in two "
          f"waves {wave2 * 1e3:.2f} ms apart), detector and breaker armed: "
          + "; ".join(f"{n} admitted {t.admitted} completed {t.completed} "
                      f"rejected {t.rejected} shed {t.shed} browned_out "
                      f"{t.browned_out}" for n, t in sorted(
                          mt.tenants.items()))
          + f"; retry_after_s of the rejections "
          f"{sorted({round(r.retry_after_s, 4) for r in rejected})}; "
          f"ladder transitions {det.transitions}; admitted streams == "
          f"(a)'s {'ok' if good else 'FAIL'}", flush=True)

    # -- (d) tracing: (a)'s trace, and two replicas with tracing off ---------
    off = build(False)
    proxies, fe = cluster(off, tracing=False)
    drive(fe, make_reqs())
    captures_off = [e.graphs.captures for e in off]
    proxies, fe = cluster(off, tracing=False)
    reqs_d = drive(fe, make_reqs())
    launches_d = [dict(p.launches) for p in proxies]
    no_traces = all(r.trace is None for r in reqs_d)
    good = (problems == [] and spans_ok and events and no_traces
            and [r.output for r in reqs_d] == out_a
            and [e.metrics.host_syncs for e in off] == syncs_a
            and launches_d == launches_a
            and [e.graphs.captures for e in off] == captures_off
            and [e.graphs.captures for e in pair] == captures)
    ok &= good
    print(f"phase 8 (d) (a)'s Chrome trace: {len(doc['traceEvents'])} "
          f"events, validate_chrome_trace {problems}; queued -> prefill -> "
          f"decode in every trace: {spans_ok}; (b)'s {len(failed_over)} "
          f"failed-over requests hold failover_retry and dispatch: "
          f"{events}; tracing off: no trace objects {no_traces}, streams, "
          f"host syncs {[e.metrics.host_syncs for e in off]} and launches "
          f"== (a)'s, captures after the warm-up {captures_off} -> "
          f"{[e.graphs.captures for e in off]}, traced pair {captures} -> "
          f"{[e.graphs.captures for e in pair]} "
          f"{'ok' if good else 'FAIL'}", flush=True)
    print("phase 8 span totals by kind (both replicas, round (a), virtual "
          "seconds): " + ", ".join(f"{k} {c} / {s:.4f}s" for k, (c, s)
                                   in sorted(totals.items())), flush=True)
    del off, proxies, fe
    gc.collect()

    # -- a wall-timed burst: all 32 at once, host clock ---------------------
    proxies, fe = cluster(pair)
    reqs = make_reqs()
    ttft = {}
    t0 = time.perf_counter()
    for r in reqs:
        fe.submit(r, 0.0)
    done, steps = 0, 0
    while done < len(reqs):
        done += len(fe.step(time.perf_counter() - t0))
        steps += 1
        now = time.perf_counter() - t0
        for r in reqs:
            if r.output and r.rid not in ttft:
                ttft[r.rid] = now
    fe.drain(time.perf_counter() - t0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_tok = sum(len(r.output) for r in reqs)
    walls = ts.latency_histogram()
    for e in pair:
        walls.merge(e._tick_wall)
    tt = list(ttft.values())
    print(f"phase 8 wall-timed burst (32 requests at once, 2 replicas of 8 "
          f"slots, one host thread): {n_tok} tokens in {wall:.3f}s -> "
          f"{n_tok / wall:.1f} tok/s, TTFT p50 "
          f"{statistics.median(tt) * 1e3:.1f} ms p90 "
          f"{np.percentile(tt, 90) * 1e3:.1f} ms, {steps} cluster steps "
          f"({wall / steps * 1e3:.2f} ms each), step() wall p50 "
          f"{walls.percentile(50) * 1e3:.2f} ms p90 "
          f"{walls.percentile(90) * 1e3:.2f} ms per replica call; "
          + ", ".join(f"{i.name} routed {i.routed}" for i in fe.instances)
          + "; " + memory(torch), flush=True)

    ok &= graphs_ok("phase 8 replica 0", make_reqs(),
                    dict(engine=pair[0], captures=captures[0]))
    ok &= graphs_ok("phase 8 replica 1", make_reqs(),
                    dict(engine=pair[1], captures=captures[1]))
    return ok


def phase_profile_hook(torch):
    """Phase 8 (e), run last: once ``torch.profiler`` has traced the card,
    every later launch of the process costs more (a granite tick 9.67 ->
    10.15 ms on the H100), so the profiled round follows every timed
    phase. Two granite replicas from phase 4's seed, ``start_profile`` /
    ``stop_profile`` around a cluster round of phase 4's first 8 requests:
    the Chrome trace must land in the git-ignored ``_profile/phase8``.
    Replica 0's ms per decode tick serving phase 4's first 8 requests on
    its 8 slots (their chunks interleave) is printed before and after the
    session, not gated."""
    import shutil

    import numpy as np

    from repro_torch import serving as ts
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = get_config("granite-8b")
    params = init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in rng.integers(20, 601, 16)][:8]
    profile_dir = os.path.join(ROOT, "_profile", "phase8")
    shutil.rmtree(profile_dir, ignore_errors=True)
    config = ts.EngineConfig(slots=8, max_seq=1024, tracing=True,
                             profile_dir=profile_dir)
    e0 = ts.ServingEngine(cfg, params, config, device="cuda")
    pair = [e0, ts.ServingEngine(cfg, e0.params, config, device="cuda")]
    dt = e0.load_report().tick_est_s
    run = dict(device="cuda", max_new=64, slots=8, max_seq=1024, eng=e0)

    def tick_ms():
        _, st = serve(torch, cfg, params, prompts, **run)
        return st["after_submit"] / st["ticks"] * 1e3

    tick_ms()  # the warm-up: captures
    before = [tick_ms() for _ in range(3)]
    e0.reset()
    fe = ts.ClusterFrontend(pair, policy="predicted", tracing=True)
    reqs = [ts.Request(rid=i, prompt=p, max_new_tokens=64)
            for i, p in enumerate(prompts)]
    armed = [e.start_profile() for e in pair]
    for r in reqs:
        fe.submit(r, 0.0)
    t = 0.0
    while not all(r.done for r in reqs) and t < 10_000 * dt:
        t += dt
        fe.step(t)
    fe.drain(t)
    stopped = [e.stop_profile() for e in pair]
    events = [sp.kind for sp in pair[0].tracer.engine.spans
              if sp.kind.startswith("profile")]
    after = [tick_ms() for _ in range(3)]
    files = (sorted(os.listdir(profile_dir))
             if os.path.isdir(profile_dir) else [])
    size = sum(os.path.getsize(os.path.join(profile_dir, f)) for f in files)
    ok = (armed == [True, True] and stopped == [True, True] and size > 0
          and events == ["profile_start", "profile_stop"]
          and all(len(r.output) == 64 for r in reqs))
    print(f"phase 8 (e) torch.profiler around a cluster round of 8 "
          f"requests: {files} ({size} bytes) in "
          f"{os.path.relpath(profile_dir, ROOT)}, engine events {events} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    print("phase 8 (e) replica 0's ms per decode tick serving 8 requests "
          "on 8 slots, chunks interleaved, before the profiler session "
          + ", ".join(f"{t:.2f}" for t in before)
          + " ms, after it " + ", ".join(f"{t:.2f}" for t in after)
          + " ms", flush=True)
    return ok


def phase_hybrid(torch, rec, profile_dir=None):
    """Phase 6: recurrentgemma-9b at full width from rolling caches."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params

    cfg = get_config("recurrentgemma-9b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    n_par = sum(t.numel() for t in _leaves(params))
    print(f"full width recurrentgemma-9b: {n_par / 1e9:.3f} B params "
          f"({n_bytes / 1e9:.2f} GB) initialized in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    rng = np.random.default_rng(0)
    lens = list(rng.integers(20, 601, 16)) + [2500]
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    win = cfg.local_window
    run = dict(device="cuda", max_new=64, slots=8, max_seq=None, window=win,
               chunk_prefill=0)
    ok = True

    # the 2500-token prompt's rings, exactly: row t % W holds token t
    placed, errs = ring_check(torch, cfg, params, prompts[-1], ticks=(1,))
    ok &= placed
    print(f"bf16 ring after the {len(prompts[-1])}-token prompt: rows "
          f"t % {win} hold the last {win} tokens' K/V exactly: {placed} "
          f"{'ok' if placed else 'FAIL'}; first decode logits vs the full "
          f"forward over prompt + 1 token (printed, not a gate: bf16 "
          f"rounding through 38 layers): max_abs_err={errs[1][0]:.4g}, "
          f"with the rings placed as the reference places them "
          f"{errs[1][1]:.4g}; max|logit| {errs[1][2]:.3g}", flush=True)

    warm, st0 = warm_round(torch, "recurrentgemma bf16", cfg, params,
                           prompts, run)
    run["eng"] = st0["engine"]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    reqs, st = serve(torch, cfg, params, prompts, **run)
    launches = dict(ops.LAUNCHES)
    mem = memory(torch)
    unfinished = [r.rid for r in reqs
                  if r.state.value != "finished" or len(r.output) != 64]
    if unfinished:
        ok = False
        print(f"FAIL: requests without their 64 tokens: {unfinished}")
    same = all(a.output == b.output for a, b in zip(warm, reqs))
    ok &= same
    print(f"hybrid measured round (replays) identical to the warm-up round: "
          f"{same}", flush=True)
    for key, name in (("flash_attention_local", "flash_attention"),
                      ("decode_attention", "decode_attention"),
                      ("rglru_scan", "rglru_scan"),
                      ("sample_tokens_v256k", "sample_tokens")):
        rec[key]["launches"] = launches[name]
        if launches[name] <= 0:
            ok = False
            print(f"FAIL: kernel {name} never launched on the hybrid path")
    n_tok = sum(len(r.output) for r in reqs)
    print(f"recurrentgemma-9b: {len(reqs)} requests on 8 slots (prompts "
          f"{min(lens)}-{max(lens)} tokens, 64 new, half seeded), {n_tok} "
          f"tokens in {st['wall']:.3f}s -> {n_tok / st['wall']:.1f} tok/s, "
          f"TTFT p50 {statistics.median(st['ttft']) * 1e3:.1f} ms p90 "
          f"{np.percentile(st['ttft'], 90) * 1e3:.1f} ms, {mem}, engine "
          f"weights "
          f"{st['weight_bytes'] / 2 ** 30:.2f} GiB (the float32 head copy "
          f"included)", flush=True)
    print("kernels (launches on the hybrid path): "
          + ", ".join(f"{k}={v}" for k, v in launches.items())
          + "; sampler rows by path: "
          + ", ".join(f"{k}={v}" for k, v in ops.path_rows().items()),
          flush=True)
    reqs2, _ = serve(torch, cfg, params, prompts, **run)
    same = all(a.output == b.output for a, b in zip(reqs, reqs2))
    ok &= same
    print(f"hybrid second run identical: {same}", flush=True)
    reqs3, st3 = serve(torch, cfg, params, prompts[:8], **run)
    dec_tok = sum(len(r.output) - 1 for r in reqs3)
    tick = st3["after_submit"] / st3["ticks"] * 1e3
    floor_ms = st["weight_bytes"] / HBM_BW * 1e3
    print(f"hybrid decode at 8 slots: {dec_tok} tokens in "
          f"{st3['after_submit']:.3f}s -> "
          f"{dec_tok / st3['after_submit']:.1f} tok/s, {tick:.2f} ms per "
          f"tick ({st3['ticks']} ticks); floor {floor_ms:.2f} ms (the "
          f"engine's weight bytes, the float32 head included, at 3.35 TB/s)",
          flush=True)
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        ops.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, st4 = serve(torch, cfg, params, prompts[:8], **run)
        write_profile(prof, profile_dir, st4, "decode_kernels_hybrid.txt")
        # the 2500-token prompt alone: its exact-length prefill and one tick
        ops.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, st5 = serve(torch, cfg, params, prompts[-1:],
                           **dict(run, max_new=2))
        write_profile(prof, profile_dir, st5, "prefill_2500_hybrid.txt",
                      label=f"{len(prompts[-1])}-token prefill + 1 tick")
    ok &= graphs_ok("recurrentgemma bf16", warm, st0)

    # the decode path against the full forward, end to end, in float32
    # (the same architecture at full width, 38 layers, weights from the
    # same seed): after 1 and 16 decode ticks past the 2500-token prompt
    del params, reqs, reqs2, reqs3, run, st, st0, st3
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = init_params(cfg32, seed=0, device="cuda")
    placed, errs = ring_check(torch, cfg32, params, prompts[-1],
                              ticks=(1, 16))
    good = placed
    for t, (err, err_ref, scale) in errs.items():
        tol = F32_DECODE_TOL * scale
        good &= err <= tol
        print(f"float32 decode tick {t} after the {len(prompts[-1])}-token "
              f"prompt vs the full forward: max_abs_err={err:.4g} "
              f"tol={tol:.4g} ({F32_DECODE_TOL} x max|logit| {scale:.3g}); "
              f"with the rings placed as the reference places them "
              f"{err_ref:.4g}", flush=True)
    print(f"float32 rings placed exactly: {placed}; decode vs forward "
          f"{'ok' if good else 'FAIL'}", flush=True)
    ok &= good
    del params
    return ok


def ring_check(torch, cfg, params, prompt, ticks):
    """Prefill ``prompt`` into fresh rolling caches and check every local
    attention ring exactly: row t % W holds token t's K/V for the last W
    tokens. Then decode greedily and, at each tick in ``ticks``, compare
    the logits with the full forward over the prompt and the decoded
    tokens; the same decode over a copy of the rings rolled to the
    reference's placement (the last W tokens at rows 0..W-1) shows what
    that placement would change. Returns (placed, {tick: (max abs error,
    its error with the reference's placement, max |logit|)})."""
    from repro_torch.models import (
        decode_step,
        forward,
        init_cache,
        layer_types,
    )

    win = cfg.local_window
    toks = torch.from_numpy(prompt).to("cuda")[None]
    n = toks.shape[1]
    cache = init_cache(cfg, 1, win, device="cuda")
    at = torch.full((1,), n - 1, dtype=torch.int64, device="cuda")
    last, kv = forward(cfg, params, toks, logits_at=at, want_kv=True,
                       cache=cache)
    attn = [i for i, bt in enumerate(layer_types(cfg)) if bt == "local_attn"]
    rows = torch.arange(n - win, n, device="cuda") % win
    placed = all(torch.equal(cache["layers"][i][name][0, rows],
                             kv[i][j][0, n - win:])
                 for i in attn for j, name in enumerate(("k", "v")))
    del kv
    ref_cache = {"layers": [{k: (torch.roll(v, -((n - win) % win), 1)
                                 if k in ("k", "v") else v.clone())
                             for k, v in c.items()}
                            for c in cache["layers"]],
                 "pos": cache["pos"].clone()}
    seq = toks
    nxt = torch.argmax(last, dim=-1)[:, None]
    errs = {}
    for t in range(1, max(ticks) + 1):
        seq = torch.cat([seq, nxt], 1)
        dec = decode_step(cfg, params, cache, nxt)[:, 0]
        dec_ref = decode_step(cfg, params, ref_cache, nxt)[:, 0]
        if t in ticks:
            at = torch.full((1,), seq.shape[1] - 1, dtype=torch.int64,
                            device="cuda")
            want, _ = forward(cfg, params, seq, logits_at=at)
            errs[t] = ((dec - want).abs().max().item(),
                       (dec_ref - want).abs().max().item(),
                       max(1.0, want.abs().max().item()))
        nxt = torch.argmax(dec, dim=-1)[:, None]
    return placed, errs


def write_profile(prof, out_dir, st, table_name,
                  label="decode at 8 slots"):
    """Device time by kernel name, and the device's busy share of the
    profiled serve (its whole run and its decode part), from
    ``torch.profiler``; the table goes to ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    events = prof.key_averages()
    table = events.table(sort_by="self_cuda_time_total", row_limit=40)
    with open(os.path.join(out_dir, table_name), "w") as f:
        f.write(table)
    # kernels only: an operator's row repeats the time of the kernels it
    # launched, which have rows of their own
    from torch.autograd import DeviceType

    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA)
    tick_ms = st["after_submit"] / st["ticks"] * 1e3
    from repro_torch.kernels import ops

    print(f"profiled {label}: {tick_ms:.2f} ms per tick; device "
          f"busy {dev_us / 1e6:.3f}s of {st['wall']:.3f}s wall "
          f"({100 * dev_us / 1e6 / st['wall']:.1f}%); table in "
          f"{out_dir}/{table_name}; kernel launches: "
          + ", ".join(f"{k}={v}" for k, v in ops.LAUNCHES.items() if v)
          + "; sampler rows by path: "
          + ", ".join(f"{k}={v}" for k, v in ops.path_rows().items()),
          flush=True)
    # the two kernels this slice rebuilt, by their kernels' names
    for label_k, key in (("RG-LRU scan", "scan_kernel"),
                         ("sampler", "sample_tokens_kernel")):
        hits = [e for e in events if e.device_type == DeviceType.CUDA
                and key in e.key]
        us = sum(e.self_device_time_total for e in hits)
        calls = sum(e.count for e in hits)
        print(f"  {label_k}: {us / 1e3:.3f} ms of device time in {calls} "
              f"launches ({us / max(calls, 1):.2f} us a launch)", flush=True)
    for line in table.splitlines()[:18]:
        print(line, flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"no src/repro_torch beside {__file__}: run chip_smoke.py "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    profile_dir = None
    if len(sys.argv) == 3 and sys.argv[1] == "--profile":
        profile_dir = sys.argv[2]
    elif len(sys.argv) != 1:
        print("usage: python3 chip_smoke.py [--profile DIR]",
              file=sys.stderr)
        return 2

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    from repro_torch.kernels import build

    lib = build.load(verbose=True)
    print(f"kernels built and loaded in {lib.build_s:.1f}s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    csrc = "src/repro_torch/kernels/csrc"
    rec = {
        "flash_attention": dict(
            name="flash_attention", route="cuda",
            source=f"{csrc}/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:74"),
        "paged_decode_attention": dict(
            name="paged_decode_attention", route="cuda",
            source=f"{csrc}/paged_decode_attention.cu",
            replaces="src/repro/kernels/decode_attention.py:167"),
        "sample_tokens": dict(
            name="sample_tokens", route="cuda",
            source=f"{csrc}/sampling.cu",
            replaces="src/repro/kernels/topk_sample.py:63"),
        "paged_decode_attention_int8": dict(
            name="paged_decode_attention_int8", route="cuda",
            source=f"{csrc}/paged_decode_attention_int8.cu",
            replaces="src/repro/kernels/decode_attention.py:216"),
        "int8_matmul": dict(
            name="int8_matmul", route="cuda",
            source=f"{csrc}/int8_matmul.cu",
            replaces="src/repro/kernels/int8_matmul.py:38"),
        "decode_attention": dict(
            name="decode_attention", route="cuda",
            source=f"{csrc}/decode_attention.cu",
            replaces="src/repro/kernels/decode_attention.py:264"),
        "decode_attention_chunk": dict(
            name="decode_attention (chunk S 64, 32/8 heads, (1, 1024) "
                 "buffer)", route="cuda",
            source=f"{csrc}/decode_attention.cu",
            replaces="src/repro/kernels/decode_attention.py:264"),
        "rglru_scan": dict(
            name="rglru_scan", route="cuda",
            source=f"{csrc}/rglru_scan.cu",
            replaces="src/repro/kernels/rglru_scan.py:48"),
        "flash_attention_s2048": dict(
            name="flash_attention (S 2048)", route="cuda",
            source=f"{csrc}/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:74"),
        "int8_matmul_prefill": dict(
            name="int8_matmul (prefill, M 512, 14336x4096)", route="cuda",
            source=f"{csrc}/int8_matmul.cu",
            replaces="src/repro/kernels/int8_matmul.py:38"),
        "flash_attention_local": dict(
            name="flash_attention (window 2048, head_dim 256)", route="cuda",
            source=f"{csrc}/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:74"),
        "sample_tokens_v256k": dict(
            name="sample_tokens (vocab 256000)", route="cuda",
            source=f"{csrc}/sampling.cu",
            replaces="src/repro/kernels/topk_sample.py:63"),
    }
    full = {}
    for phase, fn in (("kernels vs plain", lambda: phase_kernels(torch,
                                                                 rec)),
                      ("reduced streams cuda == cpu",
                       lambda: phase_reduced(torch)),
                      ("full-width serving",
                       lambda: phase_full(torch, rec, full, profile_dir)),
                      ("full-width quantized serving",
                       lambda: phase_quant(torch, rec, full, profile_dir)),
                      ("full-width admission paths",
                       lambda: phase_admission(torch, rec, full)),
                      ("full-width cluster frontend",
                       lambda: phase_cluster(torch, rec, full)),
                      ("full-width hybrid serving",
                       lambda: phase_hybrid(torch, rec, profile_dir)),
                      ("full-width profiler hook",
                       lambda: phase_profile_hook(torch))):
        t0 = time.perf_counter()
        if not fn():
            return fail(f"phase '{phase}'")
        print(f"phase '{phase}' ok in {time.perf_counter() - t0:.1f}s",
              flush=True)
        if phase == "full-width cluster frontend":
            full.clear()  # granite's weights go before recurrentgemma's
            gc.collect()
            torch.cuda.empty_cache()
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(card, flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in rec.values()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
