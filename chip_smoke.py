#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order (phases 7 and 8 run after phase 5, on granite's
weights, before phase 6; phases 9, 10 and 11 after phase 6; phase 15
after phase 13, on its tables, and phase 14 after phase 15; phase 15
(e)'s cells run at the end of phases 6 and 10, on their weights; phase
8's profiled round (e) runs last); any failure exits non-zero:

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
   its time and bound; and at phase 12's ``serve_step`` shape (8 rings of
   1024 at the static batch's positions, S 1), the same way; bf16
   prefill attention also at phase 12's exact prompt lengths (S 514 and
   121, off the tile, 32/8 heads). bf16 paged decode over model-dtype
   and int8 pools (the one-launch twin-order kernel) also prints its
   error in units of 2^-8 sum p|v| and must repeat bit for bit; over bf16
   pools it is also timed at granite-8b's served docqa pools (32 slots of
   2000-3299 rows in pools of 4096, S 1), where it must equal its plain
   version bit for bit, with the twin-order blocks an SM holds. Then recurrentgemma-9b's
   shapes: windowed prefill attention (S 2560, 16 q heads over 1 kv head,
   head_dim 256, window 2048), rolling-cache decode attention (8 rings of
   2048, S 1 and 4, rings partly filled to wrapped; bf16 on the one-pass
   kernel, also in units of 2^-8 sum p|v| and repeated bit for bit, and
   float32 on the three-launch one), the RG-LRU scan (L 4096, bit for
   bit) and the sampler at vocab 256000. The int8 matmul's bf16 decode
   tile is timed at M 8, 16 and 32. The sampler is timed at both
   vocabularies under two mixes (phase 2's, and the bursts': 4 greedy
   rows, 4 at T 0.8, top-k 50, top-p 0.95), with the rows each of its
   paths served. Then the shapes of phases 9 and 10 (head_dim 128):
   prefill attention at S 512 over 40/10, 48/4 and 32/2 heads; paged
   decode (float32 and bf16) at S 1 and 4 there, int8 paged decode (bf16,
   page scales) at 48/4 (G 12) and 32/2 (G 16); the chunk step's rolling
   decode at S 64 over a (1, 1024) buffer (G x 64 = 256, 768 and 1024
   rows); the sampler at vocab 100352, 49152, 65024 and 50280 (ragged
   last block) under both mixes; the int8 matmul (bf16) at M 8 and 64
   over phi3's, starcoder2's and chatglm3's projections. Then the shapes
   of phase 11 (head_dim 128): prefill attention at S 512 over 48/8, 40/8
   and 28/4 heads (G 6, 5, 7); paged decode (float32 and bf16) at S 1
   and 4 there (G x S = 6 to 28 rows), int8 paged decode (bf16, page
   scales) at grok's G 6; the chunk step's rolling decode at S 64 over a
   (1, 1024) buffer (384, 320 and 448 rows); the sampler at vocab
   131072, 202048 and 152064 under both mixes, a tie in the last block.
   Last, the training path's shapes, each from a generator of its own
   (every earlier check keeps its inputs): prefill attention at
   hubert-xlarge's head_dim 80, non-causal (B 1, S 4096 and 4095 off the
   tile, 16/16 heads, bf16 and float32; B 4, S 4096 in bf16, phase 14's
   shape) and at granite's causal train shape (B 2, S 4096, 32/8, bf16),
   each with its error (bf16 also in units of 2^-8 sum p|v|), time,
   bound, plain and SDPA time; the autograd ``Function``s' q, k, v
   gradients against the plain version's autograd at hubert's shape
   (bf16 and float32) and granite's (bf16), with the backward's time;
   the RG-LRU ``Function``'s a, x, h0 gradients at L 4096 (B 2, S 384).
   Then, on a generator of their own (torch seed 26), phase 15 (d) and
   (e)'s per-shard shapes, at the lengths the cells serve (phase 4's
   prompts, the longest 584 tokens): windowed prefill attention at
   recurrentgemma's tp 2 (S 584, 8/1 heads of 256, window 2048, which no
   key of the burst falls outside), rolling-cache decode over 8 rings of
   2048 (tp 2) and a data row's 4 (dp 2 x tp 2) at 8/1 heads, slot b at
   its prompt's length plus 16, the RG-LRU scan at a tp-2 channel block
   (S 584, L 2048, bit for bit),
   paged decode over a data row's 4 slots at granite's 32/8 (dp 2) and
   16/4 heads a shard (dp 2 x tp 2), and the sampler over two rows'
   concatenated logits (B 8, V 49152), each against its plain version
   with its time, bound and library time.
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
   killed mid-decode (its ledger replayed on the survivor); then
   phi3-medium-14b, starcoder2-15b (also at 12/1 heads), chatglm3-6b
   (also at 16/1 heads, in float32 and with int8 KV pages),
   mamba2-1.3b, grok-1-314b at 12/2 heads (G 6) with a capacity factor of
   1.0 that drops tokens ("drop", also chunked, and "strict"),
   llama4-maverick-400b-a17b at 10/2 heads (G 5) and qwen2-vl-7b at 14/2
   heads (G 7, mrope) ``reduced()``, and phase 15 (e)'s sharded hybrids
   as a grid stacked on the card against the same grid on the CPU
   (recurrentgemma at dp 2 x tp 2 on 4 slots, mamba2 at tp 2); the
   streams must be token-identical (on
   the card, through the engine's CUDA graphs), and the cluster's must
   equal one engine's. Last, phase 12's module-level steps on reduced
   granite (``prefill_step`` into a 3-slot rolling cache, 12
   ``serve_step`` ticks, ``bucketed_prefill_step``, ``generate`` greedy
   and seeded), card == CPU token for token.
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

9. After phase 6: phi3-medium-14b, starcoder2-15b and chatglm3-6b at
   full width and depth (40, 40 and 28 layers; bf16, random weights from
   seed 0), one after the other, each freed before the next, on the
   default path (paged KV pages of 16, chunk 64, max_seq 1024): phase
   4's 16 prompts, 64 new tokens, half seeded, 8 slots; chatglm3 also
   with int8 KV pages. Each engine pays its captures in a warm-up round;
   then ``reset()`` and a timed round (launch counts zeroed just before,
   read just after), a rerun and the steady decode of 8 requests. Gates:
   every request finishes with its budget, the streams repeat, prefill
   attention, paged decode (int8 on the int8 round), the chunk step's
   rolling decode and the sampler launched, no capture after the
   warm-up. Prints TTFT p50 / p90, tok/s, peak memory, launches per
   kernel, ms per decode tick at 8 slots beside the weight-read floor.
10. mamba2-1.3b at full width and depth (48 layers, d 2048, d_inner
   4096, 64 heads of 64, state 128, chunk 256; bf16, tied head): first
   the SSD decode step's kernel at B 8 (this phase's slots) and B 64
   (the benchmark cell's), bf16 lanes strided as the mixer passes them,
   against its plain version (state within 2e-5, y within bf16's 2e-2),
   in place, timed beside its byte bound and the plain version; then
   from rolling caches (exact-length prefill, captured decode), phase
   4's prompts on 8 slots, with phase 9's prints and gates (the sampler
   and the SSD step launched); then in float32 at full width, decode logits 1 and 16
   ticks after the 584-token prompt (chunks of 256, 256 and 72) against
   the full forward, within 1e-3 of the largest logit. Before mamba2,
   the grouped MoE expert kernel at granite-4.0-h-small's widths (E 72,
   top 10, d 4096, ff 768) over 512, 691 (96 rows an expert, where the
   row tile switches from 64 to 128), 1544 and 3072-token prefills,
   against its per-expert loop in units of 2^-8 sum |h w_down|, timed
   beside its byte bound, the loop and its own time at the other row
   tile, two launches a call; then
   granite-4.0-h-small at full width cut to 20 layers, served under the
   "strict" policy from rolling caches with phase 9's rounds, prints and
   gates, the grouped kernel launched exactly twice a MoE layer for each
   exact-length prefill of the timed round.
11. The MoE block family and mrope at full width in bf16 (random weights
   from seed 0), each freed before the next, on the default path (paged
   KV pages of 16, chunk 64, max_seq 1024, capacity policy "drop"):
   grok-1-314b cut to 4 of its 64 layers (all 8 experts of width 32768,
   top-2, 48/8 heads, vocab 131072), llama4-maverick-400b-a17b cut to 2
   of 48 (one dense layer of 16384, one MoE layer of all 128 experts,
   top-1, and the shared expert; 40/8 heads, vocab 202048) and
   qwen2-vl-7b whole (28 layers, 28/4 heads, mrope sections (16, 24,
   24), vocab 152064); phase 4's 16 prompts, 64 new tokens, half seeded,
   8 slots, with phase 9's rounds, prints and gates, on phase 8's virtual
   clock (one cost-model tick a step: a binding capacity makes a stream
   depend on the tokens routed beside it, so admissions must fall at the
   same steps in every round); grok also under the "strict" capacity
   policy and with int8 KV pages (the int8 paged decode launched). Prints each weight-read floor per tick (every expert is
   read each tick, as in the reference's products; llama4 also the floor
   of its 8 routed experts).
12. After phase 8, on phase 4's granite-8b weights in bf16, uncut: the
   engine's module-level steps outside the engine. A static batch (phase
   4's first 8 prompts through ``prefill_step``, rings of 1024, and
   ``cache_insert``, then 64 ``serve_step`` ticks at 8 slots; prefill
   attention and rolling decode must launch), ``bucketed_prefill_step`` at
   buckets 128 and 512 (first token equal to ``prefill_step``'s argmax,
   logit gap printed) and ``generate`` on phase 4's greedy prompt 2 (64
   tokens, repeated on a second call; agreement with phase 4's stream
   printed, not gated). Prints ms per ``serve_step`` at 8 slots (eager,
   ``util.timeit`` on CUDA events) and its tok/s beside phase 4's
   captured tick, and ms per ``prefill_step`` at S 512.
13. After phase 11: DLRM at the reference's widths (26 tables of embed
   128, MLPs (512, 256, 128) and (1024, 1024, 512, 256, 1), multi-hot 8,
   float32) with its tables cut from 10M to 4M rows (133.1 -> 53.2 GB):
   a batch of 128 within 1e-4 relative of float64 from its gathered rows;
   ms per batch at B 128 and 2048, queries/s, lookup bytes and their
   time at 3.35 TB/s, peak memory, and ``plan_offload`` for the uncut
   tables.

14. After phase 15, training (``repro_torch.training.train_step``,
   AdamW with float32 master weights; every layer recomputed in
   backward, kernels 1 and 7 through their autograd ``Function``s). (a)
   Two float32 steps of granite-8b, hubert-xlarge (also at 4 heads of
   80) and recurrentgemma-9b (3 layers: both kernels) ``reduced()``,
   card == CPU within 1e-4 (loss, grad norm, params), kernel launches 2
   a layer a step; chatglm3-6b ``reduced()``'s loss falls over 30 steps
   on the card (the reference suite's test). (b) hubert-xlarge whole (48
   layers, bf16 weights) on B 4 x S 4096 frames from ``synthetic_batch``
   at ``train_4k``'s sequence (its batch cut from 256 to 4 to fit one
   card), 8 steps; (c) granite-8b at full width, 2 of its 36 layers (the
   whole needs ~115 GB of weights and AdamW state), B 2 x S 4096 from
   ``TokenPipeline``, 8 steps. Gates for (b) and (c): finite losses and
   grad norms; every parameter's gradient nonzero somewhere; kernel 1
   launched exactly 2 x layers a step; step 0's loss within 1e-2 and
   grad norm within 5e-2 (relative) of the same step with attention in
   plain float32 (the kernel rounds P to bf16, 2^-8, over 48 layers).
   Prints ms a step (CUDA events), tokens/s, MFU (6 N T over 989 TF/s)
   and peak memory.

15. After phase 13, sharded serving: one replica over tp shards
   (``DeviceTopology(tp=N)``), shard j on ``cuda:{j % device_count}``
   (every shard on cuda:0 on a one-card host; a line prints the grid).
   (a) The column-block probe (torch seed 15): granite's seven
   projections (bf16, the column block read in place) and its lm head
   (float32) at M 1, 8 and 64, and llama4's expert products (16 experts,
   bf16) at M 8 and 64, each block at tp 2 and 4 against the same block
   of the whole product, bit for bit; where any block differs the
   streams below are gated by the bf16 tolerance instead of equality. (b)
   Phase 13's tables row-split over 2 shards (views, nothing copied): B
   128 through ``dlrm_forward`` against one table's pooled sums within
   1e-5 of the largest logit (the partial sums add in another order); ms
   a batch at B 128 and 2048 beside one table (numpy seed 1315). (c)
   granite-8b at full width in bf16 at tp 2 and 4, and at tp 4 over int8
   KV pages; llama4-maverick cut to 2 of 48 layers at tp 4, expert
   parallel, "strict" pinned on it and on its one-card engine; chatglm3-6b
   at tp 4 (pools split on head_dim); each on the default path (pages of
   16, chunk 64, max_seq 1024), phase 4's 16 prompts, 32 new tokens,
   half seeded, 8 slots, after the same arch's one-card engine (served
   first, then freed). Gates: streams equal to the one-card engine's
   (or, where the probe found blocks that differ, every greedy stream's
   first divergence at a near-tie: the one-card top-2 gap within 2e-2 of
   the largest logit; seeded divergences printed), the trace probes
   equal to the one-card engine's, a measured round after ``reset()``
   that repeats the warm-up round's streams with no capture (shards on
   one card; over several cards every step runs eagerly), every request
   finished and every page back, ``load_report()``'s axis fields, and
   the path's kernels launched in the measured round. Prints TTFT p50 /
   p90, burst tok/s, peak memory per device and ms per decode tick at 8
   slots, each beside the one-card engine's (a warm-up round, then a
   measured one). (d) The data axis: granite-8b at dp 2 and at dp 2 x
   tp 2 (each data row decodes 4 of the 8 slots; the rows of a model
   shard share its pools), on (c)'s path beside (c)'s one-card engine.
   (e) At the end of phase 6, on its weights: recurrentgemma-9b whole
   (38 layers) from rolling caches (rings of 2048, exact-length prefill)
   at tp 2 (its RG-LRU column blocks scanned on each shard, its one kv
   head's ring whole) and at dp 2 x tp 2 (rings and states split by slot
   over the rows); at the end of phase 10: mamba2-1.3b whole at tp 2
   (in_proj's column blocks); each beside a one-card engine of the same
   run (phase 4's prompts, 32 new, half seeded, 8 slots). (d) and (e)
   keep (c)'s gates, print the same numbers and each sub-phase's
   seconds; their kernels' measured launches go into the per-shard
   records that phase 2 checked.

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


def prefill_kernel(torch, gen, H, KVH, D, s, dt_name):
    """Prefill attention (causal) at S tokens of H q heads over KVH kv
    heads against its plain version and ``ref.ref_attention``; bf16 also
    in units of 2^-8 sum p|v|. Prints the line; returns (ok, the row's
    numbers)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers as L

    dev = "cuda"
    dt = getattr(torch, dt_name)
    q = torch.randn((1, s, H, D), generator=gen, device=dev).to(dt)
    k = torch.randn((1, s, KVH, D), generator=gen, device=dev).to(dt)
    v = torch.randn((1, s, KVH, D), generator=gen, device=dev).to(dt)
    got = ops.flash_attention(q, k, v, causal=True)
    want = L.dense_attention(q, k, v, causal=True)
    oracle = ref.ref_attention(
        q.transpose(1, 2).reshape(H, s, D),
        k.repeat_interleave(H // KVH, 2).transpose(1, 2).reshape(H, s, D),
        v.repeat_interleave(H // KVH, 2).transpose(1, 2).reshape(H, s, D)
    ).reshape(1, H, s, D).transpose(1, 2)
    err = (got.float() - want.float()).abs().max().item()
    err_ref = (got.float() - oracle.float()).abs().max().item()
    tol = TOL[dt_name]
    good = err <= tol and err_ref <= tol
    units = ""
    if dt_name == "bfloat16":
        u, u_ref = (bf16_units(got, x, q, k, v) for x in (want, oracle))
        good &= max(u, u_ref) <= BF16_UNITS_TOL
        units = (f" scaled {u:.3g} (vs ref {u_ref:.3g}) units of "
                 f"2^-8 sum p|v| tol={BF16_UNITS_TOL:g}")
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
    print(f"prefill {dt_name} S={s} H={H}/{KVH} D={D}: max_abs_err="
          f"{err:.3g} (vs ref.ref_attention {err_ref:.3g}) tol={tol}{units} "
          f"{'ok' if good else 'FAIL'} ms={ms:.4f} "
          f"({tflops(flops, ms)}) plain_ms={plain:.4f} "
          f"({tflops(flops, plain)}) sdpa_ms={lib:.4f} "
          f"({tflops(flops, lib)}) bound_ms={b_ms:.5f} ({b_by})",
          flush=True)
    return good, dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                      bound_by=b_by, library_ms=lib)


def paged_decode_kernel(torch, rec, gen, H, KVH, D, s_list, rec_key, B=8):
    """Paged decode attention over model-dtype pools (B slots of 1-1024
    tokens, 8 by default, pages of 16, a released slot on the trash page)
    against its plain version and the oracle, float32 and bf16 (bf16 also
    in units of 2^-8 sum p|v| and bit for bit on a repeat call), timed at
    S 1 and 4; ``rec[rec_key]`` takes the bf16 S 1 row."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers as L

    dev = "cuda"
    ps, n_pages = 16, 64
    P = B * n_pages + 1
    # partial and full pages
    ctx = [1, 15, 16, 17, 200, 513, 1000, 1024][8 - B:]
    ok = True
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
        for s in s_list:
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
                line = (f"paged decode {dt_name} S={s} H={H}/{KVH} D={D} "
                        f"{name}: max_abs_err={err:.3g} (vs ref "
                        f"{err_ref:.3g}) tol={tol}{units} "
                        f"{'ok' if good else 'FAIL'}")
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
                        rec[rec_key].update(
                            max_abs_err=err, ms=ms, plain_ms=plain,
                            bound_ms=b_ms, bound_by=b_by, library_ms=None)
                print(line, flush=True)
        del pools, kp, vp
    return ok


def paged_decode_served(torch, rec):
    """bf16 paged decode at granite-8b's served docqa pools: 32 slots of
    2000-3299 valid rows (about 2.6k on average) in pools of 4096 rows a
    slot (256 pages of 16), 32/8 heads, D 128, S 1, from a generator of
    its own (every other check keeps its inputs): one launch a call, bit
    for bit against its plain version and on a repeat call, timed beside
    the plain version,
    with its bound and the twin-order blocks each SM holds at the plan.
    ``rec["paged_decode_attention_served"]`` takes the row."""
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models import layers as L

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(34)
    B, n_pages, ps, H, KVH, D = 32, 256, 16, 32, 8, 128
    P = B * n_pages + 1
    # 2 pool pairs of 537 MB, each past the 50 MB L2
    pools = [tuple(torch.randn((P, ps, KVH, D), generator=gen,
                               device=dev).to(torch.bfloat16)
                   for _ in range(2)) for _ in range(2)]
    perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
    tab = perm[:B * n_pages].reshape(B, n_pages).to(torch.int32)
    pos = torch.randint(2000, 3300, (B,), generator=gen,
                        device=dev).to(torch.int32)
    q = torch.randn((B, 1, H, D), generator=gen,
                    device=dev).to(torch.bfloat16)
    n0 = ops.LAUNCHES["paged_decode_attention"]
    got = ops.paged_decode_attention(q, *pools[0], tab, pos)
    launches = ops.LAUNCHES["paged_decode_attention"] - n0
    want = L.paged_decode_attention(q, *pools[0], tab, pos)
    err = (got.float() - want.float()).abs().max().item()
    good = launches == 1 and bool(torch.equal(got, want)) and bool(
        torch.equal(got, ops.paged_decode_attention(q, *pools[0], tab,
                                                    pos)))
    ms = time_ms(torch, lambda i: ops.paged_decode_attention(
        q, *pools[i % 2], tab, pos))
    plain = time_ms(torch, lambda i: L.paged_decode_attention(
        q, *pools[i % 2], tab, pos), iters=4, warm=1)
    valid = int(pos.sum())
    nbytes = 2 * (2 * valid * KVH * D + 2 * q.numel()) + 4 * (tab.numel()
                                                              + B)
    b_ms, b_by = bound(nbytes, 4.0 * valid * H * D, "bfloat16")
    rows, window = H // KVH, n_pages * ps
    nsplit, per, keep, stages = da.paged_plan_sm90(B, KVH, window, rows, D,
                                                   False)
    blocks = build.load().value("paged_decode_twin_blocks_per_sm", D, rows,
                                window, nsplit, int(keep), stages)
    print(f"paged decode bfloat16 served S=1 H={H}/{KVH} D={D}, {B} slots "
          f"of {valid / B:.0f} rows on average in pools of {window}: "
          f"max_abs_err={err:.3g}, bit for bit (and on a repeat call): "
          f"{good}, {launches} launch(es) a call "
          f"{'ok' if good else 'FAIL'} ms={ms:.4f} plain_ms="
          f"{plain:.4f} bound_ms={b_ms:.5f} ({b_by}); plan {nsplit} "
          f"splits, keep {keep}, {stages} ring slots, {blocks} blocks an "
          f"SM", flush=True)
    rec["paged_decode_attention_served"].update(
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, launches=launches)
    del pools
    return good


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
    key = {512: "flash_attention", 2048: "flash_attention_s2048"}
    for dt_name in ("float32", "bfloat16"):
        for s in (16, 128, 512, 2048):
            good, row = prefill_kernel(torch, gen, H, KVH, D, s, dt_name)
            ok &= good
            if dt_name == "bfloat16" and s in key:
                rec[key[s]].update(row)
    # phase 12's prefill_step at its exact prompt lengths, off the tile:
    # the static batch's longest and (b)'s bucket-128 prompt; drawn from
    # a generator of its own, so every later check's inputs stay
    lens = burst_prompts()[0]
    gen12 = torch.Generator(device=dev).manual_seed(13)
    for s in (int(max(lens[:8])), int(lens[8])):
        good, row = prefill_kernel(torch, gen12, H, KVH, D, s, "bfloat16")
        ok &= good
        if s == int(max(lens[:8])):
            rec["flash_attention_phase12"].update(row)

    # -- paged decode attention ------------------------------------------------
    B = 8
    ok &= paged_decode_kernel(torch, rec, gen, H, KVH, D, (1, 4, 8),
                              "paged_decode_attention")
    ok &= paged_decode_served(torch, rec)
    ok &= chunk_decode_kernel(torch, rec, gen, H, KVH, D)
    # phase 12's serve_step: 8 rings of 1024 at the static batch's
    # positions mid-run (phase 4's first 8 prompts, 32 ticks on); drawn
    # from a generator of its own, so every later check's inputs stay
    ok &= ring_decode_kernel(
        torch, rec, torch.Generator(device=dev).manual_seed(12), B, 1024,
        H, KVH, D,
        [int(n) + 32 for n in burst_prompts()[0][:B]], (1,),
        "decode_attention_phase12")
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
    ok &= dense_family_kernels(torch, rec, gen)
    ok &= moe_family_kernels(torch, rec, gen)
    ok &= train_kernels(torch, rec)
    ok &= shard_kernels(torch, rec)
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


def ring_decode_kernel(torch, rec, gen, B, W, H, KVH, D, ctx, s_list,
                       rec_key):
    """Rolling-cache decode attention over B rings of W tokens (slot b at
    ``ctx[b]`` tokens, wrapped past W) for S in ``s_list`` queries of H q
    heads over KVH kv heads, float32 and bf16, against its plain version
    (and the oracle at S 1): bf16 also in units of 2^-8 sum p|v| and bit
    for bit on a repeat call; timed beside the plain version and masked
    SDPA. ``rec[rec_key]`` takes the bf16 S 1 row."""
    from repro_torch.kernels import ops, plain, ref

    dev = "cuda"
    ok = True
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        # 4 ring pairs (67 MB in bfloat16 at recurrentgemma's shape, 134
        # MB at granite's, more than the 50 MB L2), cycled by the timed
        # launches as the main path reads each layer's cold
        rings = [tuple(torch.randn((B, W, KVH, D), generator=gen,
                                   device=dev).to(dt) for _ in range(2))
                 for _ in range(4)]
        kc, vc = rings[0]
        for s in s_list:
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
                    kc.repeat_interleave(H // KVH, 2).transpose(1, 2)
                    .reshape(B * H, W, D),
                    vc.repeat_interleave(H // KVH, 2).transpose(1, 2)
                    .reshape(B * H, W, D),
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
                rec[rec_key].update(
                    max_abs_err=err, ms=ms, plain_ms=pl_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib)
        del rings, kc, vc
    return ok


def hybrid_kernels(torch, rec, gen):
    """recurrentgemma-9b's kernel shapes: windowed prefill attention at
    head_dim 256, rolling-cache decode attention, the RG-LRU scan and the
    sampler at vocab 256000, each against its plain version."""
    from repro_torch.kernels import ops, plain, ref

    dev = "cuda"
    H, KVH, D, WIN = 16, 1, 256, 2048
    ok = True

    # -- prefill attention over the local window ---------------------------
    for dt_name in ("float32", "bfloat16"):
        good, row = local_prefill_kernel(torch, gen, 2560, H, KVH, D, WIN,
                                         dt_name)
        ok &= good
        if dt_name == "bfloat16":
            rec["flash_attention_local"].update(row)

    # -- decode attention over rolling caches --------------------------------
    B = 8
    ok &= ring_decode_kernel(
        torch, rec, gen, B, 2048, H, KVH, D,
        [1, 100, 777, 2047, 2048, 2049, 3000, 5000],  # up to wrapped rings
        (1, 4), "decode_attention")

    # -- the RG-LRU scan -----------------------------------------------------
    for b, s, l in ((1, 2560, 4096), (2, 384, 4096)):
        good, row = scan_kernel(torch, gen, b, s, l)
        ok &= good
        if s == 2560:
            rec["rglru_scan"].update(row)

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


def local_prefill_kernel(torch, gen, S, H, KVH, D, WIN, dt_name):
    """Windowed prefill attention (causal, keys within ``WIN`` of the
    query) at S tokens of H q heads over KVH kv heads against its plain
    version (bf16 also in units of 2^-8 sum p|v|), timed beside the plain
    version and SDPA with a band mask. Prints the line; returns (ok, the
    row's numbers)."""
    from repro_torch.kernels import ops, plain

    dev = "cuda"
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
    return good, dict(max_abs_err=err, ms=ms, plain_ms=pl_ms, bound_ms=b_ms,
                      bound_by=b_by, library_ms=lib)


def scan_kernel(torch, gen, b, s, l):
    """The RG-LRU scan at (B, S, L) against its plain version, bit for
    bit, timed beside it. Prints the line; returns (ok, the row's
    numbers)."""
    from repro_torch.kernels import ops, plain

    dev = "cuda"
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
    return good, dict(max_abs_err=err, ms=ms, plain_ms=pl_ms, bound_ms=b_ms,
                      bound_by=b_by, library_ms=None)


#: phase 15 (d) and (e)'s per-shard kernel shapes, checked in phase 2 on a
#: generator of their own (torch seed 26): recurrentgemma at tp 2 (8 of
#: its 16 query heads a shard over its one kv head of 256, RG-LRU
#: channel blocks of 2048) and at dp 2 x tp 2 (a data row's 4 slots);
#: granite's paged decode over a data row's 4 slots at dp 2 (32/8 heads)
#: and dp 2 x tp 2 (16/4 heads a shard); the sampler over the rows'
#: concatenated logits (B 8)
SHARD_RECORDS = {
    "flash_attention_rg_tp2": (
        "flash_attention (phase 15 (e): recurrentgemma tp 2, S 584 (the "
        "burst's longest prompt), 8/1 heads, D 256, window 2048)", "flash_attention.cu",
        "flash_attention.py:74"),
    "decode_attention_rg_tp2": (
        "decode_attention (phase 15 (e): recurrentgemma tp 2, 8 rings of "
        "2048 at the burst's first 8 prompts + 16 tokens, S 1, 8/1 heads, "
        "D 256)", "decode_attention.cu",
        "decode_attention.py:264"),
    "decode_attention_rg_dp2tp2": (
        "decode_attention (phase 15 (e): recurrentgemma dp 2 x tp 2, a "
        "row's 4 rings of 2048 at its prompts + 16 tokens, S 1, 8/1 heads, "
        "D 256)",
        "decode_attention.cu", "decode_attention.py:264"),
    "rglru_scan_tp2": (
        "rglru_scan (phase 15 (e): recurrentgemma tp 2, B 1, S 584 (the "
        "burst's longest prompt), L 2048)", "rglru_scan.cu", "rglru_scan.py:48"),
    "paged_decode_attention_dp2": (
        "paged_decode_attention (phase 15 (d): granite dp 2, a row's 4 "
        "slots, S 1, 32/8 heads)", "paged_decode_attention.cu",
        "decode_attention.py:167"),
    "paged_decode_attention_dp2tp2": (
        "paged_decode_attention (phase 15 (d): granite dp 2 x tp 2, a "
        "row's 4 slots, S 1, 16/4 heads a shard)",
        "paged_decode_attention.cu", "decode_attention.py:167"),
    "sample_tokens_dp2": (
        "sample_tokens (phase 15 (d): granite dp 2, the two rows' logits "
        "concatenated, B 8, V 49152)", "sampling.cu", "topk_sample.py:63"),
}


def shard_kernels(torch, rec):
    """Phase 2's checks at phase 15 (d) and (e)'s per-shard shapes
    (``SHARD_RECORDS``), each against its plain version, on a generator
    of their own: recurrentgemma's prefill at the burst's longest prompt
    (each prompt is prefilled at its own length), its decode with slot b
    at prompt b's length plus 16 new tokens."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(26)
    ok = True
    lens, _ = burst_prompts()
    s_max = int(lens.max())
    good, row = local_prefill_kernel(torch, gen, s_max, 8, 1, 256, 2048,
                                     "bfloat16")
    ok &= good
    rec["flash_attention_rg_tp2"].update(row)
    ctx = [int(n) + 16 for n in lens[:8]]
    ok &= ring_decode_kernel(torch, rec, gen, 8, 2048, 8, 1, 256, ctx,
                             (1,), "decode_attention_rg_tp2")
    ok &= ring_decode_kernel(torch, rec, gen, 4, 2048, 8, 1, 256, ctx[4:],
                             (1,), "decode_attention_rg_dp2tp2")
    good, row = scan_kernel(torch, gen, 1, s_max, 2048)
    ok &= good
    rec["rglru_scan_tp2"].update(row)
    ok &= paged_decode_kernel(torch, rec, gen, 32, 8, 128, (1,),
                              "paged_decode_attention_dp2", B=4)
    ok &= paged_decode_kernel(torch, rec, gen, 16, 4, 128, (1,),
                              "paged_decode_attention_dp2tp2", B=4)
    V = 49152
    logits = torch.cat([torch.randn((4, V), generator=gen, device=dev) * 4.0
                        for _ in range(2)])
    logits[0, 5] = logits[0, 11] = logits[0].max() + 1.0  # an argmax tie
    good, res = sampler_check(torch, logits, 2600, 700, 5)
    ok &= good
    mism, _, ms, plain_ms, b_ms, b_by = res["burst"]
    rec["sample_tokens_dp2"].update(max_abs_err=float(mism), ms=ms,
                                    plain_ms=plain_ms, bound_ms=b_ms,
                                    bound_by=b_by, library_ms=None)
    return ok


def chunk_decode_kernel(torch, rec, gen, H, KVH, D, sizes=(64, 512),
                        rec_key="decode_attention_chunk"):
    """Rolling-cache decode attention at the chunk and suffix steps'
    shapes: S queries of H q heads over KVH kv heads over one (1, 1024)
    linear buffer (G * S query rows in groups of 64), S 64 (a chunk of
    prefill, the buffer's last) and S 512 (a suffix of 512 from 512),
    held to the plain version: bf16 in units of 2^-8 sum p|v| and bit for
    bit on a repeat call, float32 to 2e-5; ``rec[rec_key]`` takes the
    bf16 S 64 row."""
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
        for s in sizes:
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
                rec[rec_key].update(
                    max_abs_err=err, ms=ms, plain_ms=pl_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib)
        del bufs, kc, vc
    return ok


def int8_decode_kernel(torch, rec, gen, H, KVH, D,
                       dtypes=("float32", "bfloat16"),
                       grans=("page", "token"),
                       rec_key="paged_decode_attention_int8"):
    """The int8 paged decode kernel against its plain version (the twin
    ``layers.paged_decode_attention_int8``), the oracle, the Pallas body's
    float32-dequant semantics (printed), and within
    ``int8_attention_output_bound`` (plus the type's tolerance, for the
    rounding of both outputs) of the model-dtype kernel on the unquantized
    K/V; at H q heads over KVH kv heads, each of ``dtypes`` and scale
    granularities ``grans``. ``rec[rec_key]`` (when given) takes the bf16
    page-scale S 1 row."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers as L
    from repro_torch.models.blocks import dequantize_kv, quantize_kv

    dev = "cuda"
    ps, n_pages, B = 16, 64, 8
    P = B * n_pages + 1
    ctx = [1, 15, 16, 17, 200, 513, 1000, 1024]  # partial and full pages
    ok = True
    for dt_name in dtypes:
        dt = getattr(torch, dt_name)
        tol, tol_twin = TOL[dt_name], INT8_DECODE_TOL[dt_name]
        raw = [torch.randn((P * ps, KVH, D), generator=gen,
                           device=dev).to(dt) for _ in range(2)]
        perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
        table = perm[:B * n_pages].reshape(B, n_pages).to(torch.int32)
        table_rel = table.clone()
        table_rel[3] = 0  # a released slot: every entry the trash page
        for gran in grans:
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
                            f"S={s} H={H}/{KVH} {name}: "
                            f"max_abs_err={e:.3g} "
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
                                and gran == "page" and rec_key:
                            rec[rec_key].update(
                                max_abs_err=e, ms=ms, plain_ms=plain,
                                bound_ms=b_ms, bound_by=b_by,
                                library_ms=None)
                    print(line, flush=True)
            del sets
    return ok


GRANITE_PROJ = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))


def int8_matmul_kernel(torch, rec, gen, shapes=GRANITE_PROJ,
                       dtypes=("bfloat16", "float32"),
                       bf16_rows=(8, 16, 32, 64, 512)):
    """The int8-weight matmul against its plain version at projection
    shapes (K, N) (granite's by default), decode (M = 8) and prefill (M =
    512; the chunk steps' 64); the library yardstick is torch.matmul with
    the same weight held in x's dtype (the projection the kernel
    replaces)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers as L

    dev = "cuda"
    ok = True
    for dt_name in dtypes:
        dt = getattr(torch, dt_name)
        tol = TOL[dt_name]
        for k, n in shapes:
            # enough weight sets to exceed the 50 MB L2 between launches
            n_sets = max(1, -(-120_000_000 // (k * n)))
            ws = [ops.quantize_int8(torch.randn((k, n), generator=gen,
                                                device=dev))
                  for _ in range(n_sets)]
            w_lib = [(q.to(torch.float32) * s).to(dt) for q, s in ws]
            w_q, scale = ws[0]
            for m in (bf16_rows if dt_name == "bfloat16" else (8, 512)):
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


#: the dense families served at full width (phase 9): (arch, q heads, kv
#: heads, vocabulary), head_dim 128 in all three
DENSE_FAMILIES = {"phi3": ("phi3-medium-14b", 40, 10, 100352),
                  "starcoder2": ("starcoder2-15b", 48, 4, 49152),
                  "chatglm3": ("chatglm3-6b", 32, 2, 65024)}
MAMBA2_VOCAB = 50280  # 8 blocks of 6288 logits, the last of 6264
#: their projections (K, N): phi3's, starcoder2's and chatglm3's d x d_ff
#: and d_ff x d, and chatglm3's K/V projection (2 kv heads of 128)
DENSE_PROJ = ((5120, 17920), (17920, 5120), (6144, 24576), (24576, 6144),
              (4096, 13696), (13696, 4096), (4096, 256))


def dense_family_kernels(torch, rec, gen):
    """The kernels at the shapes of phi3-medium-14b, starcoder2-15b,
    chatglm3-6b and mamba2-1.3b: prefill attention at S 512 (float32 and
    bf16), paged decode over model-dtype pools at S 1 and 4 (float32 and
    bf16), int8 paged decode (bf16, page scales) at starcoder2's G 12 and
    chatglm3's G 16, the chunk step's rolling decode at S 64 over a (1,
    1024) buffer, the sampler at each vocabulary under both mixes, and
    the int8 matmul (bf16) at M 8 and 64 over the new projections. Each
    arch's bf16 rows go into its ``rec`` records."""
    D = 128
    ok = True
    for arch, (_, H, KVH, _) in DENSE_FAMILIES.items():
        for dt_name in ("float32", "bfloat16"):
            good, row = prefill_kernel(torch, gen, H, KVH, D, 512, dt_name)
            ok &= good
            if dt_name == "bfloat16":
                rec[f"flash_attention_{arch}"].update(row)
        ok &= paged_decode_kernel(torch, rec, gen, H, KVH, D, (1, 4),
                                  f"paged_decode_attention_{arch}")
        ok &= chunk_decode_kernel(torch, rec, gen, H, KVH, D, sizes=(64,),
                                  rec_key=f"decode_attention_chunk_{arch}")
        if arch != "phi3":  # G 4, granite's group, is held above
            ok &= int8_decode_kernel(
                torch, rec, gen, H, KVH, D, dtypes=("bfloat16",),
                grans=("page",),
                rec_key=("paged_decode_attention_int8_chatglm3"
                         if arch == "chatglm3" else None))
    vocabs = [(a, f[3]) for a, f in DENSE_FAMILIES.items()]
    for arch, V in vocabs + [("mamba2", MAMBA2_VOCAB)]:
        logits = torch.randn((8, V), generator=gen, device="cuda") * 4.0
        # an argmax tie, one of its ends in the last block
        logits[0, 7] = logits[0, V - 2] = logits[0].max() + 1.0
        good, res = sampler_check(torch, logits, 1000, 100, 7)
        ok &= good
        mism, _, ms, plain, b_ms, b_by = res["phase 2"]
        rec[f"sample_tokens_{arch}"].update(
            max_abs_err=float(mism), ms=ms, plain_ms=plain, bound_ms=b_ms,
            bound_by=b_by, library_ms=None)
    ok &= int8_matmul_kernel(torch, rec, gen, shapes=DENSE_PROJ,
                             dtypes=("bfloat16",), bf16_rows=(8, 64))
    return ok


#: the MoE and mrope archs served at full width (phase 11): (arch, q heads,
#: kv heads, vocabulary, layers served), head_dim 128 in all three; grok-1
#: cut to 4 of its 64 layers and llama4 to 2 of 48 (one dense layer, one
#: MoE layer), qwen2-vl whole
MOE_FAMILIES = {"grok": ("grok-1-314b", 48, 8, 131072, 4),
                "llama4": ("llama4-maverick-400b-a17b", 40, 8, 202048, 2),
                "qwen2vl": ("qwen2-vl-7b", 28, 4, 152064, 28)}


def moe_family_kernels(torch, rec, gen):
    """The kernels at the shapes of grok-1-314b (G 6), llama4 (G 5) and
    qwen2-vl-7b (G 7), D 128: prefill attention at S 512 (float32 and
    bf16), paged decode over model-dtype pools at S 1 and 4 (float32 and
    bf16), int8 paged decode (bf16, page scales) at grok's G 6, the chunk
    step's rolling decode at S 64 over a (1, 1024) buffer (384, 320 and
    448 rows in row groups of 64), and the sampler at vocab 131072,
    202048 and 152064 under both mixes with a tie in the last block. Each
    arch's bf16 rows go into its ``rec`` records."""
    D = 128
    ok = True
    for arch, (_, H, KVH, V, _) in MOE_FAMILIES.items():
        for dt_name in ("float32", "bfloat16"):
            good, row = prefill_kernel(torch, gen, H, KVH, D, 512, dt_name)
            ok &= good
            if dt_name == "bfloat16":
                rec[f"flash_attention_{arch}"].update(row)
        ok &= paged_decode_kernel(torch, rec, gen, H, KVH, D, (1, 4),
                                  f"paged_decode_attention_{arch}")
        ok &= chunk_decode_kernel(torch, rec, gen, H, KVH, D, sizes=(64,),
                                  rec_key=f"decode_attention_chunk_{arch}")
        if arch == "grok":
            ok &= int8_decode_kernel(
                torch, rec, gen, H, KVH, D, dtypes=("bfloat16",),
                grans=("page",), rec_key="paged_decode_attention_int8_grok")
        logits = torch.randn((8, V), generator=gen, device="cuda") * 4.0
        # an argmax tie, one of its ends in the last block
        logits[0, 7] = logits[0, V - 2] = logits[0].max() + 1.0
        good, res = sampler_check(torch, logits, 1000, 100, 7)
        ok &= good
        mism, _, ms, plain, b_ms, b_by = res["phase 2"]
        rec[f"sample_tokens_{arch}"].update(
            max_abs_err=float(mism), ms=ms, plain_ms=plain, bound_ms=b_ms,
            bound_by=b_by, library_ms=None)
    return ok


#: the training path's attention shapes (phase 14): (record key, B, S, q
#: heads, kv heads, head_dim, causal)
TRAIN_ATTN = {"flash_attention_hubert": (4, 4096, 16, 16, 80, False),
              "flash_attention_granite_train": (2, 4096, 32, 8, 128, True)}
#: the autograd Functions' gradients against the plain version's autograd,
#: relative to the largest gradient: float order only (the Function's
#: backward runs the plain version chunk by chunk); bf16 one step at the
#: top of the range
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8}


def train_attention_kernel(torch, gen, B, S, H, KVH, D, causal, dt_name):
    """Prefill attention at a training shape (any mode) against its plain
    version: error (bf16 also in units of 2^-8 sum p|v|), device time,
    bound, plain and SDPA time. Returns (ok, the row's numbers)."""
    from repro_torch.kernels import ops, plain

    dev = "cuda"
    dt = getattr(torch, dt_name)
    q = torch.randn((B, S, H, D), generator=gen, device=dev).to(dt)
    k = torch.randn((B, S, KVH, D), generator=gen, device=dev).to(dt)
    v = torch.randn((B, S, KVH, D), generator=gen, device=dev).to(dt)
    got = ops.flash_attention(q, k, v, causal=causal)
    want = plain.dense_attention(q, k, v, causal=causal)
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL[dt_name]
    good = err <= tol
    units = ""
    if dt_name == "bfloat16":
        u = bf16_units(got, want, q, k, v, causal=causal)
        good &= u <= BF16_UNITS_TOL
        units = (f" scaled {u:.3g} units of 2^-8 sum p|v| "
                 f"tol={BF16_UNITS_TOL:g}")
    del got, want
    ms = time_ms(torch, lambda i: ops.flash_attention(q, k, v,
                                                      causal=causal))
    pl_ms = time_ms(torch, lambda i: plain.dense_attention(
        q, k, v, causal=causal), iters=2, warm=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = time_ms(torch, lambda i: torch.nn.functional
                  .scaled_dot_product_attention(
                      qt, kt, vt, is_causal=causal, enable_gqa=True))
    pairs = S * (S + 1) / 2 if causal else S * S
    flops = 4.0 * B * H * D * pairs
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    b_ms, b_by = bound(nbytes, flops, dt_name)
    print(f"prefill {dt_name} B={B} S={S} H={H}/{KVH} D={D} "
          f"{'causal' if causal else 'non-causal'}: max_abs_err={err:.3g} "
          f"tol={tol}{units} {'ok' if good else 'FAIL'} ms={ms:.4f} "
          f"({tflops(flops, ms)}) plain_ms={pl_ms:.4f} sdpa_ms={lib:.4f} "
          f"({tflops(flops, lib)}) bound_ms={b_ms:.5f} ({b_by})",
          flush=True)
    return good, dict(max_abs_err=err, ms=ms, plain_ms=pl_ms, bound_ms=b_ms,
                      bound_by=b_by, library_ms=lib)


def attention_grads(torch, gen, B, S, H, KVH, D, causal, dt_name):
    """The flash ``Function``'s q, k, v gradients (kernel forward, plain
    recompute backward) against the plain version's autograd, relative to
    the largest gradient, with the backward's device time."""
    from repro_torch import util
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, plain

    dev = "cuda"
    dt = getattr(torch, dt_name)
    q, k, v = (torch.randn((B, S, n, D), generator=gen, device=dev).to(dt)
               .requires_grad_() for n in (H, KVH, KVH))
    grad = torch.randn((B, S, H, D), generator=gen, device=dev).to(dt)
    n0 = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal)
    good = ops.LAUNCHES["flash_attention"] == n0 + 1 \
        and out.grad_fn is not None

    def backward():
        return torch.autograd.grad(out, (q, k, v), grad, retain_graph=True)

    got = backward()
    want = torch.autograd.grad(plain.dense_attention(q, k, v,
                                                     causal=causal),
                               (q, k, v), grad)
    err = max(((g.float() - w.float()).abs().max()
               / w.float().abs().max()).item() for g, w in zip(got, want))
    del got, want
    bwd = util.timeit(backward, iters=3, warmup=1)
    good &= err <= GRAD_TOL[dt_name]
    chunks = len(fa.backward_chunks(B, S, H, KVH))
    print(f"flash attention Function gradients {dt_name} B={B} S={S} "
          f"H={H}/{KVH} D={D} {'causal' if causal else 'non-causal'}: "
          f"max |dq, dk, dv - plain autograd| / max |plain| = {err:.3g} "
          f"tol={GRAD_TOL[dt_name]:.3g} {'ok' if good else 'FAIL'}; "
          f"backward (plain recompute, {chunks} chunks) "
          f"{bwd.median * 1e3:.2f} ms", flush=True)
    return good


def train_kernels(torch, rec):
    """Phase 2's checks at the training path's shapes (phase 14), each
    from a generator of its own: hubert's non-causal head_dim 80 and
    granite's causal train shape, the autograd ``Function``s' gradients."""
    from repro_torch import util
    from repro_torch.kernels import ops, plain

    dev = "cuda"
    ok = True
    gen = torch.Generator(device=dev).manual_seed(14)
    for dt_name in ("bfloat16", "float32"):
        for s in (4096, 4095):
            good, _ = train_attention_kernel(torch, gen, 1, s, 16, 16, 80,
                                             False, dt_name)
            ok &= good
    for key, (B, S, H, KVH, D, causal) in TRAIN_ATTN.items():
        good, row = train_attention_kernel(
            torch, torch.Generator(device=dev).manual_seed(15), B, S, H,
            KVH, D, causal, "bfloat16")
        ok &= good
        rec[key].update(row)
    gen = torch.Generator(device=dev).manual_seed(16)
    for dt_name in ("bfloat16", "float32"):
        ok &= attention_grads(torch, gen, 1, 4096, 16, 16, 80, False,
                              dt_name)
    ok &= attention_grads(torch, gen, 1, 4096, 32, 8, 128, True, "bfloat16")

    # the RG-LRU scan's Function at L 4096
    gen = torch.Generator(device=dev).manual_seed(17)
    b, s, l = 2, 384, 4096
    a = (torch.rand((b, s, l), generator=gen, device=dev) * 0.2
         + 0.79).requires_grad_()
    x = torch.randn((b, s, l), generator=gen, device=dev, requires_grad=True)
    h0 = torch.randn((b, l), generator=gen, device=dev, requires_grad=True)
    y, h = ops.rglru_scan(a, x, h0)
    gy, gh = torch.randn_like(y), torch.randn_like(h)

    def backward():
        return torch.autograd.grad((y, h), (a, x, h0), (gy, gh),
                                   retain_graph=True)

    got = backward()
    want = torch.autograd.grad(plain.rglru_scan(a, x, h0), (a, x, h0),
                               (gy, gh))
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    good = err == 0.0 and y.grad_fn is not None
    ok &= good
    bwd = util.timeit(backward, iters=2, warmup=1)
    ad, xd, hd = (t.detach() for t in (a, x, h0))
    ms = time_ms(torch, lambda i: ops.rglru_scan(ad, xd, hd))
    pl_ms = time_ms(torch, lambda i: plain.rglru_scan(ad, xd, hd), iters=2,
                    warm=1)
    b_ms, b_by = bound(3.0 * b * s * l * 4 + 2 * b * l * 4, 2.0 * b * s * l,
                       "float32")
    print(f"rglru_scan Function gradients B={b} S={s} L={l}: max |da, dx, "
          f"dh0 - plain autograd| = {err:.3g} (exactly 0 required: the "
          f"same plain computation) {'ok' if good else 'FAIL'}; backward "
          f"(plain recompute) {bwd.median * 1e3:.2f} ms; forward kernel "
          f"ms={ms:.4f} plain_ms={pl_ms:.4f} bound_ms={b_ms:.5f} ({b_by})",
          flush=True)
    rec["rglru_scan_train"].update(max_abs_err=err, ms=ms, plain_ms=pl_ms,
                                   bound_ms=b_ms, bound_by=b_by,
                                   library_ms=None)
    return ok


def serve(torch, cfg, params, prompts, *, device, max_new, slots, max_seq,
          sync_every=8, seeded=lambda i: i % 2 == 1, precision=None,
          eng=None, reset=True, step_log=None, virtual=False, **engine):
    """Serve ``prompts`` at once; ``engine`` holds further EngineConfig
    fields (``paged``, ``window``, ``chunk_prefill``, ``prefix_cache``,
    ``moe_capacity_policy``). ``virtual``: the engine's clock advances one
    cost-model tick a step (phase 8's clock) instead of the host's, so the
    queued requests are admitted at the same steps in every round: on a
    MoE arch whose capacity binds, a token's stream depends on the tokens
    routed beside it (TTFT and tok/s stay on the host clock).
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
    n_steps = 0

    def clock():
        if virtual:
            return n_steps * eng._tick_est_s
        return time.perf_counter() - t0

    for r in reqs:
        eng.submit(r, clock())
        stamp()
    t_admitted = time.perf_counter() - t0
    done = 0
    while done < len(reqs):
        m = eng.metrics
        before = (m.prefill_chunks, m.decode_ticks, eng.prefill_calls)
        t_step = time.perf_counter()
        n_steps += 1
        done += len(eng.step(clock()))
        if step_log is not None:
            torch.cuda.synchronize()
            step_log.append((time.perf_counter() - t_step,
                             m.prefill_chunks - before[0],
                             m.decode_ticks - before[1],
                             eng.prefill_calls - before[2]))
        stamp()
    done += len(eng.drain(clock()))
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
    recurrentgemma (5 layers, rings of 64) with prompts past the window;
    phi3, starcoder2 (also at 12/1 heads: G 12), chatglm3 (also at 16/1
    heads: G 16, and with int8 KV pages there) and mamba2; grok-1 at 12/2
    heads (G 6) with a binding capacity factor of 1.0 (tokens drop),
    under "drop" (also chunked, 16) and "strict", llama4 at 10/2 heads (G
    5, its shared expert and dense layer) and qwen2-vl at 14/2 heads (G 7,
    mrope); the sharded hybrids of phase 15 (e), each grid stacked on the
    card against the same grid on the CPU: recurrentgemma at dp 2 x tp 2
    (rings and states split by slot, column blocks of the RG-LRU branches
    and gates) and mamba2 at tp 2 (``in_proj`` blocks)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params, quantize_weights
    from repro_torch.serving import DeviceTopology

    cfg = dataclasses.replace(get_config("granite-8b").reduced(),
                              num_kv_heads=2)
    hybrid = dataclasses.replace(get_config("recurrentgemma-9b").reduced(),
                                 num_layers=5)
    new = {a.split("-")[0]: get_config(a).reduced() for a in (
        "phi3-medium-14b", "starcoder2-15b", "chatglm3-6b", "mamba2-1.3b")}
    sc12 = dataclasses.replace(new["starcoder2"], num_heads=12,
                               num_kv_heads=1)
    glm16 = dataclasses.replace(new["chatglm3"], num_heads=16,
                                num_kv_heads=1)
    grok6 = dataclasses.replace(get_config("grok-1-314b").reduced(),
                                num_heads=12, num_kv_heads=2,
                                moe_capacity_factor=1.0)
    llama5 = dataclasses.replace(
        get_config("llama4-maverick-400b-a17b").reduced(), num_heads=10,
        num_kv_heads=2)
    qwen7 = dataclasses.replace(get_config("qwen2-vl-7b").reduced(),
                                num_heads=14, num_kv_heads=2)
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
            ("recurrentgemma 5 layers f32, rings of 64", hybrid, None, {}),
            ("phi3 f32", new["phi3"], None, {}),
            ("starcoder2 f32 (LayerNorm, GELU)", new["starcoder2"], None,
             {}),
            ("starcoder2 12/1 heads f32 (G 12)", sc12, None, {}),
            ("chatglm3 f32 (half RoPE)", new["chatglm3"], None, {}),
            ("chatglm3 16/1 heads f32 (G 16)", glm16, None, {}),
            ("chatglm3 16/1 heads int8 kv (G 16)", glm16,
             dict(kv_cache_dtype="int8"), {}),
            ("mamba2 f32 (SSD, rolling caches)", new["mamba2"], None, {}),
            ("grok 12/2 heads f32 (G 6), capacity factor 1.0, drop",
             grok6, None, {}),
            ("grok 12/2 heads f32 (G 6), capacity factor 1.0, drop, "
             "chunked 16", grok6, None, dict(chunk_prefill=16)),
            ("grok 12/2 heads f32 (G 6), capacity factor 1.0, strict",
             grok6, None, dict(moe_capacity_policy="strict")),
            ("llama4 10/2 heads f32 (G 5, shared expert)", llama5, None,
             {}),
            ("qwen2-vl 14/2 heads f32 (G 7, mrope)", qwen7, None, {}),
            ("recurrentgemma 5 layers f32 dp 2 x tp 2", hybrid, None,
             dict(topology=DeviceTopology(dp=2, tp=2), slots=4)),
            ("mamba2 f32 tp 2", new["mamba2"], None,
             dict(topology=DeviceTopology(tp=2)))):
        if arch not in weights:
            p_cpu = init_params(arch, seed=0, device="cpu")
            weights[arch] = (p_cpu, _to(torch, p_cpu, "cuda"))
        p_cpu, p_gpu = weights[arch]
        ps = long_prompts if arch is hybrid else prompts
        run = dict(dict(max_new=24, slots=3, max_seq=128,
                        precision=precision), **engine)
        n = engine["topology"].n_chips if "topology" in engine else 0
        a, st_a = serve(torch, arch, p_gpu, ps,
                        device=["cuda:0"] * n if n else "cuda", **run)
        b, _ = serve(torch, arch, p_cpu, ps,
                     device=["cpu"] * n if n else "cpu", **run)
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
    ok &= reduced_prefix_and_preempt(torch, cfg, *weights[cfg])
    ok &= reduced_cluster(torch, cfg, *weights[cfg])
    ok &= reduced_steps(torch, cfg, *weights[cfg])
    return ok


def reduced_steps(torch, cfg, p_cpu, p_gpu):
    """Phase 3's check of phase 12's path: the engine's module-level steps
    on reduced granite in float32, card == CPU token for token:
    ``prefill_step`` of 3 prompts (window 64) inserted into a 3-slot
    rolling cache, 12 greedy ``serve_step`` ticks, ``bucketed_prefill_step``
    of a 23-token prompt in bucket 32 (its first token equal to
    ``prefill_step``'s argmax on each device), and ``generate`` greedy and
    seeded (12 tokens; a 70-token prompt, chunked)."""
    import numpy as np

    from repro_torch.models import init_cache
    from repro_torch.serving import (
        SamplingParams,
        bucketed_prefill_step,
        cache_insert,
        generate,
        prefill_step,
        serve_step,
    )

    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (9, 23, 30, 70)]
    padded = np.zeros((1, 32), np.int32)
    padded[0, :23] = prompts[1]

    def run(params, dev):
        cache = init_cache(cfg, 3, 64, device=dev)
        first, exact = [], None
        for slot, p in enumerate(prompts[:3]):
            last, single = prefill_step(
                cfg, params, torch.from_numpy(p)[None].to(dev), window=64)
            cache_insert(cache, single, slot)
            first.append(torch.argmax(last, dim=-1).to(torch.int32))
            if slot == 1:
                exact = last
        toks = torch.cat(first)
        streams, logits = [toks.tolist()], []
        for _ in range(12):
            toks, last, _ = serve_step(cfg, params, cache, toks[:, None])
            streams.append(toks.tolist())
            logits.append(last.cpu())
        tok, last_b, cache_b = bucketed_prefill_step(
            cfg, params, torch.from_numpy(padded).to(dev), 23, window=64)
        bucket_ok = (int(tok[0]) == int(torch.argmax(exact[0]))
                     and int(cache_b["pos"][0]) == 23)
        gens = [generate(cfg, params, prompts[3], 12, window=128,
                         sampling=sp, device=dev)
                for sp in (None, SamplingParams(temperature=0.8, top_k=20,
                                                top_p=0.9, seed=3))]
        return dict(streams=streams, logits=torch.stack(logits),
                    bucket_tok=int(tok[0]), bucket_ok=bucket_ok,
                    bucket_gap=(last_b - exact).abs().max().item(),
                    generate=gens)

    gpu, cpu = run(p_gpu, "cuda"), run(p_cpu, "cpu")
    same = {k: gpu[k] == cpu[k] for k in ("streams", "bucket_tok",
                                          "generate")}
    gap = (gpu["logits"] - cpu["logits"]).abs().max().item()
    good = (all(same.values()) and gpu["bucket_ok"] and cpu["bucket_ok"]
            and all(len(g) == 12 for g in gpu["generate"]))
    print(f"reduced granite f32 module-level steps: serve_step streams (3 "
          f"slots, 12 ticks) cuda == cpu: {same['streams']} (max abs logit "
          f"gap {gap:.3g}); bucketed_prefill_step first token == "
          f"prefill_step's argmax: cuda {gpu['bucket_ok']} cpu "
          f"{cpu['bucket_ok']} (max abs logit gap cuda "
          f"{gpu['bucket_gap']:.3g} cpu {cpu['bucket_gap']:.3g}), cuda == "
          f"cpu: {same['bucket_tok']}; generate greedy and seeded cuda == "
          f"cpu: {same['generate']} {'ok' if good else 'FAIL'}",
          flush=True)
    return good


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


def burst_prompts():
    """Phase 4's 16 prompts: 29-584 tokens (numpy seed 0), drawn below
    granite's vocabulary of 49152, the smallest of the archs served at
    full width. Returns (lengths, prompts)."""
    import numpy as np

    rng = np.random.default_rng(0)
    lens = rng.integers(20, 601, 16)
    return lens, [rng.integers(0, 49152, n).astype(np.int32) for n in lens]


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
    lens, prompts = burst_prompts()
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
    del reqs, reqs2, reqs3, run, st, st0, st3
    gc.collect()
    torch.cuda.empty_cache()
    # phase 15 (e) on these weights: tp 2 and dp 2 x tp 2
    ok &= sharded_rolling(
        torch, rec, "recurrentgemma bf16", cfg, params,
        dict(max_seq=None, window=win, chunk_prefill=0),
        ((1, 2, {"flash_attention_rg_tp2": "flash_attention",
                 "decode_attention_rg_tp2": "decode_attention",
                 "rglru_scan_tp2": "rglru_scan"}),
         (2, 2, {"decode_attention_rg_dp2tp2": "decode_attention"})),
        ("flash_attention", "decode_attention", "rglru_scan",
         "sample_tokens"))

    # the decode path against the full forward, end to end, in float32
    # (the same architecture at full width, 38 layers, weights from the
    # same seed): after 1 and 16 decode ticks past the 2500-token prompt
    del params
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


def ssd_step_kernel(torch, gen, b):
    """The SSD decode step at mamba2-1.3b's widths (64 heads of 64, state
    128) over ``b`` slots: bf16 lanes cut out of a conv output and an
    in-projection row as the mixer passes them, against the plain version
    (state within 2e-5, y within bf16's 2e-2); the in-place write equal to
    the fresh one bit for bit; timed in place, as served, cycling through
    enough states to keep them out of the 50 MB L2 (each layer's state is
    cold on the main path). Prints the line; returns (ok, the row's
    numbers)."""
    import math

    from repro_torch.kernels import ops, plain

    dev, bf16 = "cuda", torch.bfloat16
    h, p, n = 64, 64, 128
    di = h * p
    state_bytes = b * h * p * n * 4
    n_sets = max(2, -(-120_000_000 // state_bytes))

    def lanes():
        xbc = torch.randn((b, 1, di + 2 * n), generator=gen,
                          device=dev).to(bf16)
        xz = torch.randn((b, 1, 2 * di + 2 * n + h), generator=gen,
                         device=dev).to(bf16)
        return (torch.randn((b, h, p, n), generator=gen, device=dev),
                xbc[:, 0, :di].reshape(b, h, p), xbc[:, 0, di:di + n],
                xbc[:, 0, di + n:], xz[:, 0, 2 * di + 2 * n:])

    sets = [lanes() for _ in range(n_sets)]
    # the family's initialisation: A in [1, 16], dt around 1e-3 .. 1e-1
    A_log = torch.log(1 + 15 * torch.rand(h, generator=gen, device=dev))
    dt_bias = math.log(0.01) + torch.randn(h, generator=gen, device=dev)
    D = torch.ones(h, device=dev)
    w = (dt_bias, A_log, D)
    state = sets[0][0]
    y, out = ops.ssd_step(*sets[0], *w, in_place=False)
    y_want, s_want = plain.ssd_step(*sets[0], *w, in_place=False)
    kept = state.clone()
    y2, out2 = ops.ssd_step(kept, *sets[0][1:], *w, in_place=True)
    torch.cuda.synchronize()
    err = (out - s_want).abs().max().item()
    y_err = (y.float() - y_want.float()).abs().max().item()
    good = (torch.allclose(out, s_want, atol=2e-5, rtol=2e-5)
            and torch.allclose(y.float(), y_want.float(), atol=2e-2,
                               rtol=2e-2)
            and out2 is kept and torch.equal(out2, out)
            and torch.equal(y2, y))
    ms = time_ms(torch, lambda i: ops.ssd_step(*sets[i % n_sets], *w,
                                               in_place=True))
    pl_ms = time_ms(torch, lambda i: plain.ssd_step(*sets[i % n_sets], *w,
                                                    in_place=True),
                    iters=2, warm=1)
    nbytes = 2 * state_bytes + 2 * b * (2 * di + 2 * n + h) + 3 * h * 4
    b_ms, b_by = bound(nbytes, 5.0 * b * h * p * n, "float32")
    print(f"ssd_step B={b} H={h} P={p} N={n} (bf16 lanes, in place, "
          f"{n_sets} states cycled): state max_abs_err={err:.3g} (2e-5), "
          f"y max_abs_err={y_err:.3g} (bf16, 2e-2), in place == fresh bit "
          f"for bit {'ok' if good else 'FAIL'} ms={ms:.4f} "
          f"plain_ms={pl_ms:.4f} bound_ms={b_ms:.5f} ({b_by}, "
          f"{nbytes / 1e6:.1f} MB): {100 * b_ms / ms:.1f}% of the bound; "
          f"no library call computes this step", flush=True)
    return good, dict(max_abs_err=err, ms=ms, plain_ms=pl_ms, bound_ms=b_ms,
                      bound_by=b_by, library_ms=None, launches=None)


def moe_grouped_kernel(torch, gen, t):
    """The grouped MoE expert product at granite-4.0-h-small's widths (72
    experts, top 10, d 4096, ff 768, bf16) over a ``t``-token prefill's
    sorted pairs, routed by the top 10 of random logits: against the
    per-expert loop (``plain.moe_grouped``) in units of 2^-8 sum |h
    w_down| (limit 4, ``tests/test_torch_gpu.py``), the same bits on a
    repeat call; the kernel's two launches timed in a CUDA graph (each
    call reads 1.36 GB of experts, well past the 50 MB L2, as a served
    layer finds them cold), the loop by CUDA events around eager calls
    (its count read to the host, as served before); the launches counted
    around one call (2, else the check fails). The kernel is also timed
    at the other tile size than ``grouped_plan`` picks (the plan swapped
    for the call), within the same tolerance, so that the line shows what
    the choice of 64 or 128 rows buys at ``t``. The bound: the experts, x
    and ys each moved once (h, internal, not counted), against 3 x 2 R d
    ff FLOPs. Prints the line; returns (ok, the row's numbers)."""
    import torch.nn.functional as F

    from repro_torch.kernels import moe_grouped as mg
    from repro_torch.kernels import ops, plain
    from repro_torch.models import moe as tmoe

    dev, bf16 = "cuda", torch.bfloat16
    e, k, d, ff = 72, 10, 4096, 768
    r = t * k
    x = torch.randn((t, d), generator=gen, device=dev, dtype=bf16)
    idx = torch.topk(torch.randn((t, e), generator=gen, device=dev), k,
                     dim=-1).indices
    order = torch.argsort(idx.reshape(-1), stable=True)
    offsets = tmoe.expert_offsets(idx, e)
    ws = [torch.randn((e,) + shape, generator=gen, device=dev,
                      dtype=bf16) * std
          for shape, std in (((d, ff), d ** -0.5), ((d, ff), d ** -0.5),
                             ((ff, d), ff ** -0.5))]
    args = (x, order, offsets, *ws)
    before = ops.LAUNCHES["moe_grouped"]
    got = ops.moe_grouped(*args, k=k, variant="swiglu")
    launches = ops.LAUNCHES["moe_grouped"] - before
    again = ops.moe_grouped(*args, k=k, variant="swiglu")
    want = plain.moe_grouped(*args, k=k, variant="swiglu")
    rows = x[order // k].float()
    counts = (offsets[1:] - offsets[:-1]).tolist()
    bound_t = torch.zeros((r, d), device=dev)
    lo = 0
    for j, n in enumerate(counts):
        if n:
            xr = rows[lo:lo + n]
            h = F.silu(xr @ ws[0][j].float()) * (xr @ ws[1][j].float())
            bound_t[lo:lo + n] = h.abs() @ ws[2][j].float().abs()
            lo += n
    scale = (BF16_UNIT * bound_t).clamp_min(1e-30)
    units = ((got.float() - want.float()).abs() / scale).max().item()
    good = units <= 4.0 and torch.equal(got, again) and launches == 2
    ms = time_ms(torch, lambda i: ops.moe_grouped(*args, k=k,
                                                  variant="swiglu"),
                 iters=10, warm=2)
    bm, tiles = mg.grouped_plan(r, e)
    other, plan = 192 - bm, mg.grouped_plan
    mg.grouped_plan = lambda rr, ee: (other, (rr + ee * (other - 1))
                                      // other)
    try:
        got_other = ops.moe_grouped(*args, k=k, variant="swiglu")
        other_ms = time_ms(torch, lambda i: ops.moe_grouped(
            *args, k=k, variant="swiglu"), iters=10, warm=2)
    finally:
        mg.grouped_plan = plan
    plain_call = lambda: plain.moe_grouped(*args, k=k,  # noqa: E731
                                           variant="swiglu")
    plain_call()
    torch.cuda.synchronize()
    s0 = torch.cuda.Event(enable_timing=True)
    s1 = torch.cuda.Event(enable_timing=True)
    s0.record()
    for _ in range(3):
        plain_call()
    s1.record()
    torch.cuda.synchronize()
    pl_ms = s0.elapsed_time(s1) / 3
    used = sum(1 for n in counts if n)
    nbytes = used * 3 * d * ff * 2 + t * d * 2 + r * (d * 2 + 8)
    flops = 3 * 2.0 * r * d * ff
    b_ms, b_by = bound(nbytes, flops, "bfloat16")
    units_other = ((got_other.float() - want.float()).abs()
                   / scale).max().item()
    good &= units_other <= 4.0
    plain_launches = 6 * used + 3
    print(f"moe_grouped T={t} (E {e}, k {k}, d {d}, ff {ff}, bf16, bm "
          f"{bm}, {tiles} row tiles for {r} rows, experts "
          f"{min(counts)}-{max(counts)} rows): max err {units:.3f} units of "
          f"2^-8 sum|h w| (4), repeat bit for bit "
          f"{'ok' if good else 'FAIL'} ms={ms:.4f} plain_ms={pl_ms:.4f} "
          f"bound_ms={b_ms:.5f} ({b_by}, {nbytes / 1e9:.3f} GB, "
          f"{flops / 1e12:.3f} TFLOP): {100 * b_ms / ms:.1f}% of the bound, "
          f"{flops / ms / 1e9:.1f} TFLOP/s; at bm {other} instead "
          f"ms={other_ms:.4f} ({units_other:.3f} units); launches a call "
          f"{launches} "
          f"(2; plain ~{plain_launches} and a host read of the counts)",
          flush=True)
    err = (got.float() - want.float()).abs().max().item()
    return good, dict(max_abs_err=err, ms=ms, plain_ms=pl_ms, bound_ms=b_ms,
                      bound_by=b_by, library_ms=None, launches=launches)


def full_width_engine(torch, rec, label, cfg, params, prompts, run,
                      kernels, per_exact=None):
    """One engine at full width on ``prompts`` (64 new tokens each): a
    warm-up round pays its captures; then ``reset()``, the launch counts
    zeroed, a timed round, the counts read; a rerun; the steady decode of
    the first 8 requests on the 8 slots. Gates: every request finishes
    with its 64 tokens, the timed round and the rerun give the warm-up
    round's streams, every kernel of ``kernels`` ({record: launch
    counter}) launched in the timed round (its record takes the count),
    each kernel of ``per_exact`` ({launch counter: n}) launched exactly n
    times for each exact-length prefill of the timed round, and the graph
    rule (nothing captured after the warm-up round).
    Prints the burst's TTFT and tok/s, peak memory, launches per kernel,
    and ms per decode tick at 8 slots. Returns (ok, ms per tick)."""
    from repro_torch.kernels import ops

    warm, st0 = warm_round(torch, label, cfg, params, prompts, run)
    run = dict(run, eng=st0["engine"])
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    reqs, st = serve(torch, cfg, params, prompts, **run)
    launches, paths = dict(ops.LAUNCHES), ops.path_rows()
    mem = memory(torch)
    ok = True
    unfinished = [r.rid for r in reqs
                  if r.state.value != "finished" or len(r.output) != 64]
    if unfinished:
        ok = False
        print(f"FAIL: {label} requests without their 64 tokens: "
              f"{unfinished}", flush=True)
    for key, name in kernels.items():
        rec[key]["launches"] = launches[name]
        if launches[name] <= 0:
            ok = False
            print(f"FAIL: kernel {name} never launched on the {label} "
                  f"path", flush=True)
    eng = st["engine"]
    n_exact = sum(1 for r in reqs if not eng._chunkable(r) and not eng.paged
                  and eng._bucket_for(r.prompt_len) is None)
    for name, n in (per_exact or {}).items():
        good = n_exact > 0 and launches[name] == n * n_exact
        ok &= good
        print(f"{label}: {name} launched {launches[name]} times over "
              f"{n_exact} exact-length prefills (want {n} each) "
              f"{'ok' if good else 'FAIL'}", flush=True)
    reqs2, _ = serve(torch, cfg, params, prompts, **run)
    same = (all(a.output == b.output for a, b in zip(warm, reqs))
            and all(a.output == b.output for a, b in zip(reqs, reqs2)))
    ok &= same
    print(burst_line(f"{label} burst (16 requests on 8 slots, 64 new, half "
                     f"seeded)", reqs, st) + f", {mem}; timed round and "
          f"rerun identical to the warm-up round: {same}", flush=True)
    print(f"{label} kernels (launches in the timed round): "
          + ", ".join(f"{k}={v}" for k, v in launches.items())
          + "; sampler rows by path: "
          + ", ".join(f"{k}={v}" for k, v in paths.items()), flush=True)
    # steady decode: the first 8 requests on the 8 slots, every step
    # synchronized; the steps that ran decode ticks alone (no chunk, no
    # prefill beside them) give the tick
    log = []
    reqs3, st3 = serve(torch, cfg, params, prompts[:8], step_log=log, **run)
    busy, n_busy, tick = tick_while(log, "chunks")
    alone = sum(r[2] for r in log if r[2] > 0 and not r[1] and not r[3])
    print(f"{label} decode at 8 slots: {tick:.2f} ms per tick of decode "
          f"alone ({alone} of {st3['ticks']} ticks, "
          f"{8000 / tick if tick else 0:.1f} tok/s)"
          f"; {busy:.2f} ms per tick while chunks interleave ({n_busy} "
          f"steps)", flush=True)
    ok &= graphs_ok(label, warm, st0)
    return ok, tick


def phase_dense(torch, rec):
    """Phase 9: phi3-medium-14b, starcoder2-15b and chatglm3-6b at full
    width and depth in bf16 (random weights from seed 0), one after the
    other, each freed before the next, on the default path (paged KV,
    chunk 64): phase 4's 16 prompts, 8 slots, pages of 16, max_seq 1024;
    chatglm3 also with int8 KV pages (G 16)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    _, prompts = burst_prompts()
    run = dict(device="cuda", max_new=64, slots=8, max_seq=1024)
    ok = True
    for arch, (name, H, KVH, V) in DENSE_FAMILIES.items():
        cfg = get_config(name)
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        n_par = sum(t.numel() for t in _leaves(params))
        floor = 2 * n_par / HBM_BW * 1e3
        print(f"full width {name}: {cfg.num_layers} layers, d "
              f"{cfg.d_model}, {H}/{KVH} heads (G {H // KVH}), vocab {V}, "
              f"{n_par / 1e9:.3f} B params (bf16) initialized in "
              f"{time.perf_counter() - t0:.1f}s; weight-read floor "
              f"{floor:.2f} ms per tick at 3.35 TB/s", flush=True)
        good, _ = full_width_engine(
            torch, rec, f"{arch} bf16", cfg, params, prompts, run,
            {f"flash_attention_{arch}": "flash_attention",
             f"paged_decode_attention_{arch}": "paged_decode_attention",
             f"decode_attention_chunk_{arch}": "decode_attention",
             f"sample_tokens_{arch}": "sample_tokens"})
        ok &= good
        gc.collect()
        if arch == "chatglm3":
            good, _ = full_width_engine(
                torch, rec, f"{arch} int8 kv", cfg, params, prompts,
                dict(run, precision=dict(kv_cache_dtype="int8")),
                {"paged_decode_attention_int8_chatglm3":
                 "paged_decode_attention_int8"})
            ok &= good
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return ok


def hybrid_moe_engine(torch, rec):
    """granite-4.0-h-small at full width cut to 20 of its 40 layers (the
    benchmark's cut: 18 SSD and 2 attention layers, each with its MoE of
    72 experts top 10 and the shared expert; bf16, random weights from
    seed 0), served under the "strict" capacity policy from rolling
    caches (rings of 1024), so that every prompt's exact-length prefill
    routes its 20 MoE layers token-sorted: phase 4's 16 prompts on 8
    slots, with phase 9's rounds, prints and gates, on phase 8's virtual
    clock. The grouped kernel's count is read from the timed round (its
    T 1544 record takes it) and must be 2 a MoE layer for each exact
    prefill there."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    full = get_config("granite-4.0-h-small")
    cfg = dataclasses.replace(full, num_layers=20)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"full width granite-4.0-h-small (depth 20 of {full.num_layers}): "
          f"{cfg.num_moe_layers} MoE layers of {cfg.num_experts} experts of "
          f"{cfg.d_ff} (top-{cfg.experts_per_token}, shared expert), "
          f"{n_bytes / 1e9:.2f} GB (bf16) initialized in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    _, prompts = burst_prompts()
    run = dict(device="cuda", max_new=64, slots=8, max_seq=None, window=1024,
               virtual=True, moe_capacity_policy="strict")
    good, _ = full_width_engine(
        torch, rec, "granite-4.0-h bf16 strict", cfg, params, prompts, run,
        {"moe_grouped_t1544": "moe_grouped"},
        per_exact={"moe_grouped": 2 * cfg.num_moe_layers})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return good


def phase_ssd(torch, rec):
    """Phase 10: the SSD decode step's kernel at B 8 and 64
    (``ssd_step_kernel``), the grouped MoE product at granite-4.0-h's
    widths over 512, 691, 1544 and 3072-token prefills
    (``moe_grouped_kernel``)
    and granite-4.0-h-small served at full width (``hybrid_moe_engine``);
    mamba2-1.3b at full width and depth in bf16
    from rolling caches (exact-length prefill, captured decode), phase 4's
    prompts on 8 slots; then, in float32 at full width, decode logits after the
    584-token prompt (chunks of 256, 256 and a ragged 72) against the
    full forward over the prompt and the decoded tokens."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    ok = True
    gen = torch.Generator(device="cuda").manual_seed(30)
    for b in (8, 64):
        good, row = ssd_step_kernel(torch, gen, b)
        ok &= good
        rec[f"ssd_step_b{b}"].update(row)
    for t in (512, 691, 1544, 3072):
        good, row = moe_grouped_kernel(torch, gen, t)
        ok &= good
        rec[f"moe_grouped_t{t}"].update(row)
    gc.collect()
    torch.cuda.empty_cache()
    ok &= hybrid_moe_engine(torch, rec)

    cfg = get_config("mamba2-1.3b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(params))
    state_mb = (cfg.ssm_num_heads * cfg.ssm_head_dim * cfg.ssm_state_dim
                * 4 / 1e6)
    print(f"full width mamba2-1.3b: {cfg.num_layers} layers, d "
          f"{cfg.d_model}, d_inner {cfg.d_inner}, {cfg.ssm_num_heads} heads "
          f"of {cfg.ssm_head_dim}, state {cfg.ssm_state_dim}, chunk "
          f"{cfg.ssm_chunk}, {n_par / 1e9:.3f} B params (bf16, tied head) "
          f"initialized in {time.perf_counter() - t0:.1f}s; floor per tick "
          f"at 3.35 TB/s: weights {2 * n_par / HBM_BW * 1e3:.2f} ms, SSD "
          f"state read and written at 8 slots "
          f"{2 * 8 * cfg.num_layers * state_mb * 1e6 / HBM_BW * 1e3:.2f} "
          f"ms ({state_mb:.2f} MB a slot a layer)", flush=True)
    lens, prompts = burst_prompts()
    run = dict(device="cuda", max_new=64, slots=8, max_seq=None)
    good, _ = full_width_engine(torch, rec, "mamba2 bf16", cfg, params,
                                prompts, run,
                                {"sample_tokens_mamba2": "sample_tokens",
                                 "ssd_step_b8": "ssd_step"})
    ok &= good
    gc.collect()
    torch.cuda.empty_cache()
    # phase 15 (e) on these weights: tp 2 (in_proj's column blocks)
    ok &= sharded_rolling(torch, rec, "mamba2 bf16", cfg, params,
                          dict(max_seq=None), ((1, 2, {}),),
                          ("sample_tokens",))
    del params
    gc.collect()
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = init_params(cfg32, seed=0, device="cuda")
    prompt = prompts[int(np.argmax(lens))]
    errs = ssd_decode_check(torch, cfg32, params, prompt, ticks=(1, 16))
    good = True
    for t, (err, scale) in errs.items():
        tol = F32_DECODE_TOL * scale
        good &= err <= tol
        print(f"mamba2 float32 decode tick {t} after the {len(prompt)}-"
              f"token prompt vs the full forward: max_abs_err={err:.4g} "
              f"tol={tol:.4g} ({F32_DECODE_TOL} x max|logit| {scale:.3g})",
              flush=True)
    print(f"mamba2 float32 decode vs forward {'ok' if good else 'FAIL'}",
          flush=True)
    del params
    return ok and good


def phase_moe(torch, rec):
    """Phase 11: grok-1-314b (depth 4 of 64: all 8 experts of 32768, 48/8
    heads, vocab 131072), llama4-maverick-400b-a17b (depth 2 of 48: one
    dense layer of 16384 and one MoE layer of all 128 experts and the
    shared expert; 40/8 heads, vocab 202048) and qwen2-vl-7b (nothing
    cut: 28 layers, 28/4 heads, mrope sections (16, 24, 24), vocab
    152064), at full width in bf16 (random weights from seed 0), one
    after the other, each freed before the next, on the default path
    (paged KV pages of 16, chunk 64, max_seq 1024, capacity policy
    "drop"): phase 4's 16 prompts, 64 new tokens, half seeded, 8 slots,
    with phase 9's rounds, prints and gates, on phase 8's virtual clock
    (one cost-model tick a step: admissions at the same steps in every
    round, which a binding capacity needs for its streams to repeat);
    grok also under "strict" and with int8 KV pages. Prints each arch's
    weight-read floor per tick
    (the reference's all-experts products read every expert each tick;
    llama4 also the floor if only the routed experts were read)."""
    from collections import defaultdict

    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    _, prompts = burst_prompts()
    run = dict(device="cuda", max_new=64, slots=8, max_seq=1024,
               virtual=True)
    ok = True
    for arch, (name, H, KVH, V, depth) in MOE_FAMILIES.items():
        full = get_config(name)
        cfg = dataclasses.replace(full, num_layers=depth)
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        n_par = sum(t.numel() for t in _leaves(params))
        floor = 2 * n_par / HBM_BW * 1e3
        cut = (f"depth {depth} of {full.num_layers}" if depth <
               full.num_layers else "nothing cut")
        line = (f"full width {name} ({cut}): {depth} layers, d "
                f"{cfg.d_model}, {H}/{KVH} heads (G {H // KVH}), vocab {V}")
        if cfg.num_experts:
            e, k = cfg.num_experts, cfg.experts_per_token
            per_expert = 3 * cfg.d_model * cfg.d_ff
            n_moe = depth // cfg.moe_layer_period
            routed = n_par - n_moe * (e - min(e, 8 * k)) * per_expert
            line += (f", {n_moe} MoE layer(s) of {e} experts of "
                     f"{cfg.d_ff} (top-{k}"
                     + (", shared expert" if cfg.moe_shared_expert else "")
                     + ")")
        line += (f", {n_par / 1e9:.3f} B params (bf16) initialized in "
                 f"{time.perf_counter() - t0:.1f}s; weight-read floor "
                 f"{floor:.2f} ms per tick at 3.35 TB/s ({2 * n_par / 1e9:.1f}"
                 f" GB" + (", every expert read)" if cfg.num_experts
                           else ")"))
        if cfg.num_experts and routed < n_par:
            line += (f"; {2 * routed / HBM_BW * 1e3:.2f} ms "
                     f"({2 * routed / 1e9:.1f} GB) if only the 8 slots' "
                     f"{min(e, 8 * k)} routed experts were read")
        print(line, flush=True)
        kernels = {f"flash_attention_{arch}": "flash_attention",
                   f"paged_decode_attention_{arch}": "paged_decode_attention",
                   f"decode_attention_chunk_{arch}": "decode_attention",
                   f"sample_tokens_{arch}": "sample_tokens"}
        good, _ = full_width_engine(torch, rec, f"{arch} bf16", cfg, params,
                                    prompts, run, kernels)
        ok &= good
        gc.collect()
        if arch == "grok":
            # the strict round's launches gate it but stay out of the
            # kernel records, which keep the default path's
            good, _ = full_width_engine(
                torch, defaultdict(dict), f"{arch} bf16 strict", cfg,
                params, prompts, dict(run, moe_capacity_policy="strict"),
                kernels)
            ok &= good
            gc.collect()
            good, _ = full_width_engine(
                torch, rec, f"{arch} int8 kv", cfg, params, prompts,
                dict(run, precision=dict(kv_cache_dtype="int8")),
                {"paged_decode_attention_int8_grok":
                 "paged_decode_attention_int8"})
            ok &= good
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return ok


def ssd_decode_check(torch, cfg, params, prompt, ticks):
    """Prefill ``prompt`` into a fresh rolling cache, decode greedily and,
    at each tick in ``ticks``, compare the logits with the full forward
    over the prompt and the decoded tokens. Returns {tick: (max abs
    error, max |logit|)}."""
    from repro_torch.models import decode_step, forward, init_cache

    toks = torch.from_numpy(prompt).to("cuda")[None]
    cache = init_cache(cfg, 1, 512, device="cuda")
    at = torch.full((1,), toks.shape[1] - 1, dtype=torch.int64,
                    device="cuda")
    last, _ = forward(cfg, params, toks, logits_at=at, cache=cache)
    seq, nxt = toks, torch.argmax(last, dim=-1)[:, None]
    errs = {}
    for t in range(1, max(ticks) + 1):
        seq = torch.cat([seq, nxt], 1)
        dec = decode_step(cfg, params, cache, nxt)[:, 0]
        if t in ticks:
            at = torch.full((1,), seq.shape[1] - 1, dtype=torch.int64,
                            device="cuda")
            want, _ = forward(cfg, params, seq, logits_at=at)
            errs[t] = ((dec - want).abs().max().item(),
                       max(1.0, want.abs().max().item()))
        nxt = torch.argmax(dec, dim=-1)[:, None]
    return errs


def phase_steps(torch, rec, full):
    """Phase 12: the engine's module-level steps at full width in bf16 on
    phase 4's granite-8b weights, uncut, outside the engine and its CUDA
    graphs. (a) A static batch: phase 4's first 8 prompts, each through
    ``prefill_step`` (rings of 1024) and ``cache_insert``, then 64
    ``serve_step`` ticks at 8 slots (launch counts zeroed just before,
    read just after: prefill attention and rolling decode must have
    launched). (b) ``bucketed_prefill_step`` at buckets 128 and 512 against
    ``prefill_step`` on the same prompt: the first token must equal the
    argmax (max abs logit gap printed). (c) ``generate`` (the engine's
    default path, window 512) on a greedy prompt of phase 4, 64 new
    tokens: 64 tokens, repeated on a second call; the leading tokens that
    agree with phase 4's stream are printed (1 slot and 8 round bf16
    products differently: no gate). Prints, with ``util.timeit`` (CUDA
    events), ms per ``serve_step`` at 8 slots and its tok/s beside phase
    4's captured engine tick, and ms per ``prefill_step`` at S 512."""
    import numpy as np

    from repro_torch import util
    from repro_torch.kernels import ops
    from repro_torch.models import init_cache
    from repro_torch.serving import (
        bucketed_prefill_step,
        cache_insert,
        generate,
        prefill_step,
        prompt_bucket,
        serve_step,
    )

    cfg, params, prompts = full["cfg"], full["params"], full["prompts"]
    W, B, TICKS = 1024, 8, 64
    ok = True

    def tokens(p):
        return torch.from_numpy(np.asarray(p, np.int32))[None].to("cuda")

    # (a) the static batch (the reference's serving_bench baseline)
    ops.reset_launches()
    cache = init_cache(cfg, B, W, device="cuda")
    first = []
    for slot, p in enumerate(prompts[:B]):
        last, single = prefill_step(cfg, params, tokens(p), window=W)
        cache_insert(cache, single, slot)
        first.append(torch.argmax(last, dim=-1).to(torch.int32))
    toks = torch.cat(first)[:, None]
    for _ in range(TICKS):
        nxt, _, _ = serve_step(cfg, params, cache, toks)
        toks = nxt[:, None]
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    pos = cache["pos"].tolist()
    want_pos = [len(p) + TICKS for p in prompts[:B]]
    for name in ("flash_attention", "decode_attention"):
        if launches[name] <= 0:
            ok = False
            print(f"FAIL: kernel {name} never launched on phase 12's path")
    ok &= pos == want_pos
    print(f"phase 12 (a) static batch: {B} prompts "
          f"({min(map(len, prompts[:B]))}-{max(map(len, prompts[:B]))} "
          f"tokens) through prefill_step and cache_insert, {TICKS} "
          f"serve_step ticks: positions {pos} (want {want_pos}); launches "
          + ", ".join(f"{k}={v}" for k, v in launches.items() if v),
          flush=True)
    rec["decode_attention_phase12"]["launches"] = launches["decode_attention"]
    rec["flash_attention_phase12"]["launches"] = launches["flash_attention"]

    t_tick = util.timeit(serve_step, cfg, params, cache, toks, iters=20,
                         warmup=2)
    p512 = tokens(np.concatenate(prompts)[:512])
    assert p512.shape[1] == 512
    t512 = util.timeit(lambda: prefill_step(cfg, params, p512, window=W),
                       iters=5, warmup=1)
    print(f"phase 12 serve_step at {B} slots (eager, uncaptured; "
          f"util.timeit, CUDA events): {t_tick * 1e3:.3f} ms mean, "
          f"{t_tick.median * 1e3:.3f} ms median -> {B / t_tick:.1f} tok/s; "
          f"phase 4's engine tick (captured): {full['tick_ms']:.2f} ms; "
          f"prefill_step at S {p512.shape[1]}: {t512 * 1e3:.3f} ms mean, "
          f"{t512.median * 1e3:.3f} ms median", flush=True)
    del cache, single

    # (b) bucketed prefill against the exact prompt
    for i in (8, 9):  # 121 and 492 tokens: buckets 128 and 512
        p = prompts[i]
        bucket = prompt_bucket(len(p))
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :len(p)] = p
        exact, _ = prefill_step(cfg, params, tokens(p), window=W)
        tok, last, c = bucketed_prefill_step(
            cfg, params, torch.from_numpy(padded).to("cuda"), len(p),
            window=W)
        gap = (last - exact).abs().max().item()
        good = (int(tok[0]) == int(torch.argmax(exact[0]))
                and int(c["pos"][0]) == len(p))
        ok &= good
        print(f"phase 12 (b) bucketed_prefill_step, {len(p)} tokens in "
              f"bucket {bucket}: first token {int(tok[0])}, prefill_step's "
              f"argmax {int(torch.argmax(exact[0]))}, max abs logit gap "
              f"{gap:.4g} {'ok' if good else 'FAIL'}", flush=True)
        del c

    # (c) generate: phase 4's rid 2 (greedy there), 316 tokens
    ops.reset_launches()
    t0 = time.perf_counter()
    out = generate(cfg, params, prompts[2], 64)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    again = generate(cfg, params, prompts[2], 64)
    phase4 = full["outputs"][2]
    agree = next((i for i, (a, b) in enumerate(zip(out, phase4)) if a != b),
                 min(len(out), len(phase4)))
    good = len(out) == 64 and again == out
    ok &= good
    print(f"phase 12 (c) generate ({len(prompts[2])}-token prompt, window "
          f"512, 64 new): {len(out)} tokens in {t_gen:.3f}s (engine "
          f"built, graphs captured), a second call identical: "
          f"{again == out}; leading tokens equal to phase 4's stream: "
          f"{agree}/64; launches "
          + ", ".join(f"{k}={v}" for k, v in launches.items() if v)
          + f" {'ok' if good else 'FAIL'}", flush=True)
    return ok


#: DLRM's rows per table on one card: the largest round count whose 26
#: tables of 128 float32 fit fig7's rule of 0.8 of an H100's 80 GB
DLRM_ROWS = 4_000_000


def dlrm_reference(torch, cfg, params, batch):
    """DLRM's logits in float64 on the CPU from the batch's gathered rows
    (gathered on the card: the full tables never go to the host) and the
    same MLP weights, written out in numpy."""
    import numpy as np

    t_idx = torch.arange(cfg.num_tables, device="cuda")[None, :, None]
    rows = params["tables"][t_idx, batch["sparse"]]  # (B, T, M, E)
    emb = rows.double().cpu().numpy().sum(axis=2)  # (B, T, E)

    def mlp(layers, x, final_act):
        for i, layer in enumerate(layers):
            x = x @ layer["w"].double().cpu().numpy() \
                + layer["b"].double().cpu().numpy()
            if i < len(layers) - 1 or final_act:
                x = np.maximum(x, 0.0)
        return x

    bot = mlp(params["bottom"], batch["dense"].double().cpu().numpy(), True)
    z = np.concatenate([bot[:, None, :], emb], axis=1)
    inter = np.einsum("bte,bse->bts", z, z)
    iu, ju = np.triu_indices(z.shape[1], k=1)
    top_in = np.concatenate([bot, inter[:, iu, ju]], axis=-1)
    return mlp(params["top"], top_in, False)[:, 0]


def phase_dlrm(torch, keep):
    """Phase 13: DLRM at one card's size, after every phase that holds an
    LLM's weights: the reference's ``DLRMConfig`` widths (26 tables of
    embed 128, 13 dense features, MLPs (512, 256, 128) and (1024, 1024,
    512, 256, 1), multi-hot 8, float32) with ``rows_per_table`` cut from
    10,000,000 (133.1 GB) to 4,000,000 (53.2 GB). Dense features and row
    ids from numpy seed 13, ids uniform over the rows. Gate: a batch of 128
    queries within 1e-4 relative (to the largest logit) of a float64 CPU
    computation from its gathered rows. Prints, with ``util.timeit``, ms
    per batch at B 128 and 2048, queries/s, each batch's lookup bytes and
    their time at 3.35 TB/s, peak allocated GiB, and ``plan_offload`` at
    the H100's numbers for the uncut tables."""
    import numpy as np

    from repro_torch import util
    from repro_torch.configs import get_config
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.simd import (
        dlrm_forward,
        init_dlrm,
        lookup_traffic_bytes,
        plan_offload,
    )

    full_cfg = get_config("dlrm")
    cfg = dataclasses.replace(full_cfg, rows_per_table=DLRM_ROWS)
    print(f"DLRM: rows_per_table cut from {full_cfg.rows_per_table:,} "
          f"({full_cfg.embedding_params() * 4 / 1e9:.1f} GB of tables, "
          f"more than one card holds) to {cfg.rows_per_table:,} "
          f"({cfg.embedding_params() * 4 / 1e9:.1f} GB), the largest round "
          f"count under 0.8 x {H100_SXM.hbm_bytes / 1e9:.0f} GB "
          f"(benchmarks/fig7_dlrm.py's fit rule); {cfg.num_tables} tables "
          f"x embed {cfg.embed_dim}, multi-hot {cfg.multi_hot}, MLPs "
          f"{cfg.bottom_mlp} and {cfg.top_mlp}, float32", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_dlrm(cfg, 0, "cuda")
    torch.cuda.synchronize()
    print(f"DLRM weights ({cfg.param_count() / 1e9:.3f} B params) drawn "
          f"on the card in {time.perf_counter() - t0:.1f}s", flush=True)
    rng = np.random.default_rng(13)

    def make_batch(b):
        return {"dense": torch.from_numpy(rng.standard_normal(
                    (b, cfg.num_dense_features)).astype(np.float32)).cuda(),
                "sparse": torch.from_numpy(rng.integers(
                    0, cfg.rows_per_table,
                    (b, cfg.num_tables, cfg.multi_hot))).cuda()}

    batch = make_batch(128)
    got = dlrm_forward(cfg, params, batch).double().cpu().numpy()
    want = dlrm_reference(torch, cfg, params, batch)
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    ok = (got.shape == (128,) and bool(np.isfinite(got).all())
          and rel <= 1e-4)
    print(f"DLRM B=128: logits {got.shape}, mean {got.mean():.6f}, max abs "
          f"error against float64 from the gathered rows "
          f"{np.abs(got - want).max():.3g} = {rel:.3g} of the largest "
          f"logit (tol 1e-4) {'ok' if ok else 'FAIL'}", flush=True)
    for b in (128, 2048):
        batch = make_batch(b)
        t = util.timeit(dlrm_forward, cfg, params, batch, iters=20,
                        warmup=3)
        nbytes = lookup_traffic_bytes(cfg, b)
        print(f"DLRM B={b}: {t * 1e3:.4f} ms mean, {t.median * 1e3:.4f} ms "
              f"median per batch (util.timeit, CUDA events) -> "
              f"{b / t:.0f} queries/s; lookups read {nbytes / 1e6:.1f} MB "
              f"of rows = {nbytes / H100_SXM.hbm_bw * 1e3:.4f} ms at 3.35 "
              f"TB/s", flush=True)
    print(f"DLRM peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    plan = plan_offload(full_cfg.num_tables * full_cfg.rows_per_table,
                        full_cfg.embed_dim * 4, 0.5 * H100_SXM.hbm_bytes,
                        alpha=1.05)
    print(f"DLRM plan_offload (uncut {full_cfg.rows_per_table:,}-row tables,"
          f" half of an H100's 80 GB for hot rows, Zipf 1.05, host link 32 "
          f"GB/s): {plan.hbm_rows:,} rows on the card, {plan.host_rows:,} "
          f"on the host, hit rate {plan.hit_rate:.4f}, effective "
          f"{plan.effective_bw / 1e9:.1f} GB/s, {plan.slowdown_vs_hbm:.2f}x "
          f"slower than all rows on the card", flush=True)
    keep["dlrm"] = (cfg, params)  # phase 15 splits these tables' rows
    del params, batch
    return ok


# ---------------------------------------------------------------------------
# Phase 15: sharded serving (tensor and expert parallel)
# ---------------------------------------------------------------------------

#: granite-8b's seven projections (in, out) and its lm head: the widths of
#: phase 15's bit-identity probe
GRANITE_MATMULS = (("wq", 4096, 4096), ("wk", 4096, 1024),
                   ("wv", 4096, 1024), ("wo", 4096, 4096),
                   ("w_gate", 4096, 14336), ("w_up", 4096, 14336),
                   ("w_down", 14336, 4096), ("lm_head", 4096, 49152))
#: llama4-maverick's expert stacks (d 5120, ff 8192), 16 of its 128
#: experts: the probe's batched product over expert-axis blocks
LLAMA4_EXPERTS = (16, 5120, 8192)


def shard_grid(torch, n: int, tp: int = 0) -> list:
    """The grid of an n-shard replica whose data rows are ``tp`` wide
    (``tp`` 0: one row): shard j on ``cuda:{(j % tp) % count}``, so the
    data rows of a model shard share its card (their paged pools are one
    tensor) and a one-card host stacks every shard on cuda:0."""
    count = torch.cuda.device_count()
    tp = tp or n
    return [f"cuda:{(j % tp) % count}" for j in range(n)]


def column_probe(torch, gen):
    """Phase 15 (a): whether a shard's product equals its block of the
    single-card product, bit for bit, on this card. Granite's seven
    projections (bf16, the model's ``torch.matmul`` of a column block read
    in place, as shards stacked on one card hold it) and its lm head
    (float32 copy of the block, TF32 off, as ``_logits``) at M 1, 8 and
    64, each column block at tp 2 and 4 against the same block of the
    whole product; and
    llama4's expert products (``torch.bmm`` of 16 experts, bf16) at M 8
    and 64 per expert, each expert-axis block against the whole batch's.
    Returns (every block equal, the worst max abs difference)."""
    rows, worst, equal = [], 0.0, True
    dev = "cuda"

    def check(name, m, tp, blocks, whole_blocks):
        nonlocal worst, equal
        same = all(torch.equal(a, b) for a, b in zip(blocks, whole_blocks))
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(blocks, whole_blocks))
        worst, equal = max(worst, err), equal and same
        rows.append(f"{name} M{m} tp{tp} {'=' if same else f'{err:.3g}'}")

    for name, k, n in GRANITE_MATMULS:
        dt = torch.float32 if name == "lm_head" else torch.bfloat16
        w = (torch.randn((k, n), generator=gen, device=dev)
             * k ** -0.5).to(dt)
        for m in (1, 8, 64):
            x = torch.randn((m, k), generator=gen, device=dev).to(dt)
            whole = torch.matmul(x, w)
            for tp in (2, 4):
                b = n // tp
                blk = ((lambda t: t.contiguous()) if name == "lm_head"
                       else (lambda t: t))
                check(name, m, tp,
                      [torch.matmul(x, blk(w[:, j * b:(j + 1) * b]))
                       for j in range(tp)],
                      [whole[:, j * b:(j + 1) * b] for j in range(tp)])
        del w
    e, d, ff = LLAMA4_EXPERTS
    w = (torch.randn((e, d, ff), generator=gen, device=dev)
         * d ** -0.5).to(torch.bfloat16)
    for m in (8, 64):
        x = torch.randn((e, m, d), generator=gen, device=dev).to(
            torch.bfloat16)
        whole = torch.bmm(x, w)
        for tp in (2, 4):
            b = e // tp
            check("llama4 experts", m, tp,
                  [torch.bmm(x[j * b:(j + 1) * b], w[j * b:(j + 1) * b])
                   for j in range(tp)],
                  [whole[j * b:(j + 1) * b] for j in range(tp)])
    del w
    print("phase 15 (a) column-block probe (block product vs block of the "
          "whole product; '=' bit for bit, else max abs difference): "
          + ", ".join(rows), flush=True)
    print(f"phase 15 (a) every block bit for bit: {equal} (worst max abs "
          f"difference {worst:.3g}); the streams' gate: "
          + ("equality with the one-card engine's" if equal else
             "a near-tie of the one-card logits at each greedy stream's "
             "first divergence"), flush=True)
    return equal, worst


def sharded_dlrm(torch, keep) -> bool:
    """Phase 15 (b): phase 13's tables (26 x 4M rows x 128, float32) row-
    split over 2 shards of ``shard_grid`` (``shard_specs``; on one card the
    row blocks are views, nothing is copied): a batch of 128 queries
    through ``sharded_lookup`` and ``dlrm_forward`` against one table's
    pooled sums, within 1e-5 relative to the largest logit (the pooled
    partial sums add in another order); ms per batch at B 128 and 2048
    beside the one-table forward."""
    import numpy as np

    from repro_torch import util
    from repro_torch.core.simd import dlrm_forward, shard_specs
    from repro_torch.core.simd.sharding import Shards, place
    from repro_torch.launch.mesh import make_local_mesh

    cfg, params = keep.pop("dlrm")
    mesh = make_local_mesh(model=2, devices=shard_grid(torch, 2))
    shards = Shards(place(params, shard_specs(cfg), mesh), mesh)
    rng = np.random.default_rng(1315)

    def make_batch(b):
        return {"dense": torch.from_numpy(rng.standard_normal(
                    (b, cfg.num_dense_features)).astype(np.float32)).cuda(),
                "sparse": torch.from_numpy(rng.integers(
                    0, cfg.rows_per_table,
                    (b, cfg.num_tables, cfg.multi_hot))).cuda()}

    batch = make_batch(128)
    got = dlrm_forward(cfg, shards, batch).double().cpu().numpy()
    want = dlrm_forward(cfg, params, batch).double().cpu().numpy()
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    ok = got.shape == (128,) and bool(np.isfinite(got).all()) and rel <= 1e-5
    print(f"phase 15 (b) DLRM tables row-split over {mesh.flat} "
          f"(blocks {tuple(shards[0]['tables'].shape)}): B 128 against one "
          f"table's pooled sums, max abs difference "
          f"{np.abs(got - want).max():.3g} = {rel:.3g} of the largest logit "
          f"(tol 1e-5) {'ok' if ok else 'FAIL'}", flush=True)
    for b in (128, 2048):
        batch = make_batch(b)
        t2 = util.timeit(dlrm_forward, cfg, shards, batch, iters=20,
                         warmup=3)
        t1 = util.timeit(dlrm_forward, cfg, params, batch, iters=20,
                         warmup=3)
        print(f"phase 15 (b) DLRM B={b}: {t2 * 1e3:.4f} ms a batch over 2 "
              f"row shards vs {t1 * 1e3:.4f} ms over one table (util.timeit,"
              f" CUDA events)", flush=True)
    del shards, params, batch
    return ok


def sharded_case(torch, label, cfg, params, prompts, run, tp, base, kernels,
                 exact, dp=1, rec=None, records=None):
    """One sharded replica of phase 15 on ``shard_grid(dp * tp, tp)``
    (``DeviceTopology(dp=dp, tp=tp)``): a warm-up
    round (captures) whose streams must equal the one-card engine's
    (``base``: its requests and trace probes) when the probe found every
    block bit for bit, else diverge only as ``stream_gap`` allows; its
    trace probes
    must equal the one-card engine's; then ``reset()``, the launch counts
    zeroed, a measured round that repeats the warm-up's streams, captures
    nothing (on one card), launches every kernel of ``kernels`` and gives
    every page back; ``load_report()``'s axis fields; the decode of 8
    requests on the 8 slots (ms per tick). Prints TTFT, tok/s and peak
    memory per device. ``records`` {record: launch counter}: the kernel
    records of ``rec`` that take the measured round's launches. Returns
    (ok, ms per tick)."""
    from repro_torch.kernels import ops
    from repro_torch.serving import DeviceTopology

    grid = shard_grid(torch, dp * tp, tp)
    run = dict(run, device=grid, topology=DeviceTopology(dp=dp, tp=tp))
    warm, st0 = warm_round(torch, label, cfg, params, prompts, run)
    eng = st0["engine"]
    base_reqs, want = base
    ok = True
    same = [r.output for r in warm] == [r.output for r in base_reqs]
    if not same:
        ok &= not exact and stream_gap(torch, label, cfg, params, eng, warm,
                                       base_reqs)
    probes = (eng.prefill_traces, eng.decode_traces)
    ok &= probes == want
    print(f"{label} over {grid}: streams equal to the one-card engine's: "
          f"{same}; trace probes {probes} (one card {want})", flush=True)
    run = dict(run, eng=eng)
    for d in {torch.device(g) for g in grid}:
        torch.cuda.reset_peak_memory_stats(d)
    ops.reset_launches()
    reqs, st = serve(torch, cfg, params, prompts, **run)
    launches = dict(ops.LAUNCHES)
    repeat = [r.output for r in reqs] == [r.output for r in warm]
    unfinished = [r.rid for r in reqs if r.state.value != "finished"]
    drained = not eng.paged or eng.allocator.pages_in_use == 0
    missing = [k for k in kernels if launches[k] <= 0]
    rep = eng.load_report()
    cs, util = dict(rep.axis_collective_s), dict(rep.axis_util)
    axes_ok = (rep.n_chips == dp * tp
               and dict(rep.mesh_axes) == {"data": dp, "model": tp}
               and cs["data"] == 0.0
               and (cs["model"] > 0.0 and 0.0 < util["model"] < 1.0
                    if tp > 1 else cs["model"] == 0.0))
    for key, name in (records or {}).items():
        rec[key]["launches"] = launches[name]
    if eng.graphs.capture:
        ok &= graphs_ok(label, warm, st0)
    else:  # shards on several cards: every step eager, nothing captured
        ok &= eng.graphs.captures == 0
        print(f"{label}: steps eager over {eng.mesh.distinct} cards, "
              f"captures {eng.graphs.captures}", flush=True)
    ok &= (repeat and not unfinished and drained and not missing
           and axes_ok)
    mem = ", ".join(
        f"{d}: {torch.cuda.max_memory_allocated(d) / 2 ** 30:.2f} GiB"
        for d in sorted({str(torch.device(g)) for g in grid}))
    print(burst_line(f"{label} burst (16 requests on 8 slots, "
                     f"{run['max_new']} new, half seeded)", reqs, st)
          + f"; peak allocated per device {mem}; measured round repeats "
          f"the warm-up's streams: {repeat}; unfinished {unfinished}; "
          f"pages back: {drained}", flush=True)
    print(f"{label} kernels (launches in the measured round): "
          + ", ".join(f"{k}={v}" for k, v in launches.items())
          + (f"; FAIL: never launched {missing}" if missing else ""),
          flush=True)
    print(f"{label} load_report: n_chips {rep.n_chips}, mesh_axes "
          f"{dict(rep.mesh_axes)}, axis_collective_s {cs}, axis_util "
          f"{util} {'ok' if axes_ok else 'FAIL'}", flush=True)
    log = []
    serve(torch, cfg, params, prompts[:8], step_log=log, **run)
    tick = tick_while(log, "chunks")[2]
    print(f"{label}: {tick:.2f} ms per tick of decode alone at 8 slots",
          flush=True)
    return ok, tick


def one_card_case(torch, label, cfg, params, prompts, run):
    """The one-card engine beside a phase 15 cell: a warm-up round (its
    streams and probes), a measured round, the steady decode at 8 slots.
    Returns ((requests, probes), ms per tick)."""
    reqs, st = serve(torch, cfg, params, prompts, device="cuda", **run)
    eng = st["engine"]
    probes = (eng.prefill_traces, eng.decode_traces)
    torch.cuda.reset_peak_memory_stats()
    again, st = serve(torch, cfg, params, prompts, device="cuda", eng=eng,
                      **run)
    log = []
    serve(torch, cfg, params, prompts[:8], device="cuda", step_log=log,
          eng=eng, **run)
    tick = tick_while(log, "chunks")[2]
    print(burst_line(f"{label} one card (measured round)", again, st)
          + f"; peak allocated cuda:0: "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
          f"{tick:.2f} ms per tick of decode alone at 8 slots", flush=True)
    del eng, st
    gc.collect()
    torch.cuda.empty_cache()
    return (reqs, probes), tick


_PROBE = []


def probe_verdict(torch):
    """Phase 15 (a)'s column-block probe, run once on its own generator
    (torch seed 15) whichever cell asks first; returns (every block bit
    for bit, the worst max abs difference)."""
    if not _PROBE:
        _PROBE.append(column_probe(
            torch, torch.Generator(device="cuda").manual_seed(15)))
    return _PROBE[0]


def sharded_rolling(torch, rec, label, cfg, params, run, cells, kernels):
    """Phase 15 (e) on the weights of the phase that holds them (6 or
    10): phase 4's 16 prompts, 32 new, half seeded, 8 slots from rolling
    caches, the one-card engine first, then each (dp, tp, records) of
    ``cells`` through ``sharded_case``'s gates. Prints the sub-phase's
    seconds."""
    t0 = time.perf_counter()
    exact, _ = probe_verdict(torch)
    _, prompts = burst_prompts()
    run = dict(run, max_new=32, slots=8)
    base, ticks = one_card_case(torch, f"{label}", cfg, params, prompts,
                                run)
    ok = True
    out = {(1, 1): ticks}
    for dp, tp, records in cells:
        good, out[(dp, tp)] = sharded_case(
            torch, f"{label} dp {dp} x tp {tp}", cfg, params, prompts, run,
            tp, base, kernels, exact, dp=dp, rec=rec, records=records)
        ok &= good
        gc.collect()
        torch.cuda.empty_cache()
    print(f"phase 15 (e) {label}: ms per tick of decode alone at 8 slots "
          + ", ".join(f"dp {dp} x tp {tp} {t:.2f}" for (dp, tp), t in
                      out.items())
          + f"; {time.perf_counter() - t0:.1f}s {'ok' if ok else 'FAIL'}",
          flush=True)
    return ok


def phase_sharded(torch, rec, keep):
    """Phase 15: one replica over a grid of shards
    (``DeviceTopology(dp=M, tp=N)``) at full width in bf16, on
    ``shard_grid`` (every shard on cuda:0 on a one-card host), on the
    default path (paged KV pages of 16, chunk 64, max_seq 1024), phase
    4's 16 prompts, 32 new tokens, half seeded, 8 slots, each arch's
    one-card engine served first and dropped before its sharded engines
    are built. (a) ``column_probe`` (``probe_verdict``: run once); (b)
    ``sharded_dlrm`` over phase 13's tables; (c) granite-8b at tp 2 and 4
    (8/2 heads and a quarter of the MLP a shard at tp 4), and at tp 4
    over int8 KV pages; llama4-maverick cut to 2 of 48 layers at tp 4,
    expert parallel (32 of 128 experts a shard), "strict" pinned on it
    and on its one-card engine; chatglm3-6b at tp 4 (its 2 kv heads:
    pools split on head_dim); (d) granite-8b at dp 2 and dp 2 x tp 2
    beside (c)'s one-card engine. (e) runs in phases 6 and 10
    (``sharded_rolling``). Gates: ``sharded_case``'s. Prints ms per
    decode tick at 8 slots for granite at every grid. Every random input
    comes from generators of this phase (torch seed 15, numpy seed
    1315)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    count = torch.cuda.device_count()
    print(f"phase 15 grid: {count} CUDA device(s); shards of tp 2 on "
          f"{shard_grid(torch, 2)}, of tp 4 on {shard_grid(torch, 4)}",
          flush=True)
    exact, _ = probe_verdict(torch)
    ok = sharded_dlrm(torch, keep)
    gc.collect()
    torch.cuda.empty_cache()
    _, prompts = burst_prompts()
    run = dict(max_new=32, slots=8, max_seq=1024)
    kernels = ("flash_attention", "paged_decode_attention",
               "decode_attention", "sample_tokens")

    ticks = {}
    granite = get_config("granite-8b")
    params = init_params(granite, seed=0, device="cuda")
    base, ticks[1] = one_card_case(torch, "granite bf16", granite, params,
                                   prompts, run)
    for tp in (2, 4):
        good, ticks[tp] = sharded_case(
            torch, f"granite bf16 tp {tp}", granite, params, prompts, run,
            tp, base, kernels, exact)
        ok &= good
        gc.collect()
        torch.cuda.empty_cache()
    print("phase 15 granite-8b decode at 8 slots, ms per tick of decode "
          "alone: " + ", ".join(f"tp {tp} {t:.2f}" for tp, t in
                                ticks.items())
          + " (floors at 3.35 TB/s: 4.9, 6.5, 9.8: the ROW weights read "
          "tp times on one card)", flush=True)
    # (d) the data axis: each row decodes 4 of the 8 slots, the rows of a
    # model shard share its pools on the card
    t0 = time.perf_counter()
    for dp, tp, records in (
            (2, 1, {"paged_decode_attention_dp2": "paged_decode_attention",
                    "sample_tokens_dp2": "sample_tokens"}),
            (2, 2, {"paged_decode_attention_dp2tp2":
                    "paged_decode_attention"})):
        good, ticks[(dp, tp)] = sharded_case(
            torch, f"granite bf16 dp {dp} x tp {tp}", granite, params,
            prompts, run, tp, base, kernels, exact, dp=dp, rec=rec,
            records=records)
        ok &= good
        gc.collect()
        torch.cuda.empty_cache()
    print(f"phase 15 (d) granite-8b ms per tick of decode alone at 8 "
          f"slots: one card {ticks[1]:.2f}, dp 2 {ticks[(2, 1)]:.2f}, dp 2 "
          f"x tp 2 {ticks[(2, 2)]:.2f}; {time.perf_counter() - t0:.1f}s",
          flush=True)
    run8 = dict(run, precision=dict(kv_cache_dtype="int8"))
    base, _ = one_card_case(torch, "granite int8 kv", granite, params,
                            prompts, run8)
    good, _ = sharded_case(
        torch, "granite int8 kv tp 4", granite, params, prompts, run8, 4,
        base, ("flash_attention", "paged_decode_attention_int8",
               "decode_attention", "sample_tokens"), exact)
    ok &= good
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for label, name, depth, extra in (
            ("llama4 strict", "llama4-maverick-400b-a17b", 2,
             dict(moe_capacity_policy="strict")),
            ("chatglm3 bf16", "chatglm3-6b", None, {})):
        cfg = get_config(name)
        if depth:
            cfg = dataclasses.replace(cfg, num_layers=depth)
        params = init_params(cfg, seed=0, device="cuda")
        r = dict(run, **extra)
        base, _ = one_card_case(torch, label, cfg, params, prompts, r)
        good, _ = sharded_case(torch, f"{label} tp 4", cfg, params, prompts,
                               r, 4, base, kernels, exact)
        ok &= good
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return ok


def stream_gap(torch, label, cfg, params, eng, got, want) -> bool:
    """For each stream that differs from the one-card engine's: its first
    divergent token, the top-2 gap of the one-card logits there (forward
    over the one-card stream's tokens, ``params``) and their largest
    difference from the sharded forward's (``eng``'s params) at the same
    place. The streams' gate where the probe found blocks that differ: a
    greedy stream may leave the one-card stream only at a near-tie, its
    top-2 gap within the bf16 tolerance (phase 2's 2e-2) of the largest
    logit there; a seeded stream's draw may flip on any rounding of its
    logits, so its divergence is printed, not gated."""
    import numpy as np

    from repro_torch.models import forward
    from repro_torch.models.moe import resolve_dispatch

    good = True
    for r, w in zip(got, want):
        if r.output == w.output:
            continue
        i = next((j for j, (x, y) in enumerate(zip(r.output, w.output))
                  if x != y), min(len(r.output), len(w.output)))
        toks = torch.from_numpy(np.concatenate([
            w.prompt, np.asarray(w.output[:i], np.int32)])).cuda()[None]
        moe = resolve_dispatch(eng.moe_capacity_policy)
        with torch.no_grad():
            a, _ = forward(cfg, params, toks, moe_dispatch=moe)
            b, _ = forward(cfg, eng.params, toks, moe_dispatch=moe)
        a, b = a[0, -1].float(), b[0, -1].float().to(a.device)
        diff, scale = float((a - b).abs().max()), float(a.abs().max())
        top2 = torch.topk(a, 2).values
        gap = float(top2[0] - top2[1])
        greedy = w.sampling.greedy
        tie = gap <= TOL["bfloat16"] * scale
        good &= tie or not greedy
        verdict = (("ok" if tie else "FAIL") if greedy
                   else "seeded: not gated")
        print(f"{label} rid={r.rid} ({'greedy' if greedy else 'seeded'}): "
              f"first divergent token #{i}: "
              f"{r.output[i] if i < len(r.output) else None} vs "
              f"{w.output[i] if i < len(w.output) else None}; one-card "
              f"top-2 gap {gap:.3g} = {gap / scale:.3g} of the largest "
              f"logit (a greedy stream's tie within {TOL['bfloat16']}: "
              f"{verdict}); sharded forward's logits there {diff:.3g} = "
              f"{diff / scale:.3g} of the largest from the one-card's",
              flush=True)
    return good


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


#: phase 14 (a): reduced train steps card == CPU (arch, config change)
TRAIN_REDUCED = (("granite-8b", {}), ("hubert-xlarge", {}),
                 ("hubert-xlarge", dict(num_heads=4, num_kv_heads=4,
                                        head_dim=80)),
                 ("recurrentgemma-9b", dict(num_layers=3)))
#: step 0 with the kernel against the same step with attention in plain
#: float32, relative: the kernel rounds P to bf16 (2^-8) in each of up to
#: 48 layers' forward and recompute
TRAIN_LOSS_REL, TRAIN_GNORM_REL = 1e-2, 5e-2


def _tree_to(tree, device):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.to(device), tree)


def train_reduced(torch, rec):
    """Phase 14 (a): two float32 ``train_step``s of each reduced config on
    the card and on the CPU (loss, grad norm and params within 1e-4),
    kernel launches 2 a layer a step; chatglm3's loss falls over 30 steps
    on the card."""
    import numpy as np

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params, layer_types
    from repro_torch.training import (
        TokenPipeline,
        init_adamw,
        synthetic_batch,
        train_step,
    )
    from repro_torch.tree import flatten

    ok = True
    for arch, change in TRAIN_REDUCED:
        cfg = dataclasses.replace(get_config(arch).reduced(), **change)
        nb = synthetic_batch(cfg, ShapeConfig("t", 64, 4, "train"),
                             np.random.default_rng(0))
        p_cpu = init_params(cfg, seed=0, device="cpu")
        runs = {}
        for d in ("cpu", "cuda"):
            params = _tree_to(p_cpu, d)
            batch = {k: torch.from_numpy(v).to(d) for k, v in nb.items()}
            opt, metrics = init_adamw(params), []
            ops.reset_launches()
            for _ in range(2):
                params, opt, m = train_step(cfg, params, opt, batch)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            runs[d] = (metrics, params, dict(ops.LAUNCHES))
        (want, p_want, _), (got, p_got, launches) = runs["cpu"], runs["cuda"]
        err = max(abs(g - w) / max(1.0, abs(w)) for gm, wm in zip(got, want)
                  for g, w in zip(gm, wm))
        p_err = max((a.cpu() - b).abs().max().item()
                    for (_, a), (_, b) in zip(flatten(p_got),
                                              flatten(p_want)))
        types = layer_types(cfg)
        attn = sum(t in ("dense", "encoder", "local_attn") for t in types)
        want_l = {"flash_attention": 4 * attn,
                  "rglru_scan": 4 * types.count("rglru")}
        fired = {k: launches[k] for k in want_l}
        good = err <= 1e-4 and p_err <= 1e-4 and fired == want_l
        ok &= good
        if arch == "recurrentgemma-9b":
            rec["rglru_scan_train"]["launches"] = launches["rglru_scan"]
        print(f"phase 14 (a) {cfg.name} reduced {change or ''}: 2 float32 "
              f"steps card (loss, grad norm) {got} vs CPU {want}: max "
              f"error {err:.3g}, params {p_err:.3g} (tol 1e-4); launches "
              f"{fired} (want {want_l}) {'ok' if good else 'FAIL'}",
              flush=True)

    cfg = get_config("chatglm3-6b").reduced()
    params = init_params(cfg, seed=0, device="cuda")
    opt = init_adamw(params)
    losses = []
    pipe = TokenPipeline(cfg.vocab_size, 32, 8, seed=1)
    for i, batch in enumerate(pipe.batches()):
        if i >= 30:
            break
        batch = {k: torch.from_numpy(v).to("cuda") for k, v in batch.items()}
        params, opt, m = train_step(cfg, params, opt, batch, peak_lr=1e-3,
                                    total_steps=40)
        losses.append(float(m["ce"]))
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    good = last < first - 0.1
    ok &= good
    print(f"phase 14 (a) chatglm3-6b reduced, 30 steps on the card "
          f"(TokenPipeline seed 1, lr 1e-3): ce {first:.4f} -> {last:.4f} "
          f"(a fall of more than 0.1 required) {'ok' if good else 'FAIL'}",
          flush=True)
    return ok


def train_full(torch, label, cfg, batch, steps: int = 8):
    """Phase 14 (b) and (c): ``steps`` ``train_step``s of ``cfg`` at full
    width on ``batch`` (tensors on the card), after (1) the same step's
    gradients with attention in plain float32 and (2) with the kernel (no
    leaf's gradient all zero); returns (ok, kernel 1's launches)."""
    import math

    from repro_torch import util
    from repro_torch.configs import ShapeConfig
    from repro_torch.core.costmodel import model_flops
    from repro_torch.kernels import ops, plain
    from repro_torch.models import init_params
    from repro_torch.training import grads_fn, init_adamw, train_step
    from repro_torch.tree import flatten

    params = init_params(cfg, seed=0, device="cuda")
    b, s = batch["labels"].shape

    def gnorm(grads):
        return math.sqrt(sum(float(torch.sum(torch.square(g.float())))
                             for _, g in flatten(grads)))

    # (1) attention in plain float32 (not a kernel path: not counted)
    kernel = ops.flash_attention

    def plain_f32(q, k, v, *, causal=True, window=0):
        return plain.dense_attention(q.float(), k.float(), v.float(),
                                     causal=causal, window=window) \
            .to(q.dtype)

    ops.flash_attention = plain_f32
    try:
        loss_ref, _, grads = grads_fn(cfg, params, batch)
    finally:
        ops.flash_attention = kernel
    loss_ref, gn_ref = float(loss_ref), gnorm(grads)
    del grads
    # (2) the kernel path: every leaf on the graph
    _, _, grads = grads_fn(cfg, params, batch)
    dead = [k for k, g in flatten(grads) if not bool((g != 0).any())]
    n_leaves = len(flatten(grads))
    del grads

    opt = init_adamw(params)
    metrics = []
    state = {"params": params, "opt": opt}
    del params, opt

    def step():
        state["params"], state["opt"], m = train_step(
            cfg, state["params"], state["opt"], batch)
        metrics.append(m)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t = util.timeit(step, iters=steps, warmup=0)
    launches = ops.LAUNCHES["flash_attention"]
    losses = [float(m["loss"]) for m in metrics]
    gns = [float(m["grad_norm"]) for m in metrics]
    finite = all(math.isfinite(x) for x in losses + gns)
    d_loss = abs(losses[0] - loss_ref) / abs(loss_ref)
    d_gn = abs(gns[0] - gn_ref) / gn_ref
    want_l = 2 * cfg.num_layers * steps
    ok = (finite and not dead and launches == want_l
          and d_loss <= TRAIN_LOSS_REL and d_gn <= TRAIN_GNORM_REL)
    step_s = sorted(t.samples[1:])[len(t.samples[1:]) // 2]
    tokens = b * s
    mfu = model_flops(cfg, ShapeConfig("train", s, b, "train")) \
        / (step_s * PEAK["bfloat16"])
    print(f"phase 14 {label}: {cfg.name}, {cfg.num_layers} layers, "
          f"{cfg.param_count() / 1e9:.3f} B params ({cfg.dtype} weights, "
          f"float32 AdamW), B {b} x S {s}, {steps} steps: losses "
          f"{[round(x, 4) for x in losses]}, grad norms "
          f"{[round(x, 4) for x in gns]} (finite: {finite})", flush=True)
    print(f"phase 14 {label}: step 0 against attention in plain float32: "
          f"loss {losses[0]:.6f} vs {loss_ref:.6f} (rel {d_loss:.3g}, tol "
          f"{TRAIN_LOSS_REL:g}), grad norm {gns[0]:.6f} vs {gn_ref:.6f} "
          f"(rel {d_gn:.3g}, tol {TRAIN_GNORM_REL:g}); leaves with an all-"
          f"zero gradient {len(dead)} of {n_leaves} {dead[:4]}; kernel 1 "
          f"launched {launches} (want 2 x {cfg.num_layers} x {steps} = "
          f"{want_l}) {'ok' if ok else 'FAIL'}", flush=True)
    print(f"phase 14 {label}: ms a step (CUDA events) "
          f"{[round(x * 1e3, 2) for x in t.samples]}, median of steps "
          f"1-{steps - 1} {step_s * 1e3:.2f} ms, {tokens / step_s:.1f} "
          f"tokens/s, MFU {mfu * 100:.2f}% (6 N T at 989 TF/s); "
          f"{memory(torch)}", flush=True)
    state.clear()
    return ok, launches


def phase_training(torch, rec):
    """Phase 14: the training path (see the module's note)."""
    import numpy as np

    from repro_torch.configs import get_config, get_shape
    from repro_torch.training import TokenPipeline, synthetic_batch

    ok = train_reduced(torch, rec)
    gc.collect()
    torch.cuda.empty_cache()

    # (b) hubert-xlarge whole; train_4k's batch cut from 256 to 4
    cfg = get_config("hubert-xlarge")
    shape = dataclasses.replace(get_shape("train_4k"), global_batch=4)
    nb = synthetic_batch(cfg, shape, np.random.default_rng(0))
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in nb.items()}
    good, n = train_full(torch, "(b)", cfg, batch)
    ok &= good
    rec["flash_attention_hubert"]["launches"] = n
    del batch
    gc.collect()
    torch.cuda.empty_cache()

    # (c) granite-8b at full width, 2 of its 36 layers
    cfg = dataclasses.replace(get_config("granite-8b"), num_layers=2)
    nb = next(TokenPipeline(cfg.vocab_size, 4096, 2, seed=0).batches())
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in nb.items()}
    good, n = train_full(torch, "(c)", cfg, batch)
    ok &= good
    rec["flash_attention_granite_train"]["launches"] = n
    return ok


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
        "paged_decode_attention_served": dict(
            name="paged_decode_attention (granite-8b docqa's pools: 32 "
                 "slots of 2000-3299 rows, window 4096, S 1, 32/8 heads)",
            route="cuda", source=f"{csrc}/paged_decode_attention.cu",
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
        "decode_attention_phase12": dict(
            name="decode_attention (phase 12 serve_step: 8 rings of 1024, "
                 "S 1, 32/8 heads)", route="cuda",
            source=f"{csrc}/decode_attention.cu",
            replaces="src/repro/kernels/decode_attention.py:264"),
        "flash_attention_phase12": dict(
            name=f"flash_attention (phase 12 prefill_step: S "
                 f"{int(max(burst_prompts()[0][:8]))}, 32/8 heads)",
            route="cuda", source=f"{csrc}/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:74"),
    }
    # the same kernels at the shapes of phases 9 and 10
    rows = {"flash_attention": ("flash_attention", "S 512",
                                "flash_attention.py:74"),
            "paged_decode_attention": ("paged_decode_attention", "S 1",
                                       "decode_attention.py:167"),
            "decode_attention_chunk": ("decode_attention", "chunk S 64, "
                                       "(1, 1024) buffer",
                                       "decode_attention.py:264"),
            "sample_tokens": ("sampling", "", "topk_sample.py:63")}
    families = [(a, f[:4]) for a, f in DENSE_FAMILIES.items()]
    families += [(a, f[:4]) for a, f in MOE_FAMILIES.items()]
    for arch, (name, H, KVH, V) in families:
        for key, (src, what, line) in rows.items():
            shape = f"vocab {V}" if src == "sampling" else \
                f"{H}/{KVH} heads, {what}"
            rec[f"{key}_{arch}"] = dict(
                name=f"{key.replace('_chunk', '')} ({name}, {shape})",
                route="cuda", source=f"{csrc}/{src}.cu",
                replaces=f"src/repro/kernels/{line}")
    rec["paged_decode_attention_int8_chatglm3"] = dict(
        name="paged_decode_attention_int8 (chatglm3-6b, 32/2 heads, page "
             "scales, S 1)", route="cuda",
        source=f"{csrc}/paged_decode_attention_int8.cu",
        replaces="src/repro/kernels/decode_attention.py:216")
    rec["paged_decode_attention_int8_grok"] = dict(
        name="paged_decode_attention_int8 (grok-1-314b, 48/8 heads, page "
             "scales, S 1)", route="cuda",
        source=f"{csrc}/paged_decode_attention_int8.cu",
        replaces="src/repro/kernels/decode_attention.py:216")
    rec["flash_attention_hubert"] = dict(
        name="flash_attention (hubert-xlarge train: B 4, S 4096, 16/16 "
             "heads, D 80, non-causal, bf16)", route="cuda",
        source=f"{csrc}/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:74")
    rec["flash_attention_granite_train"] = dict(
        name="flash_attention (granite-8b train: B 2, S 4096, 32/8 heads, "
             "causal, bf16)", route="cuda",
        source=f"{csrc}/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:74")
    rec["rglru_scan_train"] = dict(
        name="rglru_scan (train Function forward: timed at B 2, S 384, L "
             "4096; launches in phase 14 (a)'s reduced recurrentgemma)",
        route="cuda", source=f"{csrc}/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:48")
    rec["sample_tokens_mamba2"] = dict(
        name=f"sample_tokens (mamba2-1.3b, vocab {MAMBA2_VOCAB})",
        route="cuda", source=f"{csrc}/sampling.cu",
        replaces="src/repro/kernels/topk_sample.py:63")
    for key, (name, src, line) in SHARD_RECORDS.items():
        rec[key] = dict(name=name, route="cuda", source=f"{csrc}/{src}",
                        replaces=f"src/repro/kernels/{line}")
    for b in (8, 64):
        rec[f"ssd_step_b{b}"] = dict(
            name=f"ssd_step (mamba2-1.3b decode step, B {b}, 64 heads of "
                 f"64, state 128, bf16 lanes, in place)", route="cuda",
            source=f"{csrc}/ssd_step.cu",
            replaces="none: the reference's step is plain jnp "
                     "(src/repro/models/ssm.py apply_ssd)")
    for t in (512, 691, 1544, 3072):
        rec[f"moe_grouped_t{t}"] = dict(
            name=f"moe_grouped (granite-4.0-h-small MoE layer, T {t}: E 72, "
                 f"top 10, d 4096, ff 768, bf16)", route="cuda",
            source=f"{csrc}/moe_grouped.cu",
            replaces="none: the reference's MoE is plain jnp "
                     "(src/repro/models/moe.py)")
    full, keep = {}, {}
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
                      ("full-width engine steps",
                       lambda: phase_steps(torch, rec, full)),
                      ("full-width hybrid serving",
                       lambda: phase_hybrid(torch, rec, profile_dir)),
                      ("full-width dense families",
                       lambda: phase_dense(torch, rec)),
                      ("full-width SSD serving",
                       lambda: phase_ssd(torch, rec)),
                      ("full-width MoE and mrope serving",
                       lambda: phase_moe(torch, rec)),
                      ("DLRM at one card's size",
                       lambda: phase_dlrm(torch, keep)),
                      ("sharded serving",
                       lambda: phase_sharded(torch, rec, keep)),
                      ("training", lambda: phase_training(torch, rec)),
                      ("full-width profiler hook",
                       lambda: phase_profile_hook(torch))):
        t0 = time.perf_counter()
        if not fn():
            return fail(f"phase '{phase}'")
        print(f"phase '{phase}' ok in {time.perf_counter() - t0:.1f}s",
              flush=True)
        if phase == "full-width engine steps":
            full.clear()  # granite's weights go before recurrentgemma's
        gc.collect()  # each model is freed before the next is built
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
