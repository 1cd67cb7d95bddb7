"""Serving CLI of the PyTorch port: one ``ServingEngine`` fed by a
synthetic open-loop client, with the JAX package's report lines (QPS,
tokens/s, latency and TTFT percentiles).

    python -m repro_torch.launch.serve --arch granite-8b --requests 16 \
        --slots 8 --prompt-len 256 --max-new 64 --max-seq 1024

runs on the GPU (``--device cuda``, the default; it raises when there is
no CUDA device). ``--device cpu --reduced`` runs the plain PyTorch path on
the CPU. Weights are random, from ``--seed``. ``--temperature`` > 0
switches every request to seeded stochastic decode; request i samples with
seed ``--sample-seed + i``, so a rerun reproduces every stream.

Ported so far: the paged KV cache (dense archs), rolling caches
(``--no-paged`` on dense archs; recurrentgemma-9b always, its KV rings
and RG-LRU states), single-shot and chunked prefill (``--chunk-prefill``,
64 by default as in the reference; 0 = single-shot), the shared-prefix
KV cache (``--prefix-cache``) and preemption (``--preemption``), one card,
with ``--kv-dtype int8`` (int8 KV pages) and ``--weight-dtype int8``
(weight-only int8) as the paged path's quantized variant. The banner says
which cache serves. ``EngineConfig.validate`` names the ROADMAP.md item of
every other option.

    python -m repro_torch.launch.serve --arch recurrentgemma-9b \
        --requests 16 --slots 8 --window 2048 --prompt-len 256 --max-new 64
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.costmodel import kv_bytes_per_token
from repro_torch.core.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serving import (
    EngineConfig,
    PrecisionConfig,
    Request,
    SamplingParams,
    ServingEngine,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4,
                    help="decode slots; 0 = derive from the cost model")
    ap.add_argument("--window", type=int, default=256)
    ap.add_argument("--rate", type=float, default=8.0, help="arrivals/s")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--sync-every", type=int, default=8,
                    help="decode ticks per device->host token sync")
    ap.add_argument("--chunk-prefill", type=int, default=64,
                    help="chunked-prefill piece size; 0 = single-shot")
    ap.add_argument("--no-paged", action="store_true",
                    help="serve from rolling KV windows instead of pages "
                         "(archs that cannot page always do)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page")
    ap.add_argument("--max-seq", type=int, default=0,
                    help="per-request token cap / page-table width; "
                         "0 = window")
    ap.add_argument("--pool-pages", type=int, default=0,
                    help="shared KV pool size in pages; 0 = full headroom, "
                         "less oversubscribes (admission backpressure)")
    ap.add_argument("--kv-dtype", default="", choices=["", "int8"],
                    help="KV-cache page dtype: int8 stores pages as int8 "
                         "values + per-vector fp32 scales")
    ap.add_argument("--weight-dtype", default="", choices=["", "int8"],
                    help="weight-only int8 for the attention/MLP matmuls "
                         "(per-output-channel fp32 scales, f32 accumulation)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="shared-prefix KV cache: keep finished prompts' "
                         "pages in a radix index; later requests alias "
                         "them and prefill only their suffix (paged only)")
    ap.add_argument("--preemption", action="store_true",
                    help="allow evicting a decoding slot for a more "
                         "urgent arrival; the victim's generated prefix "
                         "is cached and its stream restored bit-identical "
                         "(paged only)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="decode sampling temperature; 0 = greedy argmax")
    ap.add_argument("--top-k", type=int, default=0,
                    help="sample from the k largest logits; 0 = no cut")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass; 1 = no cut")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="base sampling seed; request i uses seed+i")
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (plain "
                         "PyTorch versions)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.temperature <= 0 and (args.top_k > 0 or args.top_p < 1.0):
        print("warning: --top-k/--top-p have no effect with "
              "--temperature 0 (greedy decode); pass --temperature > 0 "
              "to sample", file=sys.stderr)

    config = EngineConfig(slots=args.slots, window=args.window,
                          sync_every=args.sync_every,
                          chunk_prefill=args.chunk_prefill,
                          prefix_cache=args.prefix_cache,
                          preemption=args.preemption,
                          paged=False if args.no_paged else None,
                          page_size=args.page_size,
                          max_seq=args.max_seq or None,
                          pool_pages=args.pool_pages or None,
                          precision=PrecisionConfig(
                              kv_cache_dtype=args.kv_dtype,
                              weight_dtype=args.weight_dtype))
    config.validate(cfg)
    rng = np.random.default_rng(args.seed)
    params = init_params(cfg, seed=args.seed, device=device)
    eng = ServingEngine(cfg, params, config, device=device)
    card = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {card}  arch={cfg.name} layers={cfg.num_layers} "
          f"d_model={cfg.d_model} dtype={cfg.dtype}")
    if not args.slots:
        print(f"admission plan: slots={eng.slots} "
              f"flush_deadline={eng.plan.flush_deadline_s*1e3:.2f}ms "
              f"(cost-model step={eng.plan.step_latency_s*1e3:.3f}ms)")
    if eng.paged:
        print(f"paged KV: page_size={eng.page_size} max_seq={eng.max_seq} "
              f"pool={eng.pool_pages} pages "
              f"({eng.allocator.capacity} usable + trash)")
    else:
        rings = sorted({c["k"].shape[1] for c in eng.cache["layers"]
                        if "k" in c})
        n_rec = sum("state" in c for c in eng.cache["layers"])
        print(f"rolling caches: window={eng.window} KV rings of {rings} "
              f"tokens, {n_rec} recurrent states, {eng.slots} slots")
    if args.kv_dtype or args.weight_dtype:
        print(f"quantized: kv_cache_dtype={args.kv_dtype or cfg.dtype} "
              f"weight_dtype={args.weight_dtype or cfg.dtype} "
              f"kv_bytes/token="
              f"{kv_bytes_per_token(cfg, args.kv_dtype):.0f}")

    arrivals = np.cumsum(rng.exponential(1.0 / args.rate, args.requests))
    reqs = [
        Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size,
                                args.prompt_len).astype(np.int32),
            max_new_tokens=args.max_new,
            arrival_time=float(arrivals[i]),
            sampling=SamplingParams(temperature=args.temperature,
                                    top_k=args.top_k, top_p=args.top_p,
                                    seed=args.sample_seed + i),
        )
        for i in range(args.requests)
    ]
    queue = list(reqs)
    t0 = time.time()
    done = 0
    while done < args.requests:
        now = time.time() - t0
        while queue and queue[0].arrival_time <= now:
            eng.submit(queue.pop(0), now)
        done += len(eng.step(time.time() - t0))
        busy = not eng.idle
        if not busy and queue:
            # idle until the next arrival
            time.sleep(max(0.0, queue[0].arrival_time - (time.time() - t0)))
    done += len(eng.drain(time.time() - t0))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    m = eng.metrics
    m.total_time = wall
    lats = [r.finish_time - r.arrival_time for r in reqs]
    ttfts = [r.ttft for r in reqs if r.ttft >= 0]
    print(f"served {args.requests} requests in {wall:.2f}s  "
          f"qps={args.requests/wall:.2f}  tok/s={m.total_tokens/wall:.1f}  "
          f"ticks={m.decode_ticks}  host_syncs={m.host_syncs}  "
          f"prefill_chunks={m.prefill_chunks}")
    if m.prefix_hits:
        print(f"prefix cache: {m.prefix_hits} hits, "
              f"{m.prefix_hit_tokens} prompt tokens skipped")
    g = eng.graphs
    print(f"compiled steps: prefill_traces={eng.prefill_traces} "
          f"decode_traces={eng.decode_traces} (CUDA graphs captured: "
          f"{g.captures} in {g.capture_s:.2f}s, replays {g.replays})")
    if m.sampled_requests:
        print(f"sampled decode: {m.sampled_requests} requests "
              f"(T={args.temperature} top_k={args.top_k} "
              f"top_p={args.top_p}, seeds {args.sample_seed}+rid)")
    print(f"latency p50={np.percentile(lats,50)*1e3:.0f}ms "
          f"p99={np.percentile(lats,99)*1e3:.0f}ms  "
          f"mean_jct={np.mean(lats)*1e3:.0f}ms  "
          f"ttft p50={np.percentile(ttfts,50)*1e3:.0f}ms "
          f"p95={np.percentile(ttfts,95)*1e3:.0f}ms")
    lifecycle = (m.rejected, m.cancelled, m.timed_out, m.shed, m.failed,
                 m.preempted)
    if any(lifecycle):
        print(f"lifecycle: rejected={m.rejected} cancelled={m.cancelled} "
              f"timed_out={m.timed_out} shed={m.shed} failed={m.failed} "
              f"preempted={m.preempted} (restored={m.preempt_restores})")
    return reqs


if __name__ == "__main__":
    main()
