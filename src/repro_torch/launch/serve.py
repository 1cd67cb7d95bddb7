"""Serving CLI of the PyTorch port: one ``ServingEngine``, or several
behind the cluster frontend, fed by a synthetic open-loop client, with
the JAX package's report lines (QPS, tokens/s, latency and TTFT
percentiles, SLO goodput, per replica and per tenant).

    python -m repro_torch.launch.serve --arch granite-8b --requests 16 \
        --slots 8 --prompt-len 256 --max-new 64 --max-seq 1024

runs on the GPU (``--device cuda``, the default; it raises when there is
no CUDA device). ``--device cpu --reduced`` runs the plain PyTorch path on
the CPU. Weights are random, from ``--seed``. ``--temperature`` > 0
switches every request to seeded stochastic decode; request i samples with
seed ``--sample-seed + i``, so a rerun reproduces every stream.

Archs served: granite-8b, phi3-medium-14b, starcoder2-15b and
chatglm3-6b (dense; chatglm3's half-dim RoPE), qwen2-vl-7b (dense blocks
under mrope), grok-1-314b and llama4-maverick-400b-a17b (MoE; their
capacity policy from ``--moe-capacity``: strict | backpressure | drop,
"drop" by default on one card), recurrentgemma-9b (hybrid) and
mamba2-1.3b (SSD); hubert-xlarge, an encoder, exits with the
reference's "encoder-only arch: no autoregressive serving". Ported so
far: the paged KV cache (dense and MoE archs), rolling caches
(``--no-paged`` on dense archs; recurrentgemma-9b and mamba2-1.3b
always, their KV rings, RG-LRU and SSD states), single-shot
and chunked prefill (``--chunk-prefill``, 64 by default as in the
reference; 0 = single-shot), the shared-prefix KV cache
(``--prefix-cache``) and preemption (``--preemption``), with
``--kv-dtype int8`` (int8 KV pages) and ``--weight-dtype int8``
(weight-only int8) as the paged path's quantized variant, and
``--sla-ms`` (the per-step SLA budget the admission plan sizes slots and
the flush deadline by). The banner says which cache serves.

``--tp N`` serves one replica over N shards (tensor parallel, expert
parallel on MoE archs whose config asks for it; every serving arch,
paged or rolling caches, model-dtype or int8 KV) and ``--dp M`` over M
data rows of them (the slots split over the rows), on the host's first
M x N cards, or over ``--devices``, an explicit comma-separated grid,
row-major, where a device may repeat (``cuda:0,cuda:0`` on one card,
``cpu,cpu,cpu,cpu`` with ``--device cpu``); the banner prints the
(data, model) grid and its rows. Paged pools stay whole over the data
rows, so a paged replica stacks each model shard's rows on one device.

    python -m repro_torch.launch.serve --arch granite-8b --reduced \
        --device cpu --tp 4 --devices cpu,cpu,cpu,cpu
    python -m repro_torch.launch.serve --arch recurrentgemma-9b --reduced \
        --device cpu --dp 2 --tp 2 --devices cpu,cpu,cpu,cpu
``EngineConfig.validate`` names the ROADMAP.md item of every other
option.

``--replicas N`` (N > 1) serves the traffic through the cluster frontend:
N engines built from one set of weights (held once) behind one SLO-aware
frontend queue, routed by ``--route-policy`` (round-robin | least-loaded |
p2c | predicted), with failover (``--max-retries``) and a health watchdog
at the cost model's time for 8 ticks on the engine's card, floored at 1 s.
``--ttft-slo-ms`` / ``--tpot-slo-ms`` tag every request with an SLO, so the
report adds goodput. ``--tenants "gold=1:4,bulk=0:1:64:128"`` declares SLO
classes (``name=tier:weight[:rate_tokens_s[:burst_tokens]]``): requests are
tagged round-robin across them, the frontend queue turns weighted-fair and
over-rate submissions are refused with a finite ``retry_after_s``;
``--overload`` arms the degradation ladder and the circuit breaker.
``--trace-out PATH`` turns on span tracing and writes the run as a Chrome
trace (``--trace-sample-n N`` traces every Nth rid); ``--metrics-out
PATH`` writes the metrics exposition and a JSON snapshot at ``PATH.json``;
``--profile-dir DIR`` runs ``torch.profiler`` around the serving loop and
writes its Chrome trace into DIR; the engine's own ``repro_torch/...``
ranges (each ``submit`` / ``step`` / ``drain`` call, each step as ``run
<kind>/<name><n>``, each host sync as ``wait <site>``) sit there beside the
kernels they launched, on the profiler's clock.

    python -m repro_torch.launch.serve --arch granite-8b --reduced \
        --device cpu --replicas 2 --route-policy predicted \
        --trace-out /tmp/t.json --metrics-out /tmp/m.prom

    python -m repro_torch.launch.serve --arch recurrentgemma-9b \
        --requests 16 --slots 8 --window 2048 --prompt-len 256 --max-new 64
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.configs import ArchConfig, get_config
from repro_torch.core.costmodel import (
    kv_bytes_per_token,
    suggest_health_timeout_s,
)
from repro_torch.core.device import resolve_device
from repro_torch.core.mimd.router import POLICIES
from repro_torch.models import init_params
from repro_torch.serving import (
    CircuitBreaker,
    ClusterFrontend,
    DeviceTopology,
    EngineConfig,
    OverloadDetector,
    PrecisionConfig,
    Request,
    SamplingParams,
    ServingEngine,
    TenantClass,
)
from repro_torch.serving.trace_export import (
    request_traces,
    write_chrome_trace,
)


def _parse_tenants(spec: str) -> dict:
    """``gold=2:4,bulk=0:1:256:2048`` -> ``{name: TenantClass}``
    (name=tier:weight[:rate_tokens_s[:burst]])."""
    tenants = {}
    for part in filter(None, spec.split(",")):
        name, _, shape = part.partition("=")
        f = shape.split(":") if shape else []
        tenants[name] = TenantClass(
            name,
            tier=int(f[0]) if len(f) > 0 and f[0] else 0,
            weight=float(f[1]) if len(f) > 1 and f[1] else 1.0,
            rate_tokens_s=float(f[2]) if len(f) > 2 and f[2] else 0.0,
            burst_tokens=float(f[3]) if len(f) > 3 and f[3] else 0.0)
    return tenants


def build_parser() -> argparse.ArgumentParser:
    """The serve CLI's flags, with the reference's names and defaults."""
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
    ap.add_argument("--sla-ms", type=float, default=50.0,
                    help="per-step SLA budget for the admission plan")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor/expert-parallel ways per replica (the "
                         "mesh 'model' axis); needs tp*dp cards, or "
                         "--devices")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel ways per replica (the mesh 'data' "
                         "axis): each row decodes its block of the slots")
    ap.add_argument("--devices", default="",
                    help="the replica's device grid, comma-separated, "
                         "tp*dp entries (a device may repeat: "
                         "cuda:0,cuda:0); empty = the first tp*dp cards")
    ap.add_argument("--moe-capacity", default="",
                    choices=("", "strict", "backpressure", "drop"),
                    help="MoE capacity-overflow policy; empty = strict on "
                         "sharded MoE replicas, drop otherwise")
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
    ap.add_argument("--replicas", type=int, default=1,
                    help="ServingEngine replicas behind the cluster "
                         "frontend; 1 = single-engine path")
    ap.add_argument("--route-policy", default="predicted", choices=POLICIES,
                    help="cluster routing policy (with --replicas > 1)")
    ap.add_argument("--ttft-slo-ms", type=float, default=0.0,
                    help="per-request TTFT deadline; 0 = untracked")
    ap.add_argument("--tpot-slo-ms", type=float, default=0.0,
                    help="per-request mean TPOT bound; 0 = untracked")
    ap.add_argument("--request-timeout-s", type=float, default=0.0,
                    help="per-request JCT deadline; overdue requests are "
                         "aborted and their slot and pages freed (0 = none)")
    ap.add_argument("--max-retries", type=int, default=3,
                    help="per-request failover budget at the cluster "
                         "frontend (with --replicas > 1)")
    ap.add_argument("--metrics-out", default="",
                    help="write the metrics registry here as text "
                         "exposition, plus a JSON snapshot at PATH.json")
    ap.add_argument("--trace-out", default="",
                    help="turn on request span tracing and write the run "
                         "as a Chrome trace (ui.perfetto.dev)")
    ap.add_argument("--trace-sample-n", type=int, default=1,
                    help="with tracing on, trace only every Nth request "
                         "(rid %% N == 0); 1 = all")
    ap.add_argument("--tenants", default="",
                    help="SLO classes as name=tier:weight[:rate_tokens_s"
                         "[:burst_tokens]],...; requests are tagged "
                         "round-robin and the frontend queue turns "
                         "weighted-fair")
    ap.add_argument("--overload", action="store_true",
                    help="arm the degradation-ladder overload detector "
                         "(--ttft-slo-ms as its p99 target) and the "
                         "failover circuit breaker")
    ap.add_argument("--profile-dir", default="",
                    help="run torch.profiler around the serving loop and "
                         "write its Chrome trace into this directory; the "
                         "engine's repro_torch/... ranges (its calls, "
                         "steps and host-sync waits) appear in the trace "
                         "beside the kernels they launched")
    ap.add_argument("--device", default="cuda",
                    help="cuda (hand-written kernels) or cpu (plain "
                         "PyTorch versions)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def engine_config(args) -> EngineConfig:
    """The ``EngineConfig`` of parsed flags (the reference's
    ``_engine_config``; ``--sla-ms`` becomes ``sla_s``, ``--moe-capacity``
    ``moe_capacity_policy``)."""
    return EngineConfig(slots=args.slots, window=args.window,
                        sync_every=args.sync_every,
                        chunk_prefill=args.chunk_prefill,
                        sla_s=args.sla_ms / 1e3,
                        prefix_cache=args.prefix_cache,
                        preemption=args.preemption,
                        paged=False if args.no_paged else None,
                        page_size=args.page_size,
                        max_seq=args.max_seq or None,
                        pool_pages=args.pool_pages or None,
                        topology=DeviceTopology(dp=args.dp, tp=args.tp),
                        moe_capacity_policy=args.moe_capacity or None,
                        precision=PrecisionConfig(
                            kv_cache_dtype=args.kv_dtype,
                            weight_dtype=args.weight_dtype),
                        tracing=bool(args.trace_out),
                        trace_sample_n=args.trace_sample_n,
                        profile_dir=args.profile_dir or None)


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)

    cfg = get_config(args.arch)
    if not isinstance(cfg, ArchConfig):
        parser.error(f"--arch {args.arch}: not a language model; DLRM runs "
                     f"through repro_torch.core.simd.dlrm_forward (python -m "
                     f"repro_torch.examples.distributed_inference)")
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.is_encoder:
        raise SystemExit("encoder-only arch: no autoregressive serving")
    device = resolve_device(args.device)
    if args.temperature <= 0 and (args.top_k > 0 or args.top_p < 1.0):
        print("warning: --top-k/--top-p have no effect with "
              "--temperature 0 (greedy decode); pass --temperature > 0 "
              "to sample", file=sys.stderr)

    config = engine_config(args)
    grid = args.devices.split(",") if args.devices else None
    config.validate(cfg, devices=grid)
    if grid is not None:
        device = resolve_device(grid[0])
    rng = np.random.default_rng(args.seed)
    params = init_params(cfg, seed=args.seed, device=device)
    eng = ServingEngine(cfg, params, config, device=grid or device)
    device = eng.device
    card = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {card}  arch={cfg.name} layers={cfg.num_layers} "
          f"d_model={cfg.d_model} dtype={cfg.dtype}")
    if eng.mesh is not None:
        rep = eng.load_report()
        rows = "; ".join(", ".join(str(d) for d in row)
                         for row in eng.mesh.devices)
        print(f"sharded replica: mesh {eng.mesh.shape} over "
              f"[{', '.join(str(d) for d in eng.mesh.flat)}] "
              f"(data rows [{rows}]; {eng.mesh.distinct} distinct "
              f"device(s)), per-axis "
              f"collective s/tick {dict(rep.axis_collective_s)}"
              + (f", moe_capacity_policy={eng.moe_capacity_policy}"
                 if eng.moe_capacity_policy else ""))
    if not args.slots:
        print(f"admission plan: slots={eng.slots} "
              f"flush_deadline={eng.plan.flush_deadline_s*1e3:.2f}ms "
              f"(cost-model step={eng.plan.step_latency_s*1e3:.3f}ms)")
    if eng.paged:
        print(f"paged KV: page_size={eng.page_size} max_seq={eng.max_seq} "
              f"pool={eng.pool_pages} pages "
              f"({eng.allocator.capacity} usable + trash)"
              + (f", moe_capacity_policy={eng.moe_capacity_policy}"
                 if eng.moe_capacity_policy else "")
              + (f" (drop-free group {eng._moe_gmax}, slots {eng.slots})"
                 if eng._moe_gmax else ""))
    else:
        layers = (eng.cache[0] if eng.mesh is not None
                  else eng.cache)["layers"]
        rings = sorted({c["k"].shape[1] for c in layers if "k" in c})
        n_rec = sum("state" in c for c in layers)
        print(f"rolling caches: window={eng.window} KV rings of {rings} "
              f"tokens, {n_rec} recurrent states, {eng.slots} slots")
    if args.kv_dtype or args.weight_dtype:
        print(f"quantized: kv_cache_dtype={args.kv_dtype or cfg.dtype} "
              f"weight_dtype={args.weight_dtype or cfg.dtype} "
              f"kv_bytes/token="
              f"{kv_bytes_per_token(cfg, args.kv_dtype):.0f}")

    tenants = _parse_tenants(args.tenants)
    if args.overload and not tenants:
        raise SystemExit("--overload needs --tenants: the degradation "
                         "ladder defends SLO tiers")
    cluster = None
    engines = [eng]
    if args.replicas > 1 or tenants:
        # tenants take the cluster path even at one replica: the fair
        # queue, admission and ladder live at the frontend. Every replica
        # is built from the first engine's params: one set of weights
        engines += [ServingEngine(cfg, eng.params, config,
                                  device=grid or device)
                    for _ in range(args.replicas - 1)]
        # cost-model ticks price the card, not this host: floor the
        # wall-clock watchdog so a slow host never trips on modeled speed
        health_s = max(1.0, suggest_health_timeout_s(
            cfg, slots=eng.slots, context=eng.window, chip=eng.chip,
            n_chips=eng.n_chips))
        detector = (OverloadDetector(
            ttft_slo_s=(args.ttft_slo_ms / 1e3) or 1.0)
            if args.overload else None)
        cluster = ClusterFrontend(engines, policy=args.route_policy,
                                  seed=args.seed, health_timeout_s=health_s,
                                  max_retries=args.max_retries,
                                  tracing=bool(args.trace_out),
                                  tenants=tenants or None, overload=detector,
                                  breaker=(CircuitBreaker()
                                           if args.overload else None))
        print(f"cluster frontend: {len(engines)} replicas, "
              f"policy={args.route_policy}, "
              f"{'weighted-fair (DRR)' if tenants else 'EDF'} frontend "
              f"queue, health_timeout={health_s*1e3:.0f}ms "
              f"max_retries={args.max_retries}")
        if tenants:
            print("tenants: " + "  ".join(
                f"{tc.name}(tier={tc.tier} w={tc.weight:g}"
                + (f" rate={tc.rate_tokens_s:g}tok/s" if tc.rate_tokens_s
                   else "") + ")" for tc in tenants.values())
                + ("  [overload ladder armed]" if args.overload else ""))

    arrivals = np.cumsum(rng.exponential(1.0 / args.rate, args.requests))
    names = list(tenants)
    reqs = [
        Request(
            rid=i,
            tenant=names[i % len(names)] if names else "",
            prompt=rng.integers(0, cfg.vocab_size,
                                args.prompt_len).astype(np.int32),
            max_new_tokens=args.max_new,
            arrival_time=float(arrivals[i]),
            ttft_slo_s=args.ttft_slo_ms / 1e3,
            tpot_slo_s=args.tpot_slo_ms / 1e3,
            timeout_s=args.request_timeout_s,
            sampling=SamplingParams(temperature=args.temperature,
                                    top_k=args.top_k, top_p=args.top_p,
                                    seed=args.sample_seed + i),
        )
        for i in range(args.requests)
    ]
    server = cluster if cluster is not None else eng
    queue = list(reqs)
    t0 = time.time()
    done = 0
    if args.profile_dir:
        for e in engines:
            e.start_profile()
    try:
        while done < args.requests:
            now = time.time() - t0
            while queue and queue[0].arrival_time <= now:
                server.submit(queue.pop(0), now)
            done += len(server.step(time.time() - t0))
            busy = not server.idle
            if not busy and queue:
                # idle until the next arrival
                time.sleep(max(0.0,
                               queue[0].arrival_time - (time.time() - t0)))
        done += len(server.drain(time.time() - t0))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        if args.profile_dir:
            for e in engines:
                e.stop_profile()
    wall = time.time() - t0
    m = cluster.merged_metrics() if cluster is not None else eng.metrics
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
    for e in engines:
        g = e.graphs
        print(f"compiled steps: prefill_traces={e.prefill_traces} "
              f"decode_traces={e.decode_traces} (CUDA graphs captured: "
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
    if m.slo_tracked:
        print(f"SLO goodput={m.goodput:.3f} "
              f"({m.slo_met}/{m.slo_tracked} in SLO; "
              f"ttft_misses={m.ttft_slo_misses} "
              f"tpot_misses={m.tpot_slo_misses})")
    lifecycle = (m.rejected, m.cancelled, m.timed_out, m.shed, m.failed,
                 m.preempted, m.retried, m.failed_over)
    if any(lifecycle):
        print(f"lifecycle: rejected={m.rejected} cancelled={m.cancelled} "
              f"timed_out={m.timed_out} shed={m.shed} failed={m.failed} "
              f"preempted={m.preempted} (restored={m.preempt_restores}) "
              f"retried={m.retried} failed_over={m.failed_over}")
    if cluster is not None:
        for inst in cluster.instances:
            print(f"  {inst.name}: routed={inst.routed} "
                  f"utilization={inst.utilization:.2f} "
                  f"residual={inst.corrector.correction:+.3f}")
    for name, tm in sorted(m.tenants.items()):
        goodput = (f" goodput={tm.slo_met / tm.slo_tracked:.3f}"
                   if tm.slo_tracked else "")
        print(f"  tenant {name}: admitted={tm.admitted} "
              f"completed={tm.completed} tokens={tm.total_tokens} "
              f"shed={tm.shed} rejected={tm.rejected} "
              f"browned_out={tm.browned_out}"
              f"(-{tm.brownout_trimmed_tokens}tok){goodput}")
    if args.metrics_out:
        reg = (cluster.metrics_registry() if cluster is not None
               else eng.metrics_registry())
        with open(args.metrics_out, "w") as f:
            f.write(reg.exposition())
        with open(args.metrics_out + ".json", "w") as f:
            json.dump(reg.snapshot(), f, indent=2)
        print(f"metrics: {args.metrics_out} (+ .json snapshot)")
    if args.trace_out:
        doc = write_chrome_trace(args.trace_out, request_traces(reqs))
        print(f"trace: {args.trace_out} "
              f"({len(doc['traceEvents'])} events; open in "
              f"https://ui.perfetto.dev)")
    return reqs


if __name__ == "__main__":
    main()
