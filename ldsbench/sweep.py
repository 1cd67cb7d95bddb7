"""The open-loop rate sweep that sets a cell's offered load, on the card:

    python3 ldsbench/sweep.py --workload granite-8b.chat \
        --rates 3,3.5,4,4.5 --seeds 1,2 [--seconds <s>]

One engine, warmed once; each rate and seed gets a fresh window of the
cell's own traffic at that rate: the mix as committed (its
``schedule_seed`` fixes sizes and arrivals, the seed draws the tokens),
``run_seconds`` long by default, and the mix's grace, so every request
runs to its end. Prints a line per rate and seed: tokens/s inside the
window, TTFT p50 / p95 over all requests, the requests sent 5 s or more
before the close that still wait for their first token at the close,
and the TTFT p50 of the first and of the last quarter of sends.

The backlog grows at a rate where, on some seed, a request sent 5 s
before the close still waits at the close, or the last quarter's TTFT
p50 exceeds 1.5 x the first quarter's (``grows``; the first quarter
starts from an empty engine). The cell's rate is 0.8 x
the highest rate at which it grows on no seed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args()

    import importlib

    import torch

    from ldsbench import traffic
    from ldsbench.harness import (build_engine, drive, load_cell, load_json,
                                  warm)
    from ldsbench.stats import percentile

    _, cell, conf, mix = load_cell(ROOT, args.workload)
    seconds = args.seconds or load_json(ROOT / "BENCHMARK.json")["run_seconds"]
    family = importlib.import_module(f"ldsbench.families.{conf['family']}")
    arch = conf["arch"]
    dev = torch.device("cuda")
    seeds = [int(s) for s in args.seeds.split(",")]
    params = family.make_weights(arch, seeds[0], dev)
    eng = build_engine(arch, mix, params, dev, tracing=False)
    clock = time.perf_counter

    def p50(xs):
        return 1e3 * (percentile(xs, 50) or 0.0)

    for rate in (float(r) for r in args.rates.split(",")):
        for seed in seeds:
            m = copy.deepcopy(mix)
            m["rate_per_s"] = rate
            tr = traffic.build(m, arch["vocab_size"], seed, seconds)
            warm(eng, tr, m, clock)  # ends in reset(): a fresh engine
            recs, t0, t1 = drive(eng, tr, m, seconds, clock)
            recs = sorted(recs, key=lambda r: r.due)
            ttft = [r.first - r.due for r in recs if r.first is not None]
            waiting = sum(1 for r in recs if r.sent <= t1 - 5.0
                          and (r.first is None or r.first > t1))
            n = len(recs)
            early = [r.first - r.due for r in recs[:n // 4]
                     if r.first is not None]
            late = [r.first - r.due for r in recs[3 * n // 4:]
                    if r.first is not None]
            print(json.dumps({
                "rate": rate, "seed": seed, "sent": n,
                "unfinished": sum(1 for r in recs if r.first is None
                                  or r.failed),
                "tokens_per_s": sum(r.n_win for r in recs) / seconds,
                "ttft_p50_ms": p50(ttft),
                "ttft_p95_ms": 1e3 * (percentile(ttft, 95) or 0.0),
                "waiting_at_close": waiting,
                "ttft_p50_first_quarter_ms": p50(early),
                "ttft_p50_last_quarter_ms": p50(late),
                "grows": bool(waiting or p50(late) > 1.5 * p50(early))}),
                flush=True)
    print(f"total {time.perf_counter() - T0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
