"""Readings for the correctness limits, on the card, in one process:

    python3 ldsbench/control.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--seconds <s>]

runs the cell (the benchmark's own run, at the cell's own load and
sizes) on each seed and prints, per seed, one JSON line with the
program's readings (``greedy_gap``, ``sampled_gap``, ``sampled_z``, ...)
and its ``correct``. On the control seeds the fp8 control (the reference
computed in float8, the precision below the configuration's bfloat16)
takes the program's place, its tokens scored as the program's, and its
``correct`` is printed beside the program's; so are the readings of the
planted sampler faults ("top", "hot") and of the float32 reference's own
draws ("ref"), in ``harness.STAND_INS``. The limits in
``limits/<cell>.json`` are set between the largest program reading and
the smallest reading of the control or a fault.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args()

    import torch

    from ldsbench.harness import STAND_INS, is_correct, load_json, run_cell

    spec = load_json(ROOT / "BENCHMARK.json")
    seconds = args.seconds or spec["run_seconds"]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        on = seed in ctrl
        out = run_cell(args.workload, seed, seconds, False, root=ROOT,
                       t_start=t, control="fp8" if on else None,
                       also=STAND_INS if on else ())
        gc.collect()
        torch.cuda.empty_cache()
        limits = {k: c["limit"] for k, c in out["checks"].items()}
        of = out.get("readings_of", {"program": out["readings"]})
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": {k: is_correct(r, limits)
                                      for k, r in of.items()},
                          "readings": of,
                          "metrics": {k: v["value"] for k, v in
                                      out["metrics"].items()},
                          "seconds": time.perf_counter() - t}), flush=True)
    print(f"total {time.perf_counter() - T0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
