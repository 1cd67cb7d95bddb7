"""The benchmark's one command:

    python3 ldsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with the cards the cell
asks for. Prints the result as the last line of standard output (one
JSON object) and each number the correctness check compared, beside its
limit, as the last lines of standard error. Exits non-zero, printing no
result, without CUDA or with fewer cards than the cell needs, without
the program (``src/repro_torch``), or when JAX or the JAX package was
loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "ldsbench" / "out"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    # build caches of the program's tool chains stay inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(OUT / sub)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from ldsbench import guard
    from ldsbench.harness import load_cell, run_cell

    _, cell, _, _ = load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("ldsbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"ldsbench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), root=ROOT, t_start=T_START)
    bad = guard.forbidden_modules()
    if bad:
        print(f"ldsbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    s = result["samples"]
    print(f"samples: ttft {s['ttft']}, tpot {s['tpot']}, tokens in window "
          f"{s['tokens_in_window']}, requests {result['attempted']}, step "
          f"graphs captured inside the window {s['captures_in_window']}",
          file=sys.stderr)
    print("window host time: " + json.dumps(s["host"]), file=sys.stderr)
    print("readings: " + json.dumps(result["readings"]), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
