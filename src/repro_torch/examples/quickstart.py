"""Quickstart: every quadrant of the survey's taxonomy in a minute, on the
port (the twin of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs import get_config, get_shape
from repro_torch.core import Deployment, estimate, executor_for
from repro_torch.models import init_params
from repro_torch.serving import EngineConfig, Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # --- an assigned architecture, reduced to a toy size ------------------
    cfg = get_config("granite-8b").reduced()
    print(f"model: {cfg.name} ({cfg.arch_type}), "
          f"{cfg.param_count() / 1e6:.1f}M params (reduced)")

    # --- SISD: single-instance serving with continuous batching -----------
    params = init_params(cfg, seed=0, device=args.device)
    eng = ServingEngine(cfg, params, EngineConfig(slots=2, window=64),
                        device=args.device)
    reqs = [Request(i, np.arange(8 + i, dtype=np.int32), max_new_tokens=6)
            for i in range(3)]
    queue, t = list(reqs), 0.0
    while queue or eng.n_active:
        while queue and eng.try_admit(queue[0], t):
            queue.pop(0)
        eng.step(t)
        t += 1.0
    print(f"SISD: served {eng.metrics.completed} requests, "
          f"tokens={eng.metrics.total_tokens}")

    # --- the taxonomy at production scale (full config, cost model) -------
    full = get_config("granite-8b")
    for dep in (Deployment(full.name, 1, 1), Deployment(full.name, 4, 1),
                Deployment(full.name, 1, 256), Deployment(full.name, 8, 256)):
        p = dep.paradigm
        print(f"{p.name}: I={dep.n_instances} D={dep.n_devices} -> "
              f"{executor_for(p)}")

    # --- roofline for one assigned shape ----------------------------------
    est = estimate(full, get_shape("decode_32k"), n_chips=256)
    print(f"decode_32k on 256 {est.chip.name} cards: "
          f"compute={est.compute_s * 1e3:.2f}ms "
          f"memory={est.memory_s * 1e3:.2f}ms -> "
          f"bottleneck={est.bottleneck}")


if __name__ == "__main__":
    main()
