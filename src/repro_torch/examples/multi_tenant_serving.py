"""MISD example: multi-tenant serving with spatial meshlets and temporal
scheduling (survey §3), on the port's cost model at H100 numbers (the twin
of ``examples/multi_tenant_serving.py``): partition a grid of 256 cards
for three tenant models, then co-schedule a mixed query stream with each
scheduler and compare.

    PYTHONPATH=src python -m repro_torch.examples.multi_tenant_serving

The whole example is the cost model and the simulator: nothing runs on a
device, so ``--device`` (accepted as by the other examples) changes
nothing.
"""
import argparse
import copy

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.costmodel import estimate_decode, stream_occupancy
from repro_torch.core.misd import (
    SCHEDULERS,
    Device,
    Job,
    MeshPartitioner,
    MISDSimulator,
    adaptive_batch_size,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="accepted for a uniform command line; unused")
    ap.parse_args(argv)
    tenants = [
        {"name": "chat", "cfg": get_config("chatglm3-6b"), "batch": 16,
         "context": 4096, "sla_s": 0.05},
        {"name": "code", "cfg": get_config("granite-8b"), "batch": 8,
         "context": 8192, "sla_s": 0.08},
        {"name": "vision", "cfg": get_config("qwen2-vl-7b"), "batch": 8,
         "context": 4096, "sla_s": 0.10},
    ]

    # --- spatial: gpulet-style meshlet partitioning ------------------------
    part = MeshPartitioner((16, 16))
    plan = part.plan(tenants)
    print(f"meshlet plan ({part.chip.name} cards):")
    for m in plan.meshlets:
        users = [k for k, v in plan.assignment.items() if v == m.name]
        print(f"  {m.name}: {m.shape[0]}x{m.shape[1]} = {m.n_chips} chips "
              f"-> {users}")

    # --- adaptive batching per tenant --------------------------------------
    for t in tenants:
        mesh_name = plan.assignment[t["name"]]
        chips = next(m.n_chips for m in plan.meshlets if m.name == mesh_name)
        b, lat = adaptive_batch_size(t["cfg"], context=t["context"],
                                     sla_s=t["sla_s"], n_chips=chips)
        print(f"  {t['name']}: adaptive batch={b} "
              f"(step {lat * 1e3:.1f}ms <= SLA {t['sla_s'] * 1e3:.0f}ms)")

    # --- temporal: scheduler comparison on one shared meshlet --------------
    rng = np.random.default_rng(0)
    jobs = []
    t_arr = 0.0
    for i in range(200):
        ten = tenants[int(rng.integers(3))]
        est = estimate_decode(ten["cfg"], 8, ten["context"], n_chips=64)
        t_arr += float(rng.exponential(est.latency_s / 2.5))
        jobs.append(Job(i, ten["name"], est.demand_at(stream_occupancy(8)),
                        est.latency_s, arrival=t_arr,
                        priority=5 if ten["name"] == "chat" else 0,
                        sla_s=est.latency_s * 5))
    print("\nscheduler comparison (one 64-chip meshlet, 4 tenants max):")
    for name, cls in SCHEDULERS.items():
        res = MISDSimulator([Device("meshlet", max_tenants=4)],
                            cls()).run(copy.deepcopy(jobs))
        print(f"  {name:20s} qps={res.qps:7.1f} "
              f"jct={res.mean_jct() * 1e3:7.1f}ms "
              f"p99={res.p99_latency() * 1e3:7.1f}ms "
              f"sla={res.sla_attainment():.2f}")


if __name__ == "__main__":
    main()
