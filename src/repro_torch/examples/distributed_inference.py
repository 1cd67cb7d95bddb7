"""SIMD example: inference of a model too large for one host (survey §4),
the twin of ``examples/distributed_inference.py``: DLRM embedding
inference (Fig. 7) run for real with its tables row-split over a device
grid (``shard_specs``; the reference's local mesh is one device by
default, and so is ``--tp``), plus the capacity and latency scale-out
sweep at production size from the cost model at H100 numbers.

    PYTHONPATH=src python -m repro_torch.examples.distributed_inference \
        [--device cpu] [--tp 2 --devices cpu,cpu]

``--tp N`` takes the host's first N cards, or the ``--devices`` grid (a
device may repeat); on the CPU the grid is ``--device`` N times.
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs.dlrm import CONFIG as DLRM
from repro_torch.core.costmodel import WorkEstimate
from repro_torch.core.hardware import H100_SXM, Chip
from repro_torch.core.simd import (
    dlrm_forward,
    init_dlrm,
    lookup_traffic_bytes,
    shard_specs,
)
from repro_torch.core.simd.sharding import Shards, place
from repro_torch.launch.mesh import make_local_mesh

BATCH = 256


def scale_out_estimate(n_nodes: int, *, chip: Chip = H100_SXM) -> dict:
    """The tables sharded over ``n_nodes`` cards (the reference's
    ``benchmarks/fig7_dlrm.py`` estimate): whether a shard fits 0.8 of a
    card's memory, the cost model's latency of one batch, and the share
    of it the lookups' fan-out traffic takes."""
    table_bytes = DLRM.embedding_params() * 4.0
    per_node = table_bytes / n_nodes
    fits = per_node <= 0.8 * chip.hbm_bytes
    mlp_flops = 2.0 * DLRM.mlp_params() * BATCH
    # each node scans its shard of lookups; traffic = gathered rows
    traffic = (lookup_traffic_bytes(DLRM, BATCH) * (n_nodes - 1)
               / max(n_nodes, 1))
    est = WorkEstimate(
        flops=mlp_flops,
        hbm_bytes=per_node + BATCH * DLRM.num_tables * DLRM.multi_hot
        * DLRM.embed_dim * 4.0 / n_nodes,
        collective_bytes=traffic,
        chip=chip,
        n_chips=n_nodes,
    )
    return {"fits": fits, "latency_s": est.latency_s,
            "comm_share": (est.collective_s / est.latency_s
                           if est.latency_s else 0)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--tp", type=int, default=1,
                    help="shards the tables' rows are split over")
    ap.add_argument("--devices", default="",
                    help="the grid, comma-separated (a device may repeat)")
    args = ap.parse_args(argv)
    grid = (args.devices.split(",") if args.devices
            else [args.device] * args.tp if args.device == "cpu" else None)
    mesh = make_local_mesh(model=args.tp, devices=grid)

    # --- real execution (scaled-down tables, one card) ---------------------
    cfg = dataclasses.replace(DLRM, num_tables=8, rows_per_table=4096,
                              embed_dim=32, bottom_mlp=(64, 32),
                              top_mlp=(64, 1))
    params = init_dlrm(cfg, 0, mesh.flat[0])
    params = Shards(place(params, shard_specs(cfg), mesh), mesh)
    rng = np.random.default_rng(0)
    batch = {
        "dense": torch.from_numpy(
            rng.standard_normal((64, 13)).astype(np.float32)).to(
                mesh.flat[0]),
        "sparse": torch.from_numpy(
            rng.integers(0, cfg.rows_per_table,
                         (64, cfg.num_tables, cfg.multi_hot))).to(
                mesh.flat[0]),
    }
    out = dlrm_forward(cfg, params, batch)
    print(f"sharded DLRM inference, tables row-split over "
          f"[{', '.join(str(d) for d in mesh.flat)}]: batch=64 -> "
          f"logits {tuple(out.shape)}, mean={float(out.mean()):.4f}")

    # --- production-size capacity sweep (cost model) -----------------------
    table_gb = DLRM.embedding_params() * 4 / 1e9
    print(f"\nproduction DLRM: {table_gb:.0f} GB of embeddings "
          f"({DLRM.num_tables} tables x {DLRM.rows_per_table:,} rows)")
    print(f"one {H100_SXM.name} card holds {H100_SXM.hbm_bytes / 1e9:.0f} "
          f"GB -> capacity-driven scale-out (survey Fig. 7):")
    for n in (1, 4, 16, 64):
        r = scale_out_estimate(n)
        print(f"  nodes={n:3d}: {'fits' if r['fits'] else 'OOM '} "
              f"latency={r['latency_s'] * 1e6:9.1f}us "
              f"comm_share={r['comm_share']:.2f}")


if __name__ == "__main__":
    main()
