"""Dry run of the port (the JAX package's ``repro/launch/dryrun.py``): for
every (arch x input shape) on a (data, model) grid, the step's memory per
device, FLOPs and the bytes its shards gather, from shapes alone: every
tensor lies on the meta device, so nothing is allocated and no card is
needed.

    python -m repro_torch.launch.dryrun --arch granite-8b \\
        --shape decode_32k --tp 4
    python -m repro_torch.launch.dryrun --all --dp 2 --tp 2 --opt kv_int8

Each combination's record (JSON, ``--out``, by default
``results/dryrun_torch/<arch>__<shape>__dp<M>_tp<N>[__<opts>].json``):

- ``arg_bytes_per_device``: the step's arguments (params, the batch; the
  AdamW state when training, the decode cache when decoding) per device
  under ``make_policy``'s layout (the reference's dry-run layout, FSDP
  where the weights outgrow half a card), by ``sharded_bytes``;
  ``served_arg_bytes_per_device`` the same under ``serving_policy``, the
  layout a sharded ``ServingEngine`` places (prefill and decode shapes);
  ``fits_h100`` whether each is within one H100's 80 GB.
- ``flops``: the step's FLOPs over every shard, as
  ``torch.utils.flop_counter.FlopCounterMode`` counts the plain path on
  the meta device: matmuls, einsums and batched products, plus the plain
  bf16 decode attention's score chain (``addcmul``, 2 FLOPs an element);
  elementwise work is not counted. Prefill and decode run the port's
  serving steps (``prefill_step``, ``serve_step``) over the sharded
  replica, so the redundant work of the bit-exact layout (every shard's
  whole _ROW products) counts; training, an encoder's forward, a vision
  arch's prefill (its patches) and ``parallel_block`` run on one card, the
  only place the port runs them (``count`` says which).
- ``gathered_bytes_per_device``: the bytes the sharded forward's
  concatenations bring each shard from the others (``blocks.gather``),
  averaged over the shards: the port's counterpart of the reference's
  HLO collective bytes; null on one card.

``--opt`` takes ``kv_seq`` (the policy's ``kv_shard="seq"``: the decode
cache split on its sequence in ``arg_bytes_per_device``; the port serves
only its kv-head layout, which the count keeps), ``kv_int8`` (int8 decode
rings and their scales) and ``parallel_block`` (the reference's fused
attention + MLP block); any other lever of the reference's
``sharding_hints`` only pins an XLA layout and is refused.

No counterpart: the reference's 256- and 512-chip production meshes
(the port's grid is the cards of one host, which the meta device stands
in for), XLA's ``memory_analysis`` of a compiled module (the port has no
compiler pass: the argument bytes are the memory record), and the
affine probe that extrapolates an unrolled compile's counts from 2 and 4
repeats (the port counts every layer of the real depth).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (
    ArchConfig,
    all_configs,
    applicable_shapes,
    get_config,
)
from repro_torch.configs.base import get_shape
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.simd.sharding import (
    Spec,
    batch_pspecs,
    cache_pspecs,
    make_policy,
    opt_pspecs,
    param_pspecs,
    serving_policy,
)
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.specs import (
    decode_cache_specs,
    decode_window,
    input_specs,
    opt_state_specs,
)
from repro_torch.models import param_specs, shard_cache, shard_params
from repro_torch.models.blocks import count_gathers
from repro_torch.tree import tree_map

RESULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "..", "..", "..", "results", "dryrun_torch")
#: the levers the port's dry run takes (``--opt``)
OPTS = ("kv_seq", "kv_int8", "parallel_block")


def _addcmul_flops(self_shape, t1, t2, *args, out_shape=None, **kwargs):
    return 2 * int(np.prod(out_shape))


#: FLOP formulas beyond FlopCounterMode's own: the plain bf16 decode
#: attention's score chain (one multiply-add an element a step)
CUSTOM_FLOPS = {torch.ops.aten.addcmul: _addcmul_flops,
                torch.ops.aten.addcmul_: _addcmul_flops}


def meta_mesh(dp: int = 1, tp: int = 1) -> Mesh:
    """A (data, model) grid whose every device is the meta device."""
    grid = np.empty((dp, tp), dtype=object)
    for idx in np.ndindex(grid.shape):
        grid[idx] = torch.device("meta")
    return Mesh(("data", "model"), grid)


def sharded_bytes(tree, spec_tree, mesh) -> float:
    """Per-device bytes of a tree laid out by ``spec_tree`` (each leaf's
    bytes over the product of the mesh axes that split it): the
    reference's ``sharded_bytes``. ``mesh`` is anything with
    ``axis_names`` and a ``devices`` array."""
    axes = dict(zip(mesh.axis_names, np.shape(mesh.devices)))
    total = []

    def one(leaf, spec: Spec):
        denom = 1
        for entry in spec:
            if entry is None:
                continue
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                denom *= axes.get(a, 1)
        total.append(leaf.numel() * leaf.element_size() / denom)
        return leaf

    tree_map(one, tree, spec_tree)
    return float(sum(total))


def _policy(cfg, mesh, opts, *, serving: bool):
    pol = (serving_policy(cfg, mesh) if serving
           else make_policy(cfg, mesh, chip=H100_SXM))
    if "kv_seq" in opts:
        pol = dataclasses.replace(pol, kv_shard="seq")
    return pol


def arg_bytes(cfg, shape, mesh, opts, *, serving: bool) -> float:
    """The step's argument bytes per device under the reference's
    (``serving`` False) or the serving layout."""
    pol = _policy(cfg, mesh, opts, serving=serving)
    params = param_specs(cfg)
    batch = input_specs(cfg, shape)
    total = (sharded_bytes(params, param_pspecs(cfg, params, pol), mesh)
             + sharded_bytes(batch, batch_pspecs(cfg, batch, pol, mesh),
                             mesh))
    if shape.kind == "train":
        opt = opt_state_specs(cfg, params)
        total += sharded_bytes(opt, opt_pspecs(cfg, opt, pol), mesh)
    elif shape.kind == "decode":
        cache = decode_cache_specs(
            cfg, shape, kv_dtype="int8" if "kv_int8" in opts else "")
        total += sharded_bytes(cache, cache_pspecs(cfg, cache, pol, mesh),
                               mesh)
    return total


def _one_card(cfg, shape, mesh, opts) -> bool:
    """Whether the step runs on one card in the port (no sharded form)."""
    n = int(np.prod(np.shape(mesh.devices)))
    return (n == 1 or shape.kind == "train" or cfg.is_encoder
            or (cfg.modality == "vision_text" and shape.kind == "prefill")
            or "parallel_block" in opts)


def _step(cfg, shape, mesh, opts):
    """The function whose work is counted, and its label."""
    from repro_torch.models import forward
    from repro_torch.serving.engine import prefill_step, serve_step
    from repro_torch.training.train import train_step

    params = param_specs(cfg)
    batch = input_specs(cfg, shape)
    pb = "parallel_block" in opts
    if _one_card(cfg, shape, mesh, opts):
        where = "one card"
    else:
        params = shard_params(cfg, params, mesh)
        where = "sharded forward"
    if shape.kind == "train":
        opt = opt_state_specs(cfg, params)

        return (lambda: train_step(cfg, params, opt, batch,
                                   parallel_block=pb)), where
    if shape.kind == "prefill":
        if cfg.is_encoder or cfg.modality != "text" or pb:
            inputs = (batch["frames"] if cfg.modality == "audio"
                      else batch["tokens"])
            return (lambda: forward(cfg, params, inputs,
                                    patches=batch.get("patches"),
                                    positions=batch.get("positions"),
                                    parallel_block=pb)), where
        return (lambda: prefill_step(cfg, params, batch["tokens"],
                                     window=shape.seq_len)), where
    cache = decode_cache_specs(cfg, shape,
                               kv_dtype="int8" if "kv_int8" in opts else "")
    if where == "sharded forward":
        cache = shard_cache(cfg, cache, mesh, paged=False)
    else:
        cache = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                               device="meta"), cache)
    if pb:
        from repro_torch.models import decode_step

        return (lambda: decode_step(cfg, params, cache, batch["tokens"],
                                    positions=batch.get("positions"),
                                    parallel_block=True)), where
    return (lambda: serve_step(cfg, params, cache, batch["tokens"])), where


def count(cfg, shape, mesh, opts=frozenset()) -> dict:
    """The step's FLOPs (every shard's) and the bytes its concatenations
    gather, counted on the meta device."""
    fn, where = _step(cfg, shape, mesh, opts)
    grad = torch.enable_grad() if shape.kind == "train" \
        else torch.no_grad()
    with grad, count_gathers() as moved, FlopCounterMode(
            display=False, custom_mapping=CUSTOM_FLOPS) as fc:
        fn()
    n = int(np.prod(np.shape(mesh.devices)))
    sharded = where == "sharded forward"
    return {"flops": float(fc.get_total_flops()),
            "flops_per_device": float(fc.get_total_flops()) / n,
            "count": where,
            "gathered_bytes_per_device": (moved["bytes"] / n if sharded
                                          else None),
            "gather_calls": moved["calls"] if sharded else None}


def run_one(arch: str, shape_name: str, *, dp: int = 1, tp: int = 1,
            opts=frozenset(), out_dir=None, reduced: bool = False) -> dict:
    """One combination's record, written to ``out_dir`` when given.
    ``reduced``: the arch's ``reduced()`` config (a quick check)."""
    bad = sorted(set(opts) - set(OPTS))
    if bad:
        raise ValueError(f"--opt {bad}: the port's dry run takes {OPTS}; "
                         f"the reference's other levers pin XLA layouts "
                         f"and have no PyTorch counterpart")
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    shape = get_shape(shape_name)
    mesh = meta_mesh(dp, tp)
    t0 = time.perf_counter()
    ref_bytes = arg_bytes(cfg, shape, mesh, opts, serving=False)
    served = (arg_bytes(cfg, shape, mesh, opts, serving=True)
              if shape.kind != "train" else None)
    hbm = H100_SXM.hbm_bytes
    rec = {"arch": cfg.name, "shape": shape.name, "kind": shape.kind,
           "batch": shape.global_batch, "seq_len": shape.seq_len,
           "mesh": {"data": dp, "model": tp}, "n_devices": dp * tp,
           "ok": True, "opts": sorted(opts), "reduced": reduced,
           "decode_window": (decode_window(cfg, shape.seq_len)
                             if shape.kind == "decode" else None),
           "arg_bytes_per_device": ref_bytes,
           "served_arg_bytes_per_device": served,
           "hbm_bytes": hbm,
           "fits_h100": ref_bytes <= hbm and (served is None
                                              or served <= hbm),
           "params": cfg.param_count(),
           "active_params": cfg.active_param_count()}
    rec.update(count(cfg, shape, mesh, opts))
    rec["seconds"] = time.perf_counter() - t0
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = "".join(f"__{t}" for t in sorted(opts)
                      + (["reduced"] if reduced else []))
        path = os.path.join(out_dir, f"{cfg.name}__{shape.name}__dp{dp}_"
                                     f"tp{tp}{tag}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def _fmt(rec) -> str:
    g = rec["gathered_bytes_per_device"]
    return (f"{rec['arch']:26s} {rec['shape']:12s} dp{rec['mesh']['data']}"
            f" tp{rec['mesh']['model']} arg/dev="
            f"{rec['arg_bytes_per_device'] / 1e9:.3f}GB"
            + (f" served/dev={rec['served_arg_bytes_per_device'] / 1e9:.3f}"
               f"GB" if rec["served_arg_bytes_per_device"] is not None
               else "")
            + f" fits_h100={rec['fits_h100']} flops={rec['flops']:.4e}"
            f" ({rec['count']}) gathered/dev="
            + ("-" if g is None else f"{g:.4e}B"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true",
                    help="every arch x its applicable shapes")
    ap.add_argument("--tp", type=int, default=1,
                    help="the grid's 'model' axis")
    ap.add_argument("--dp", type=int, default=1,
                    help="the grid's 'data' axis")
    ap.add_argument("--reduced", action="store_true",
                    help="each arch's reduced() config (a quick check)")
    ap.add_argument("--opt", default="",
                    help=f"comma list of levers: {','.join(OPTS)}")
    ap.add_argument("--out", default=RESULTS_DIR,
                    help="directory of the JSON records")
    args = ap.parse_args(argv)
    opts = frozenset(x for x in args.opt.split(",") if x)
    bad = sorted(opts - set(OPTS))
    if bad:
        ap.error(f"--opt {bad}: the port's dry run takes {list(OPTS)}; "
                 f"the reference's other levers pin XLA layouts and have "
                 f"no PyTorch counterpart")
    if args.all:
        combos = [(name, s.name) for name, cfg in all_configs().items()
                  if isinstance(cfg, ArchConfig)
                  for s in applicable_shapes(cfg)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        combos = [(args.arch, args.shape)]
    failures = 0
    for arch, shape_name in combos:
        try:
            rec = run_one(arch, shape_name, dp=args.dp, tp=args.tp,
                          opts=opts, out_dir=args.out, reduced=args.reduced)
            print(f"[ok]   {_fmt(rec)} ({rec['seconds']:.1f}s)", flush=True)
        except Exception as e:  # a failed combination is recorded
            failures += 1
            print(f"[FAIL] {arch} {shape_name}: {type(e).__name__}: {e}",
                  flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
