"""Training CLI of the PyTorch port (the reference's
``repro/launch/train.py``): AdamW on the synthetic token pipeline, with
npz checkpoints.

    python -m repro_torch.launch.train --arch granite-8b --steps 200 \
        --batch 8 --seq 256 --reduced --device cpu

runs on the GPU by default (``--device cuda``; it raises when there is
no CUDA device); ``--device cpu --reduced`` runs the plain PyTorch path on
the CPU. Weights are random, from ``--seed``. ``--ckpt DIR`` saves the
params and the optimizer state every ``--ckpt-every`` steps and at the
end, and a rerun resumes from the latest step found there (params and
optimizer state both; the reference restores the params alone, into an
optimizer whose master copy still holds the fresh weights). An audio arch
(hubert-xlarge) is refused: the pipeline makes tokens, and hubert takes
frames (``repro_torch.training.synthetic_batch``).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.configs import ArchConfig, get_config
from repro_torch.core.device import resolve_device
from repro_torch.models import init_params
from repro_torch.training import (
    TokenPipeline,
    init_adamw,
    latest_step,
    restore_into,
    save_checkpoint,
    train_step,
)
from repro_torch.tree import leaves


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    cfg = get_config(args.arch)
    if not isinstance(cfg, ArchConfig):
        parser.error(f"--arch {args.arch}: not a language model")
    if cfg.modality == "audio":
        parser.error(f"--arch {args.arch}: an audio arch takes frame "
                     f"embeddings, and this CLI's pipeline makes tokens; "
                     f"train it through repro_torch.training.train_step "
                     f"on synthetic_batch's frames")
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    print(f"arch={cfg.name} params will be "
          f"{cfg.param_count()/1e6:.1f}M ({cfg.arch_type})")

    params = init_params(cfg, seed=args.seed, device=device)
    n_par = sum(p.numel() for p in leaves(params))
    print(f"materialized {n_par/1e6:.2f}M params on {device}")

    start = 0
    opt = None
    if args.ckpt:
        s = latest_step(args.ckpt)
        if s >= 0:
            params = restore_into(args.ckpt, s, params)
            if os.path.exists(os.path.join(args.ckpt, f"opt_{s}.npz")):
                opt = restore_into(args.ckpt, s, init_adamw(params),
                                   opt=True)
            start = s
            print(f"restored step {s}")
    if opt is None:
        opt = init_adamw(params)

    pipe = TokenPipeline(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    t0 = time.time()
    losses = []
    for step, batch in enumerate(pipe.batches(start), start=start):
        if step >= args.steps:
            break
        if cfg.modality == "vision_text":
            b, s = batch["tokens"].shape
            batch["positions"] = np.broadcast_to(
                np.arange(s, dtype=np.int32), (3, b, s)).copy()
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        params, opt, metrics = train_step(
            cfg, params, opt, batch, accum=args.accum, peak_lr=args.lr,
            total_steps=args.steps)
        losses.append(float(metrics["ce"]))
        if step % args.log_every == 0:
            dt = time.time() - t0
            tok_s = (step - start + 1) * args.batch * args.seq / max(dt, 1e-9)
            print(f"step {step:5d}  ce={losses[-1]:.4f}  "
                  f"gnorm={float(metrics['grad_norm']):.3f}  "
                  f"tok/s={tok_s:,.0f}")
        if args.ckpt and step and step % args.ckpt_every == 0:
            save_checkpoint(args.ckpt, step, params, opt)
    if args.ckpt and losses:
        save_checkpoint(args.ckpt, args.steps, params, opt)
    if not losses:
        print(f"done: nothing to train (step {start} of {args.steps})")
        return
    first = np.mean(losses[:10]) if len(losses) >= 10 else losses[0]
    last = np.mean(losses[-10:])
    print(f"done: ce {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")


if __name__ == "__main__":
    main()
