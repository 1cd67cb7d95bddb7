"""Train a ~30M-param member of the granite family for a few hundred
steps on synthetic structured data and watch the loss drop, with
checkpoint and restore (the twin of ``examples/train_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300 \
        [--device cpu]

The checkpoint goes to ``--ckpt`` (default: ``repro_torch_train_lm`` in
the temporary directory).
"""
import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_config
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
from repro_torch.tree import flatten


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # a small member of the granite (llama-arch) family
    cfg = dataclasses.replace(
        get_config("granite-8b"),
        num_layers=6, d_model=512, num_heads=8, num_kv_heads=4, head_dim=64,
        d_ff=1536, vocab_size=8192, dtype="float32")
    print(f"training {cfg.param_count()/1e6:.1f}M-param {cfg.arch_type} model "
          f"for {args.steps} steps on {device}")

    params = init_params(cfg, seed=0, device=device)
    opt = init_adamw(params)
    pipe = TokenPipeline(cfg.vocab_size, args.seq, args.batch, seed=0)

    t0 = time.time()
    losses = []
    for step, batch in enumerate(pipe.batches()):
        if step >= args.steps:
            break
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        params, opt, m = train_step(cfg, params, opt, batch, peak_lr=6e-4,
                                    total_steps=args.steps)
        losses.append(float(m["ce"]))
        if step % 25 == 0:
            tok_s = (step + 1) * args.batch * args.seq / (time.time() - t0)
            print(f"step {step:4d}  ce={losses[-1]:.4f}  tok/s={tok_s:,.0f}")
    save_checkpoint(args.ckpt, args.steps, params)
    print(f"ce {np.mean(losses[:10]):.3f} -> {np.mean(losses[-10:]):.3f}  "
          f"(checkpoint at {args.ckpt})")
    # restore sanity
    r = restore_into(args.ckpt, latest_step(args.ckpt), params)
    if not all(torch.equal(a, b) for (_, a), (_, b)
               in zip(flatten(r), flatten(params))):
        raise RuntimeError("the restored checkpoint differs from the params")
    print("checkpoint restore verified")


if __name__ == "__main__":
    main()
