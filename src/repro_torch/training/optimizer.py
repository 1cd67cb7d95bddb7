"""AdamW with float32 master weights and a cosine LR schedule (the
reference's ``repro/training/optimizer.py``).

The optimizer state is a ``NamedTuple`` of the step (an int32 scalar on
the params' device) and three trees that mirror the params: the float32
master copy and the float32 first and second moments. The arithmetic is
float32 and in the reference's order: the global gradient norm, the clip
scale, then per leaf the moments, the bias-corrected update and the
decoupled weight decay on the master. ``adamw_update`` returns a new
state and leaves the old one as it is, as the reference does.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten

F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    master: dict  # float32 master copy of the params
    m: dict
    v: dict


def init_adamw(params) -> AdamWState:
    master = tree_map(lambda p: p.detach().to(F32, copy=True), params)
    m = tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device),
                 params)
    v = tree_map(torch.zeros_like, m)
    device = leaves(params)[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                      master, m, v)


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1):
    """Linear warm-up to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``min_ratio * peak_lr`` at ``total``; float32, from an
    integer step tensor."""
    step = step.to(F32)
    warm = peak_lr * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)


def adamw_update(state: AdamWState, grads, *, peak_lr: float = 3e-4,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, warmup: int = 100,
                 total: int = 10_000, grad_clip: float = 1.0):
    """Returns (new state, the gradients' global norm before clipping)."""
    step = state.step + 1
    lr = cosine_schedule(step, peak_lr=peak_lr, warmup=warmup, total=total)

    def aligned(tree):  # leaves by path, in the master tree's order
        return leaves(tree_map(lambda _, t: t, state.master, tree))

    flat_g = aligned(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                           for g in flat_g))
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    b1t = 1 - b1 ** step.to(F32)
    b2t = 1 - b2 ** step.to(F32)

    def upd(master, m, v, g):
        g = g.to(F32) * scale
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * torch.square(g)
        update = (m_new / b1t) / (torch.sqrt(v_new / b2t) + eps)
        return master - lr * (update + weight_decay * master), m_new, v_new

    out = [upd(*t) for t in zip(leaves(state.master), aligned(state.m),
                                 aligned(state.v), flat_g)]
    master, m, v = (unflatten(state.master, [o[i] for o in out])
                    for i in range(3))
    return AdamWState(step, master, m, v), gnorm


def cast_params(state: AdamWState, like_params):
    """The master weights in each param's dtype."""
    return tree_map(lambda mw, p: mw.to(p.dtype), state.master, like_params)
