"""Train step: loss, gradients, microbatch gradient accumulation, update
(the reference's ``repro/training/train.py``).

A batch is a dict of tensors on the params' device: ``tokens`` (B, S)
(or an audio arch's ``frames`` (B, S, d)), ``labels`` (B, S) with -100
masked, and on qwen2-vl ``patches`` (B, P, d) and ``positions`` (3, B,
P + S). The forward runs in train mode (``models.forward``): each layer
recomputed in backward, the attention and the RG-LRU scan through their
kernels' autograd ``Function``s on the card. Gradients come from
``torch.autograd.grad`` on detached copies of the params, which stay
plain tensors, as the reference's params stay arrays. ``parallel_block``
trains every attention block as the reference's lever of that name
(``blocks.apply_block``).
"""
from __future__ import annotations

import torch

from repro_torch.models import forward
from repro_torch.training.optimizer import (
    AdamWState,
    adamw_update,
    cast_params,
)
from repro_torch.tree import flatten, unflatten

F32 = torch.float32


def loss_fn(cfg, params, batch, *, aux_weight: float = 0.01,
            parallel_block: bool = False):
    """Next-token (or frame-label) cross entropy. labels == -100 are
    masked. Returns (ce + aux_weight * aux, (ce, aux))."""
    inputs = batch["frames"] if cfg.modality == "audio" else batch["tokens"]
    logits, aux = forward(cfg, params, inputs, mode="train",
                          patches=batch.get("patches"),
                          positions=batch.get("positions"),
                          parallel_block=parallel_block)
    labels = batch["labels"]
    if not cfg.is_encoder and cfg.modality == "text":
        logits = logits[:, :-1]
        labels = labels[:, 1:]
    elif cfg.modality == "vision_text":
        # the early-fusion prefix has no labels; logits cover [patches +
        # text]
        p = logits.shape[1] - labels.shape[1]
        logits = logits[:, p:]
        logits = logits[:, :-1]
        labels = labels[:, 1:]
    mask = labels != -100
    labels = torch.where(mask, labels, 0).to(torch.int64)
    logp = torch.log_softmax(logits.to(F32), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    n = torch.clamp(mask.sum(), min=1)
    ce = -(ll * mask).sum() / n
    return ce + aux_weight * aux, (ce, aux)


def _split(batch, accum: int):
    """The batch as ``accum`` microbatches along the batch axis: axis 1 of
    mrope's (3, B, S) ``positions``, axis 0 of everything else."""
    parts = {k: torch.chunk(v, accum, dim=1 if k == "positions" else 0)
             for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(accum)]


def grads_fn(cfg, params, batch, *, accum: int = 1,
             parallel_block: bool = False):
    """(loss, ce, grads): grads mirror params, in each param's dtype
    (float32 under ``accum`` > 1: the microbatches' mean, accumulated in
    float32)."""
    if accum > 1 and any(
            v.shape[1 if k == "positions" else 0] % accum
            for k, v in batch.items()):
        raise ValueError(f"grads_fn: the batch does not split into "
                         f"{accum} microbatches")
    flat = [p.detach().requires_grad_() for _, p in flatten(params)]
    live = unflatten(params, flat)

    def value_and_grad(b):
        with torch.enable_grad():
            loss, (ce, _) = loss_fn(cfg, live, b,
                                    parallel_block=parallel_block)
            gs = torch.autograd.grad(loss, flat, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g
              for p, g in zip(flat, gs)]
        return loss.detach(), ce.detach(), gs

    if accum <= 1:
        loss, ce, gs = value_and_grad(batch)
        return loss, ce, unflatten(params, gs)
    loss = ce = torch.zeros((), dtype=F32, device=flat[0].device)
    acc = [torch.zeros(p.shape, dtype=F32, device=p.device) for p in flat]
    for mb in _split(batch, accum):
        l_mb, ce_mb, gs = value_and_grad(mb)
        acc = [a + g.to(F32) for a, g in zip(acc, gs)]
        loss, ce = loss + l_mb, ce + ce_mb
    inv = 1.0 / accum
    return loss * inv, ce * inv, unflatten(params, [g * inv for g in acc])


def train_step(cfg, params, opt_state: AdamWState, batch, *, accum: int = 1,
               peak_lr: float = 3e-4, total_steps: int = 10_000,
               parallel_block: bool = False):
    """One optimizer step. Returns (params, opt_state, metrics), metrics
    {"loss", "ce", "grad_norm"} as 0-d tensors."""
    loss, ce, grads = grads_fn(cfg, params, batch, accum=accum,
                               parallel_block=parallel_block)
    opt_state, gnorm = adamw_update(opt_state, grads, peak_lr=peak_lr,
                                    total=total_steps)
    params = cast_params(opt_state, params)
    return params, opt_state, {"loss": loss, "ce": ce, "grad_norm": gnorm}
