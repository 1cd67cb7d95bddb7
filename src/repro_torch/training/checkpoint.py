"""Checkpointing: flat-key npz save and restore of the port's trees (the
reference's ``repro/training/checkpoint.py``).

A tree (params, or an ``AdamWState``) is flattened to ``path/to/leaf``
keys (``tree.flatten``: ``layers/0/attn/wq``, ``master/final_norm/scale``,
``step``); ``params_{step}.npz`` holds the params, ``opt_{step}.npz`` the
optimizer state, ``meta.json`` the last step saved. numpy has no
bfloat16, so a bfloat16 leaf is stored as its bits in uint16 (no other
leaf of the port is uint16) and restored bit for bit.
"""
from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from repro_torch.tree import flatten, unflatten


def _to_numpy(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _to_tensor(a, device):
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def _save(file, tree):
    np.savez(file, **{k: _to_numpy(v) for k, v in flatten(tree)})


def save_checkpoint(path: str, step: int, params, opt_state=None,
                    extra: dict = None):
    os.makedirs(path, exist_ok=True)
    _save(os.path.join(path, f"params_{step}.npz"), params)
    if opt_state is not None:
        _save(os.path.join(path, f"opt_{step}.npz"), opt_state)
    meta = {"step": step, **(extra or {})}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def latest_step(path: str) -> int:
    if not os.path.isdir(path):
        return -1
    steps = [
        int(m.group(1))
        for f in os.listdir(path)
        if (m := re.match(r"params_(\d+)\.npz", f))
    ]
    return max(steps) if steps else -1


def restore_into(path: str, step: int, template, *, opt: bool = False):
    """Restore step ``step``'s params (``opt``: its optimizer state) into
    the structure of ``template``, a tree of tensors: each leaf must have
    its template leaf's shape and dtype, and lands on its device."""
    name = f"opt_{step}.npz" if opt else f"params_{step}.npz"
    with np.load(os.path.join(path, name)) as data:
        out = []
        for key, leaf in flatten(template):
            t = _to_tensor(data[key], leaf.device)
            if t.shape != leaf.shape or t.dtype != leaf.dtype:
                raise ValueError(f"checkpoint {name}: {key} is "
                                 f"{tuple(t.shape)} {t.dtype}, the "
                                 f"template {tuple(leaf.shape)} "
                                 f"{leaf.dtype}")
            out.append(t)
    return unflatten(template, out)
