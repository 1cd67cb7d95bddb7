"""Weights carried across from the JAX package.

``params_from_jax(cfg, tree, device)`` takes the reference's parameter
pytree as nested dicts/lists of NUMPY arrays (a test builds it with
``jax.tree.map(np.asarray, repro.models.init_params(cfg, key))``) and
returns the port's params. ``body`` leaves carry a leading ``n_repeat``
axis (one slice per scanned repeat); they are unstacked into one dict per
layer, in scan order. Weight matrices keep the reference's (in, out)
orientation, so no transpose is needed. A quantized tree
(``repro.models.quantize_weights``) converts the same way: its
``{"w_q", "scale"}`` leaves map leaf by leaf, and a body scale
(n_repeat, 1, N) is unstacked like its weight. RG-LRU and SSD blocks
carry their ``mixer`` leaves the same way, float32 ones as float32
(RG-LRU's ``Lambda``, ``b_a``, ``b_x``; SSD's ``A_log``, ``D``,
``dt_bias``) under any model dtype, and MoE blocks their ``moe`` leaves:
the float32 ``router`` (d, E), the expert stacks ``w_gate`` / ``w_up``
(E, d, ff) and ``w_down`` (E, ff, d), and a ``shared`` expert's MLP.
An audio arch's tree has no ``embed`` (hubert-xlarge), and a tree of
gradients (``jax.grad`` of a loss) converts like its params.

``cache_from_jax(cfg, tree, device)`` does the same for the reference's
rolling cache (``init_cache`` or a prefill's output: rings, RG-LRU and
SSD conv windows and states, ``pos``), so tests can hold the port's
caches to it; ``dlrm_params_from_jax(tree, device)`` for the reference's
DLRM weights (``core/simd/embedding.py``'s ``init_dlrm``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.model import block_program
from repro_torch.tree import tree_map


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret bits
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def _layers(cfg, tree, device):
    """The per-layer list, in scan order, of a {"body", "tail"} tree."""
    pattern, n_repeat, _ = block_program(cfg)
    layers = []
    for r in range(n_repeat):
        for j in range(len(pattern)):
            layers.append(tree_map(lambda a, r=r: _tensor(
                np.asarray(a)[r], device), tree["body"][j]))
    for blk in tree["tail"]:
        layers.append(tree_map(lambda a: _tensor(a, device), blk))
    return layers


def params_from_jax(cfg, tree, device="cuda"):
    device = resolve_device(device)
    out = {"layers": _layers(cfg, tree, device),
           "final_norm": tree_map(lambda a: _tensor(a, device),
                                  tree["final_norm"])}
    for name in ("embed", "lm_head"):
        if name in tree:
            out[name] = _tensor(tree[name], device)
    return out


def cache_from_jax(cfg, tree, device="cuda"):
    device = resolve_device(device)
    return {"layers": _layers(cfg, tree, device),
            "pos": _tensor(tree["pos"], device).to(torch.int32)}


def dlrm_params_from_jax(tree, device="cuda"):
    """The reference's ``init_dlrm`` tree (tables (T, R, E), ``bottom`` and
    ``top`` lists of {"w", "b"}) as the port's (``core/simd/embedding.py``:
    the same layout, float32)."""
    device = resolve_device(device)
    return tree_map(lambda a: _tensor(a, device), tree)
