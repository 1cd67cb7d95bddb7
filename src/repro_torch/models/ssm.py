"""State-space pieces of the PyTorch port (the JAX package's
``repro/models/ssm.py``). So far only the depthwise causal convolution
that the RG-LRU block shares with Mamba-2; the SSD mixer comes with the
mamba2 slice (ROADMAP.md queue 1)."""
from __future__ import annotations

import torch


def causal_conv(x, conv_w, conv_state=None, activation=None):
    """Depthwise causal conv over time (the reference's ``_causal_conv``).
    x (B, S, C); conv_w (K, C). ``conv_state`` (B, K-1, C), when given, is
    prepended (decode / streaming); otherwise K-1 zeros. Returns (out (B,
    S, C) in x's dtype, new state: the last K-1 inputs)."""
    k = conv_w.shape[0]
    s = x.shape[1]
    if conv_state is None:
        pad = torch.zeros(x.shape[:1] + (k - 1,) + x.shape[2:],
                          dtype=x.dtype, device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+K-1, C)
    out = xp[:, 0:s] * conv_w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * conv_w[i]
    new_state = xp[:, -(k - 1):] if k > 1 else None
    if activation is not None:
        out = activation(out)
    return out, new_state
