"""The Mamba-2 SSD family (mamba2-1.3b): the weights in the program's
parameter layout, made from the seed on the device, and the operation
counts that MFU reads.

A token's operations: its matrix products (2 x the weights it touches:
``in_proj``, ``out_proj`` and the tied head), the depthwise conv (2 x
kernel x channels), and the SSD state terms of the recurrent form, per
head: the decay and the input's outer product into the (P, N) state
(3 P N), its read-out by C (2 P N) and the D skip (2 P). Nothing depends
on the context length.
"""
from __future__ import annotations

import math

import torch

from ldsbench.weights import carve, generator, nest

NORM_STD = 0.1


def dims(c):
    d = c["d_model"]
    di = c["ssm_expand"] * d
    ns, p = c["ssm_state_dim"], c["ssm_head_dim"]
    return d, di, ns, di // p, p


def dtype_of(c):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[c["dtype"]]


def make_weights(c, seed: int, device):
    """Every leaf of the program's SSD params from one generator on
    ``device``: the model dtype for projections, conv and norms;
    float32 ``A_log`` (log U(1, 16)), ``dt_bias`` (inverse softplus of
    dt = exp U(log 1e-3, log 1e-1)) and ``D`` (ones), as the paper's
    code initialises them."""
    d, di, ns, nh, _ = dims(c)
    v, k = c["vocab_size"], c["conv_kernel"]
    dt = dtype_of(c)
    gen = generator(seed, device)
    norm = ("normal", 0.0, NORM_STD)
    entries, f32 = [], []
    for i in range(c["num_layers"]):
        L = ("layers", i)
        entries += [
            (L + ("norm1", "scale"), (d,), norm),
            (L + ("mixer", "in_proj"), (d, 2 * di + 2 * ns + nh),
             ("normal", 0.0, d ** -0.5)),
            (L + ("mixer", "out_proj"), (di, d), ("normal", 0.0, di ** -0.5)),
            (L + ("mixer", "conv_w"), (k, di + 2 * ns), ("normal", 0.0, 0.2)),
            (L + ("mixer", "norm_scale"), (di,), norm),
        ]
        f32 += [(L + ("mixer", "A_log"), (nh,), ("uniform", 1.0, 16.0)),
                (L + ("mixer", "dt_bias"), (nh,),
                 ("uniform", math.log(1e-3), math.log(1e-1))),
                (L + ("mixer", "D"), (nh,), ("const", 1.0, 0.0))]
    entries += [(("final_norm", "scale"), (d,), norm),
                (("embed",), (v, d), ("normal", 0.0, d ** -0.5))]
    flat = carve(entries, gen, device, dt)
    more = carve(f32, gen, device, torch.float32)
    for path, t in more.items():
        if path[-1] == "A_log":
            t.log_()
        elif path[-1] == "dt_bias":  # dt + log(-expm1(-dt)), dt = exp(u)
            t.exp_()
            t.add_(torch.log(-torch.expm1(-t)))
    flat.update(more)
    return nest(flat)


def matmul_weights(c) -> int:
    d, di, ns, nh, _ = dims(c)
    per_layer = d * (2 * di + 2 * ns + nh) + di * d
    return c["num_layers"] * per_layer + d * c["vocab_size"]


def token_flops(c, start: int, end: int) -> float:
    """Operations of the tokens at positions [start, end) of one
    sequence (the same for every position)."""
    n = end - start
    if n <= 0:
        return 0.0
    d, di, ns, nh, p = dims(c)
    per_layer = (2 * c["conv_kernel"] * (di + 2 * ns) + 5 * nh * p * ns
                 + 2 * nh * p)
    return n * (2.0 * matmul_weights(c) + c["num_layers"] * per_layer)
