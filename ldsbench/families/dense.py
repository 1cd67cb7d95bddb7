"""The dense GQA decoder family (granite-8b): the weights in the
program's parameter layout, made from the seed on the device, and the
operation and byte counts that MFU and the paged-decode roofline read.

``c`` is a configuration file's ``arch`` object. Counts are of the
model's useful work: a token's matrix products (2 x the weights it
touches, the head included) plus attention over its real context
(2 x 2 x heads x head_dim a position: the scores and the P V product).
"""
from __future__ import annotations

import torch

from ldsbench.weights import carve, generator, nest

NORM_STD = 0.1


def dims(c):
    d = c["d_model"]
    hd = c["head_dim"] or d // c["num_heads"]
    return d, hd, c["num_heads"] * hd, c["num_kv_heads"] * hd, c["d_ff"]


def dtype_of(c):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[c["dtype"]]


def make_weights(c, seed: int, device):
    """Every leaf of the program's dense params, bf16 (the config's
    dtype), from one generator on ``device``."""
    d, hd, qd, kvd, ff = dims(c)
    v = c["vocab_size"]
    w_in, w_o, w_ff = (("normal", 0.0, d ** -0.5), ("normal", 0.0, qd ** -0.5),
                       ("normal", 0.0, ff ** -0.5))
    norm = ("normal", 0.0, NORM_STD)
    entries = []
    for i in range(c["num_layers"]):
        L = ("layers", i)
        entries += [
            (L + ("norm1", "scale"), (d,), norm),
            (L + ("attn", "wq"), (d, qd), w_in),
            (L + ("attn", "wk"), (d, kvd), w_in),
            (L + ("attn", "wv"), (d, kvd), w_in),
            (L + ("attn", "wo"), (qd, d), w_o),
            (L + ("norm2", "scale"), (d,), norm),
            (L + ("mlp", "w_gate"), (d, ff), w_in),
            (L + ("mlp", "w_up"), (d, ff), w_in),
            (L + ("mlp", "w_down"), (ff, d), w_ff),
        ]
    entries += [(("final_norm", "scale"), (d,), norm),
                (("embed",), (v, d), w_in)]
    if not c["tie_embeddings"]:
        entries.append((("lm_head",), (d, v), w_in))
    return nest(carve(entries, generator(seed, device), device,
                      dtype_of(c)))


def matmul_weights(c) -> int:
    """Weights a token multiplies by: every projection and the head."""
    d, hd, qd, kvd, ff = dims(c)
    per_layer = d * qd + 2 * d * kvd + qd * d + 3 * d * ff
    return c["num_layers"] * per_layer + d * c["vocab_size"]


def attn_flops_per_position(c) -> int:
    _, hd, _, _, _ = dims(c)
    return c["num_layers"] * 4 * c["num_heads"] * hd


def token_flops(c, start: int, end: int) -> float:
    """Operations of the tokens at positions [start, end) of one
    sequence, token t attending t + 1 positions."""
    n = end - start
    if n <= 0:
        return 0.0
    ctx = (end * (end + 1) - start * (start + 1)) // 2
    return 2.0 * matmul_weights(c) * n + attn_flops_per_position(c) * ctx


def paged_decode_cost(c, n_valid, itemsize: int = 2):
    """(bytes, operations) of one paged-decode launch (one layer, one
    tick) over the live slots' valid context lengths ``n_valid``: each
    valid K and V byte read once, each slot's q read and o written once;
    2 x 2 x head_dim operations per (query head, position)."""
    _, hd, qd, kvd, _ = dims(c)
    ctx = sum(int(n) for n in n_valid)
    nbytes = (ctx * 2 * kvd + len(n_valid) * 2 * qd) * itemsize
    flops = ctx * 4 * c["num_heads"] * hd
    return float(nbytes), float(flops)
