"""The hybrid SSD / attention family with MoE MLPs (granite-4.0-h-small):
the weights in the program's parameter layout, made from the seed on the
device, and the operation counts that MFU reads.

``c`` is a configuration file's ``arch`` object; its ``block_pattern``
tiles the layers: ``ssd_moe`` (the Mamba-2 SSD mixer, then the MoE MLP)
and ``moe`` (GQA attention with no positional encoding, then the MoE
MLP). A token's operations count its routed work only: 2 x the weights
it multiplies by (every mixer projection, the router, its k experts and
the shared expert, and the tied head; never the E - k experts it skips),
the SSD layers' conv and state terms (as ``families/ssd.py``), and
attention over its real context (2 x 2 x heads x head_dim a position).
"""
from __future__ import annotations

import math

import torch

from ldsbench.weights import carve, generator, nest

NORM_STD = 0.1
CONV_BIAS_STD = 0.1


def layer_types(c) -> list:
    """Every layer's block type: the pattern tiled, its head as the
    tail."""
    pat = list(c["block_pattern"])
    n = c["num_layers"]
    return (pat * (n // len(pat) + 1))[:n]


def dims(c):
    d = c["d_model"]
    di = c["ssm_expand"] * d
    ns, p = c["ssm_state_dim"], c["ssm_head_dim"]
    hd = c["head_dim"] or d // c["num_heads"]
    return d, di, ns, di // p, p, hd


def dtype_of(c):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[c["dtype"]]


def shared_width(c) -> int:
    return c["moe_shared_d_ff"] or c["d_ff"]


def make_weights(c, seed: int, device):
    """Every leaf of the program's params from one generator on
    ``device``: projections and experts normal with std fan_in^-0.5 in
    the model dtype; the embedding with std d^-0.5 / embedding_multiplier,
    so that the scaled embedding enters the residual stream at the dense
    and SSD families' scale (at d^-0.5 the tied head would put each
    position's own token ~11 standard deviations above the rest, and a
    greedy row would repeat its last token whatever the layers compute);
    conv std 0.2, conv bias and norm scales std 0.1 (around 1 + scale);
    the router float32 (the program's); ``A_log``, ``dt_bias`` and ``D``
    float32 as ``families/ssd.py`` draws them."""
    d, di, ns, nh, _, hd = dims(c)
    v, k, e, ff = c["vocab_size"], c["conv_kernel"], c["num_experts"], c["d_ff"]
    sff = shared_width(c)
    qd, kvd = c["num_heads"] * hd, c["num_kv_heads"] * hd
    dt = dtype_of(c)
    gen = generator(seed, device)
    norm = ("normal", 0.0, NORM_STD)
    w_d = ("normal", 0.0, d ** -0.5)
    entries, f32 = [], []
    for i, bt in enumerate(layer_types(c)):
        L = ("layers", i)
        entries.append((L + ("norm1", "scale"), (d,), norm))
        if bt == "ssd_moe":
            entries += [
                (L + ("mixer", "in_proj"), (d, 2 * di + 2 * ns + nh), w_d),
                (L + ("mixer", "out_proj"), (di, d), ("normal", 0.0,
                                                      di ** -0.5)),
                (L + ("mixer", "conv_w"), (k, di + 2 * ns), ("normal", 0.0,
                                                            0.2)),
                (L + ("mixer", "norm_scale"), (di,), norm),
            ]
            if c["ssm_conv_bias"]:
                entries.append((L + ("mixer", "conv_b"), (di + 2 * ns,),
                                ("normal", 0.0, CONV_BIAS_STD)))
            f32 += [(L + ("mixer", "A_log"), (nh,), ("uniform", 1.0, 16.0)),
                    (L + ("mixer", "dt_bias"), (nh,),
                     ("uniform", math.log(1e-3), math.log(1e-1))),
                    (L + ("mixer", "D"), (nh,), ("const", 1.0, 0.0))]
        elif bt == "moe":
            entries += [
                (L + ("attn", "wq"), (d, qd), w_d),
                (L + ("attn", "wk"), (d, kvd), w_d),
                (L + ("attn", "wv"), (d, kvd), w_d),
                (L + ("attn", "wo"), (qd, d), ("normal", 0.0, qd ** -0.5)),
            ]
        else:
            raise ValueError(f"{c['name']}: block {bt!r} is not of this "
                             f"family")
        M = L + ("moe",)
        entries += [
            (L + ("norm2", "scale"), (d,), norm),
            (M + ("w_gate",), (e, d, ff), w_d),
            (M + ("w_up",), (e, d, ff), w_d),
            (M + ("w_down",), (e, ff, d), ("normal", 0.0, ff ** -0.5)),
        ]
        if c["moe_shared_expert"]:
            entries += [
                (M + ("shared", "w_gate"), (d, sff), w_d),
                (M + ("shared", "w_up"), (d, sff), w_d),
                (M + ("shared", "w_down"), (sff, d),
                 ("normal", 0.0, sff ** -0.5)),
            ]
        f32.append((M + ("router",), (d, e), w_d))
    entries += [(("final_norm", "scale"), (d,), norm),
                (("embed",), (v, d),
                 ("normal", 0.0, d ** -0.5 / c["embedding_multiplier"]))]
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


def routed_weights(c) -> int:
    """Weights a token multiplies by: each layer's mixer projections, the
    router, its k experts and the shared expert; the tied head."""
    d, di, ns, nh, _, hd = dims(c)
    qd, kvd = c["num_heads"] * hd, c["num_kv_heads"] * hd
    moe = (d * c["num_experts"] + c["experts_per_token"] * 3 * d * c["d_ff"]
           + (3 * d * shared_width(c) if c["moe_shared_expert"] else 0))
    mixer = {"ssd_moe": d * (2 * di + 2 * ns + nh) + di * d,
             "moe": 2 * d * qd + 2 * d * kvd}
    return (sum(mixer[bt] + moe for bt in layer_types(c))
            + d * c["vocab_size"])


def token_flops(c, start: int, end: int) -> float:
    """Operations of the tokens at positions [start, end) of one
    sequence, token t attending t + 1 positions in each attention
    layer."""
    n = end - start
    if n <= 0:
        return 0.0
    d, di, ns, nh, p, hd = dims(c)
    types = layer_types(c)
    n_ssd, n_attn = types.count("ssd_moe"), types.count("moe")
    ssd = 2 * c["conv_kernel"] * (di + 2 * ns) + 5 * nh * p * ns + 2 * nh * p
    ctx = (end * (end + 1) - start * (start + 1)) // 2
    return (n * (2.0 * routed_weights(c) + n_ssd * ssd)
            + n_attn * 4 * c["num_heads"] * hd * ctx)
