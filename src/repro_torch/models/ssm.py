"""State-space pieces of the PyTorch port (the JAX package's
``repro/models/ssm.py``): the depthwise causal convolution that the RG-LRU
block shares with Mamba-2, and the Mamba-2 SSD (state-space duality)
mixer [arXiv:2405.21060].

Chunked SSD: within each chunk a quadratic (attention-like) intra-chunk
term; chunk-to-chunk states propagate through a linear scan. Decode
carries O(1) state: the conv window and a per-head SSM state (H, P, N).
Shapes follow the paper: d_inner = expand * d_model, heads = d_inner /
head_dim, a scalar A per head, B and C of state size N shared across
heads. The reference computes it in plain JAX (no Pallas kernel); so does
the port's chunked scan, in PyTorch ops, float32 throughout as there. The
decode step goes through ``ops.ssd_step`` (on the card one hand-written
kernel that reads and writes each float32 state element once; on the CPU
its plain version). The cache is updated IN PLACE: a captured CUDA graph
keeps reading the tensors it was captured with.

``apply_ssd_sharded`` runs the mixer over the shards of a tensor-parallel
group under the reference's bit-exact serving layout: ``in_proj`` split
by output column, everything else (conv, the SSD scan and step, the
gated norm, ``out_proj``) whole on every shard, over the whole state.
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L

F32 = torch.float32


def causal_conv(x, conv_w, conv_state=None, activation=None, bias=None):
    """Depthwise causal conv over time (the reference's ``_causal_conv``).
    x (B, S, C); conv_w (K, C); ``bias`` (C,), when given, is added
    before the activation. ``conv_state`` (B, K-1, C), when given, is
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
    if bias is not None:
        out = out + bias
    if activation is not None:
        out = activation(out)
    return out, new_state


def init_ssd(cfg, gen, dtype, device):
    """Random weights, scaled as the reference's init; ``A_log``, ``D``
    and ``dt_bias`` are float32 under any model dtype, as there. Not the
    reference's bits: parity tests convert its weights."""
    d = cfg.d_model
    di, ns, nh = cfg.d_inner, cfg.ssm_state_dim, cfg.ssm_num_heads

    def normal(shape, std):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=F32) * std
        return w.to(dtype)

    in_dim = 2 * di + 2 * ns + nh  # z, x, B, C, dt
    p = {
        "in_proj": normal((d, in_dim), d ** -0.5),
        "out_proj": normal((di, d), di ** -0.5),
        "conv_w": normal((cfg.conv_kernel, di + 2 * ns), 0.2),
        "A_log": torch.zeros((nh,), dtype=F32, device=device),
        "D": torch.ones((nh,), dtype=F32, device=device),
        "dt_bias": torch.zeros((nh,), dtype=F32, device=device),
        "norm_scale": torch.zeros((di,), dtype=dtype, device=device),
    }
    if cfg.ssm_conv_bias:
        p["conv_b"] = torch.zeros((di + 2 * ns,), dtype=dtype, device=device)
    return p


def _split_proj(cfg, xz):
    """The in-projection's (z, xBC, dt) lanes."""
    di, ns = cfg.d_inner, cfg.ssm_state_dim
    e = 2 * di + 2 * ns
    return xz[..., :di], xz[..., di:e], xz[..., e:]


def ssd_chunked(x, dt, A, B, C, D, chunk: int):
    """Chunked SSD from a zero state, as the reference's. x (b, S, H, P);
    dt (b, S, H) >= 0 float32; A (H) < 0; B, C (b, S, N); D (H). Returns
    y (b, S, H, P) in x's dtype and the final state (b, H, P, N) float32.

    S is padded to a chunk multiple with dt = 0 (decay 1) and zero input
    on the pad steps, so the state and the real outputs are unaffected.
    The reference's three-operand einsums are written as an elementwise
    product and a batched matmul over the contracted axis, so no (b, c,
    i, j, h, p) temporary is ever built (about 4.3 GB at mamba2's full
    width for a 1024-token prompt)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    chunk = min(chunk, s)
    s_orig = s
    if s % chunk:
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
        s += pad
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, h, p).to(F32)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, n).to(F32)
    Cc = C.reshape(b, nc, chunk, n).to(F32)

    # log-decay per step (< 0), cumulative within the chunk, heads first:
    # (b, nc, h, c)
    cums = torch.cumsum(dtc * A, dim=2).transpose(2, 3)
    # weight each source token by dt, heads first: (b, nc, h, c, p)
    xin = (xc * dtc[..., None]).permute(0, 1, 3, 2, 4)

    # --- intra-chunk (quadratic): L[i, j] = exp(cums_i - cums_j), j <= i
    seg = cums[..., :, None] - cums[..., None, :]  # (b, nc, h, i, j)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()
    Lmat = torch.where(tri, torch.exp(seg), 0.0)
    CB = torch.matmul(Cc, Bc.transpose(-1, -2))  # (b, nc, i, j)
    y = torch.matmul(Lmat * CB[:, :, None], xin)  # (b, nc, h, i, p)

    # --- chunk states: sum_j B_j decay(j..end) xin_j -> (b, nc, h, p, n)
    decay_to_end = torch.exp(cums[..., -1:] - cums)  # (b, nc, h, c)
    S_c = torch.matmul((xin * decay_to_end[..., None]).transpose(-1, -2),
                       Bc[:, :, None])

    # --- inter-chunk scan: the state entering each chunk
    chunk_decay = torch.exp(cums[..., -1])  # (b, nc, h)
    hstate = torch.zeros((b, h, p, n), dtype=F32, device=x.device)
    h_enter = []
    for c in range(nc):
        h_enter.append(hstate)
        hstate = hstate * chunk_decay[:, c, :, None, None] + S_c[:, c]
    h_enter = torch.stack(h_enter, dim=1)  # (b, nc, h, p, n)

    # --- inter-chunk output: y += C_i decay(0..i) h_enter
    y_inter = torch.matmul(Cc[:, :, None], h_enter.transpose(-1, -2))
    y = y + y_inter * torch.exp(cums)[..., None]

    y = y.permute(0, 1, 3, 2, 4) + D[:, None] * xc  # (b, nc, c, h, p)
    y = y.reshape(b, s, h, p)[:, :s_orig]
    return y.to(x.dtype), hstate


def _ssd_mix(cfg, p, x, xz, cache, in_place: bool = True):
    """The SSD mixer's output from the in-projection ``xz``: (out (B, S,
    d), the new conv window, the new state). ``cache`` is read, and
    written only by a decode step with ``in_place``, which puts the new
    state into ``cache["state"]`` and returns that tensor; without, the
    step's state is a fresh tensor."""
    di, ns = cfg.d_inner, cfg.ssm_state_dim
    nh, hd = cfg.ssm_num_heads, cfg.ssm_head_dim
    b, s, _ = x.shape
    z, xbc, dt = _split_proj(cfg, xz)
    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = causal_conv(xbc, p["conv_w"], conv_state,
                                activation=F.silu, bias=p.get("conv_b"))
    xs = xbc[..., :di].reshape(b, s, nh, hd)
    B = xbc[..., di:di + ns]
    C = xbc[..., di + ns:]

    if s == 1 and cache is not None:
        # --- one decode step: h = h * exp(dt A) + B (x dt), y = C h + D x
        y, state = ops.ssd_step(cache["state"], xs[:, 0], B[:, 0], C[:, 0],
                                dt[:, 0], p["dt_bias"], p["A_log"], p["D"],
                                in_place=in_place)
        y = y.reshape(b, 1, di)
    else:
        dt = L.softplus(dt.to(F32) + p["dt_bias"])
        A = -torch.exp(p["A_log"])
        y4, state = ssd_chunked(xs, dt, A, B, C, p["D"], cfg.ssm_chunk)
        y = y4.reshape(b, s, di)

    y = L.rmsnorm(y.to(x.dtype) * F.silu(z), p["norm_scale"], cfg.norm_eps)
    return torch.matmul(y, p["out_proj"]), new_conv, state


def apply_ssd(cfg, p, x, *, cache=None):
    """The SSD mixer. x (B, S, d) -> y (B, S, d). ``cache`` {"conv": (B,
    K-1, C), "state": (B, H, P, N) float32} or None (a prefill from
    nothing); when given, its conv window is prepended, and it is then
    overwritten in place with the new window and state. S = 1 with a
    cache is one decode step from the cached state; otherwise the chunked
    scan runs from a zero state, as the reference's does. The one-shard
    case of ``apply_ssd_sharded``."""
    return apply_ssd_sharded(
        cfg, [p], [x], caches=None if cache is None else [cache])[0]


def apply_ssd_sharded(cfg, ps, xs, *, caches=None):
    """``apply_ssd`` over the n shards of a tensor-parallel group (lists,
    one entry per shard; ``xs`` and ``caches`` whole on every shard): each
    shard projects its column block of ``in_proj``; the blocks are
    concatenated on every shard before ``_split_proj`` (a block may span
    the z / xBC / dt boundaries), and the rest of the mixer runs whole
    from the shard's whole conv window and state. Every shard reads its
    cache before any shard writes, so shards may share one cache tensor:
    with more than one shard a decode step writes its state into a fresh
    tensor, copied into the cache after every shard has run; with one, it
    writes the cache's state in place. Returns the outputs (B, S, d) per
    shard."""
    from repro_torch.models.blocks import gather

    blks = [torch.matmul(x, p["in_proj"]) for x, p in zip(xs, ps)]
    split = blks[0].shape[-1] < ps[0]["conv_w"].shape[1] + cfg.d_inner \
        + cfg.ssm_num_heads
    mix = _ssd_mix if len(ps) == 1 else partial(_ssd_mix, in_place=False)
    mixed = [mix(cfg, p, x, gather(blks, x.device) if split else blks[j],
                 None if caches is None else caches[j])
             for j, (x, p) in enumerate(zip(xs, ps))]
    if caches is not None:
        for c, (_, new_conv, state) in zip(caches, mixed):
            c["conv"].copy_(new_conv)
            if state is not c["state"]:
                c["state"].copy_(state)
    return [out for out, _, _ in mixed]


def init_ssd_cache(cfg, batch: int, dtype, device):
    """Zeroed decode cache: the conv window (B, K-1, d_inner + 2N) in the
    model dtype and the SSM state (B, H, P, N) float32."""
    di, ns = cfg.d_inner, cfg.ssm_state_dim
    return {"conv": torch.zeros((batch, cfg.conv_kernel - 1, di + 2 * ns),
                                dtype=dtype, device=device),
            "state": torch.zeros((batch, cfg.ssm_num_heads,
                                  cfg.ssm_head_dim, ns), dtype=F32,
                                 device=device)}
