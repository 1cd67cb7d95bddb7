"""Plain PyTorch versions of the port's hand-written kernels: the int8
matmul, prefill (optionally windowed) and (rolling, paged, int8) decode
attention, the RG-LRU scan, the Mamba-2 SSD decode step, the sampler and
the MoE experts over token-sorted rows.
They are the torch twins of the JAX package's ``repro.models.layers``
functions of the same names, and ``repro_torch.models.layers`` re-exports
them; the SSD step is the ``s == 1`` branch of the reference's
``repro.models.ssm.apply_ssd``, used by ``repro_torch.models.ssm``. Each
kernel wrapper calls its plain version for CPU tensors, and
``chip_smoke.py`` holds each kernel against it on the card. This module
imports nothing of the port, so the kernel layer does not depend on the
model layer.

Arithmetic as in ``repro_torch.models.layers``: matmul products of the
model dtype accumulate in float32, softmax statistics are float32, masked
scores are ``-1e30`` (not ``-inf``) and probabilities are cast to the
query dtype before the PV product. Decode attention over bf16 caches
keeps those roundings over float64 sums (``decode_attention``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F32 = torch.float32
F64 = torch.float64
NEG = -1e30
_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Weight-only int8 matmul (plain version of kernels/int8_matmul)
# ---------------------------------------------------------------------------


def int8_matmul(x, w_q, scale):
    """Plain version of kernels/int8_matmul (the dict path of the
    reference's ``layers.linear``): float32 product of x (M, K) and the
    int8 codes (K, N), times the per-column scale AFTER the dot, cast once
    to x's dtype."""
    y = torch.matmul(x.to(F32), w_q.to(F32))
    return (y * scale.reshape(-1).to(F32)).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention — prefill (plain version of kernels/flash_attention)
# ---------------------------------------------------------------------------


def dense_attention(q, k, v, *, causal: bool, window: int = 0):
    """Plain masked attention. q (B,Sq,H,D), k/v (B,Skv,Hkv,D); q head h
    reads kv head ``h // G``. ``window`` > 0 masks keys further than
    ``window`` behind the query (``kpos > qpos - window`` is kept). Scores
    and softmax in float32, probabilities cast to ``q.dtype`` before PV,
    output in ``q.dtype``."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.to(F32).reshape(b, sq, hkv, g, d)
    scale = d ** -0.5
    scores = torch.einsum("bqcgd,bkcd->bcgqk", qg, k.to(F32)) * scale
    if causal or window:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        scores = scores.masked_fill(~mask, NEG)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bcgqk,bkcd->bqcgd", probs.to(q.dtype).to(F32),
                       v.to(F32))
    return out.reshape(b, sq, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Attention — decode against a rolling or paged KV cache
# ---------------------------------------------------------------------------


def decode_attention(q, k_cache, v_cache, pos):
    """q (B,S,H,D); k/v_cache (B,W,Hkv,D); pos (B,) = tokens written
    INCLUDING the S queries: query i of S sees ``pos - S + 1 + i`` slots
    (capped at W). Grouped-GQA contraction, as the reference.

    float32 q: float32 arithmetic throughout. A narrower q (bf16) keeps
    the twin's roundings in orders any implementation can follow: each
    score one float32 chain over d = 0, 1, ..., D - 1 (the products of
    bf16 values are exact, so each step rounds once), then the softmax
    sum and P V in float64 (exp values and exact products, whose float64
    sums round alike in any order), probabilities rounded to q's dtype,
    the output to float32 and then q's dtype. The bf16 paged kernel
    (``csrc/decode_sm90.cuh`` ``twin_kernel``) computes the same."""
    b, w, hkv, d = k_cache.shape
    sq, h = q.shape[1], q.shape[2]
    g = h // hkv
    pos = torch.as_tensor(pos, device=q.device).to(torch.int64)
    pos = pos.reshape(-1).expand(b)
    n_valid = torch.clamp(
        pos[:, None] - (sq - 1)
        + torch.arange(sq, device=q.device)[None, :], max=w)  # (B, S)
    valid = (torch.arange(w, device=q.device)[None, None, None, None, :]
             < n_valid[:, None, None, :, None])
    if q.dtype != F32:
        # (B, kv, G, S, D) queries against (B, kv, 1, 1, W) keys, d by d
        qd = q.to(F32).reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4)
        kd = k_cache.to(F32).permute(0, 2, 3, 1)[:, :, None, None]
        scores = torch.zeros((b, hkv, g, sq, w), dtype=F32, device=q.device)
        for i in range(d):
            scores.addcmul_(qd[..., i, None], kd[..., i, :])
        scores = (scores * (d ** -0.5)).masked_fill(~valid, -math.inf)
        e = torch.exp(scores.to(F64)
                      - scores.amax(dim=-1, keepdim=True).to(F64))
        probs = (e / e.sum(dim=-1, keepdim=True)).to(F32).to(q.dtype)
        out = torch.einsum("bcgqw,bwcd->bqcgd", probs.to(F64),
                           v_cache.to(F64))
        return out.to(F32).to(q.dtype).reshape(b, sq, h, d)
    qg = q.to(F32).reshape(b, sq, hkv, g, d)
    scale = d ** -0.5
    scores = torch.einsum("bqcgd,bwcd->bcgqw", qg, k_cache.to(F32)) * scale
    scores = scores.masked_fill(~valid, NEG)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bcgqw,bwcd->bqcgd", probs.to(q.dtype).to(F32),
                       v_cache.to(F32))
    return out.to(q.dtype).reshape(b, sq, h, d)


def paged_decode_attention(q, k_pool, v_pool, page_table, pos):
    """Decode attention through a paged KV cache (plain version of
    kernels/decode_attention): gathers each slot's pages into a linear
    (B, n_pages*ps, Hkv, D) view and runs ``decode_attention`` on it, so
    garbage in unwritten slots is hidden by the same validity mask."""
    b = q.shape[0]
    _, ps, hkv, d = k_pool.shape
    n_pages = page_table.shape[1]
    idx = page_table.to(torch.int64)
    k = k_pool[idx].reshape(b, n_pages * ps, hkv, d)
    v = v_pool[idx].reshape(b, n_pages * ps, hkv, d)
    return decode_attention(q, k, v, pos)


def paged_decode_attention_int8(q, k_pool, v_pool, k_scale, v_scale,
                                page_table, pos):
    """Over int8 pools (plain version of kernels/decode_attention's int8
    kernel): gathers values and their (P, ps, Hkv, 1) float32 scales
    through the page table, dequantizes as ``(code * scale)`` rounded to
    q's dtype and runs the same masked softmax as
    ``paged_decode_attention``."""
    b = q.shape[0]
    _, ps, hkv, d = k_pool.shape
    n_pages = page_table.shape[1]
    idx = page_table.to(torch.int64)

    def gather(pool, scale):
        deq = (pool[idx].to(F32) * scale[idx]).to(q.dtype)
        return deq.reshape(b, n_pages * ps, hkv, d)

    return decode_attention(q, gather(k_pool, k_scale),
                            gather(v_pool, v_scale), pos)


# ---------------------------------------------------------------------------
# RG-LRU linear recurrence (plain version of kernels/rglru_scan)
# ---------------------------------------------------------------------------


def rglru_scan(a, x, h0):
    """``h_t = a_t * h_{t-1} + x_t`` in float32, walked in time order as
    the Pallas kernel walks it (the semantics of the reference's
    ``ref_rglru_scan``, whose associative scan sums in another order).
    a, x (B, S, L); h0 (B, L). Returns (y (B, S, L), h_S (B, L)), float32.
    No step writes in place, so autograd differentiates it in O(S) (the
    backward of the scan kernel's autograd ``Function``)."""
    af, xf = a.to(F32), x.to(F32)
    h = h0.to(F32)
    ys = []
    for t in range(af.shape[1]):
        h = af[:, t] * h + xf[:, t]
        ys.append(h)
    return torch.stack(ys, dim=1), h


# ---------------------------------------------------------------------------
# Mamba-2 SSD decode step (plain version of kernels/ssd_step)
# ---------------------------------------------------------------------------


def ssd_step(state, x, B, C, dt, dt_bias, A_log, D, *, in_place: bool):
    """One SSD decode step, the reference's ``s == 1`` branch of
    ``apply_ssd``: ``h = h * exp(dt A) + B (x dt)``, ``y = C h + D x``,
    float32 throughout. state (b, H, P, N) float32; x (b, H, P), B, C (b,
    N), dt (b, H) in the model dtype (dt before its softplus); dt_bias,
    A_log, D (H,) float32. Returns (y (b, H, P) rounded to x's dtype, the
    new state): ``in_place`` copies it into ``state`` and returns that."""
    dt = dt.to(F32) + dt_bias
    dt = torch.logaddexp(dt, torch.zeros_like(dt))  # jax.nn.softplus
    A = -torch.exp(A_log)
    dA = torch.exp(dt * A)  # (b, H)
    x0 = x.to(F32)  # (b, H, P)
    xin = x0 * dt[..., None]
    new = (state * dA[..., None, None]
           + xin[..., None] * B.to(F32)[:, None, None, :])
    y = torch.matmul(new, C.to(F32)[:, None, :, None])[..., 0]
    y = y + D[:, None] * x0
    if in_place:
        new = state.copy_(new)
    return y.to(x.dtype), new


# ---------------------------------------------------------------------------
# MoE experts over token-sorted rows (plain version of kernels/moe_grouped)
# ---------------------------------------------------------------------------


def moe_grouped(x, order, offsets, w_gate, w_up, w_down, *, k: int,
                variant: str):
    """Each (token, expert) pair's expert MLP, the pairs sorted by expert:
    row p is token ``order[p] // k`` of x (T, d), and expert e owns rows
    ``offsets[e]:offsets[e + 1]`` (offsets (E + 1,) int32). One product per
    expert over its rows: ``act(x w_gate) * (x w_up)`` (``variant``
    "swiglu": silu; "geglu": tanh gelu) or ``gelu(x w_up)`` ("gelu", no
    ``w_gate``), then ``w_down``; (E, d, ff) / (E, ff, d) stacks. Returns
    ys (R, d) in x's dtype, in sorted order. The per-expert counts are read
    to the host: a CPU tensor's."""
    counts = (offsets[1:] - offsets[:-1]).tolist()
    rows = x[order // k]
    ys = torch.empty_like(rows)
    lo = 0
    for j, n in enumerate(counts):
        if n:
            r = rows[lo:lo + n]
            if variant in ("swiglu", "geglu"):
                g = torch.matmul(r, w_gate[j])
                act = (F.silu(g) if variant == "swiglu"
                       else F.gelu(g, approximate="tanh"))
                h = act * torch.matmul(r, w_up[j])
            else:
                h = F.gelu(torch.matmul(r, w_up[j]), approximate="tanh")
            ys[lo:lo + n] = torch.matmul(h, w_down[j])
            lo += n
    return ys


# ---------------------------------------------------------------------------
# Sampler (plain version of kernels/topk_sample)
# ---------------------------------------------------------------------------


def _float_bits_descending(x):
    """Order-isomorphic unsigned image of float32, held in int64 (torch on
    the CPU has no right shift for uint32): bigger float <=> bigger value.
    ``+ 0.0`` canonicalizes -0.0 first."""
    bits = (x.to(F32) + 0.0).view(torch.int32).to(torch.int64) & _U32
    return torch.where((bits >> 31) == 0, bits | 0x80000000, (~bits) & _U32)


def _radix_threshold(weights, mapped, target):
    """Per row, the largest mapped value t with ``sum(weights where mapped
    >= t) >= target``: 32 rounds of MSB-first bit building."""
    t = torch.zeros(weights.shape[0], dtype=torch.int64,
                    device=weights.device)
    zero = torch.zeros((), dtype=weights.dtype, device=weights.device)
    for b in range(32):
        cand = t | (1 << (31 - b))
        acc = torch.where(mapped >= cand[:, None], weights, zero).sum(-1)
        t = torch.where(acc >= target, cand, t)
    return t


def _restricted_probs(x, top_k, top_p):
    """Both cuts as thresholds over ONE logit-bit image: the k-th largest
    logit by a count radix, then the nucleus boundary by a mass radix over
    the restricted softmax weights. Rows without a cut (top_k <= 0,
    top_p >= 1) keep everything, as the reference's batch-wide skip does.
    Returns (keep mask, softmax weights with 0 outside the mask).

    Every sum over the row is taken in float64 (the softmax denominator,
    rounded once to float32, and the mass radix's sums): a float32 sum
    depends on its order, which the kernel cannot share with PyTorch's
    reductions (at 256000 logits, 1 draw in 128 differed); in float64 the
    order moves the result by about 1e-16, so both give the same tokens.
    The weights stay float32, as the reference's."""
    v = x.shape[1]
    mapped = _float_bits_descending(x)
    k = torch.where(top_k > 0, torch.clamp(top_k, 1, v),
                    torch.full_like(top_k, v)).to(F32)
    kth = _radix_threshold(torch.ones_like(x), mapped, k)
    keep = mapped >= kth[:, None]
    e = torch.exp(x - torch.amax(x, dim=-1, keepdim=True))
    z = torch.sum(e, dim=-1, keepdim=True, dtype=F64).to(F32)
    w = torch.where(keep, e / z, torch.zeros_like(x))
    target = (torch.clamp(top_p.to(F32), 1e-30, 1.0).to(F64)
              * w.sum(-1, dtype=F64))
    pth = _radix_threshold(w.to(F64), mapped, target)
    keep = keep & ((mapped >= pth[:, None]) | (top_p >= 1.0)[:, None])
    return keep, torch.where(keep, w, torch.zeros_like(w))


def process_logits(logits, temperature, top_k, top_p):
    """Temperature scale, then top-k and top-p restriction; removed entries
    come back ``-inf``."""
    x = logits.to(F32) / torch.clamp(temperature.to(F32), min=1e-6)[:, None]
    keep, _ = _restricted_probs(x, top_k, top_p)
    return torch.where(keep, x, torch.full_like(x, -math.inf))


def sample_tokens(logits, greedy, temperature, top_k, top_p, uniform):
    """Engine-facing masked composition: greedy rows take argmax (lowest
    index on ties); stochastic rows draw one token from the temperature-
    scaled, top-k/top-p-restricted softmax by inverse CDF with ONE uniform
    per row, ``min(u*total, nextafter(total, 0))`` against the cumulative
    masked weights (summed in float64, as every sum of
    ``_restricted_probs``). logits (B, V); greedy (B,) bool; temperature,
    top_p, uniform (B,) float32; top_k (B,) int. Returns (B,) int32."""
    last = logits.to(F32)
    greedy_tok = torch.argmax(last, dim=-1)
    x = last / torch.clamp(temperature.to(F32), min=1e-6)[:, None]
    _, pk = _restricted_probs(x, top_k, top_p)
    c = torch.cumsum(pk, dim=-1, dtype=F64)
    total = c[:, -1]
    thresh = torch.minimum(uniform.to(F64) * total,
                           torch.nextafter(total, torch.zeros_like(total)))
    stoch = torch.argmax((c > thresh[:, None]).to(torch.int32), dim=-1)
    return torch.where(greedy.to(torch.bool), greedy_tok,
                       stoch).to(torch.int32)


def topk_sample(logits, k, temperature, uniform):
    """Plain version of the Pallas kernel's own semantics (kernels/
    topk_sample.py, TPU kernel 3): ``x = logits/T + 0.0``, keep ``x >=
    kth`` (the k-th largest by radix select), Gumbel argmax with the
    caller's (B, V) uniforms, lowest index on ties."""
    x = logits.to(F32) / temperature.to(F32)[:, None] + 0.0
    mapped = _float_bits_descending(x)
    kth = _radix_threshold(torch.ones_like(x), mapped, k.to(F32))
    keep = mapped >= kth[:, None]
    u = torch.clamp(uniform.to(F32), min=1e-12)
    z = torch.where(keep, x - torch.log(-torch.log(u)),
                    torch.full_like(x, NEG))
    return torch.argmax(z, dim=-1).to(torch.int32)
