"""Analytic latency model for serving work: the roofline of the JAX
package's ``core/costmodel.py``, restricted to what the engine needs (its
admission plan, the chunked-prefill policy, ``load_report``), over the chip
constants in ``repro_torch.core.hardware`` (default: one H100), with the
reference's terms for a routed cluster: a prefix hit's discount, a mesh's
collective bytes (``mesh_axes``; none on one card) and the health
watchdog's budget (``suggest_health_timeout_s``)."""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.hardware import DISPATCH_OVERHEAD_S, H100_SXM, Chip


@dataclass(frozen=True)
class WorkEstimate:
    """Roofline terms for one step of work on a device (group)."""

    flops: float
    hbm_bytes: float
    collective_bytes: float = 0.0
    chip: Chip = H100_SXM
    n_chips: int = 1

    @property
    def compute_s(self) -> float:
        return self.flops / (self.chip.peak_flops * self.n_chips)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / (self.chip.hbm_bw * self.n_chips)

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / (self.chip.link_bw * self.n_chips)

    @property
    def latency_s(self) -> float:
        return (max(self.compute_s, self.memory_s, self.collective_s)
                + DISPATCH_OVERHEAD_S)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def demand(self) -> tuple:
        """(compute, memory) fractions of the latency each resource class
        is busy: the interference model's input."""
        lat = self.latency_s
        return (min(1.0, self.compute_s / lat), min(1.0, self.memory_s / lat))


def stream_occupancy(batch: int, *, half_sat: float = 16.0,
                     floor: float = 0.30, cap: float = 0.95) -> float:
    """Occupancy of a single inference stream as a function of batch size:
    rises toward ``cap`` as batching amortizes dispatch/dependency
    stalls."""
    return min(cap, floor + (1.0 - floor) * batch / (batch + half_sat))


def _dtype_bytes(cfg) -> int:
    return 2 if cfg.dtype == "bfloat16" else 4


def _n_attn_layers(cfg) -> int:
    if cfg.arch_type != "hybrid":
        return cfg.num_layers
    pat = cfg.block_pattern or ("rglru", "rglru", "local_attn")
    return cfg.num_layers * sum(b == "local_attn" for b in pat) // len(pat)


def kv_bytes_per_token(cfg, kv_cache_dtype: str = "") -> float:
    """Device bytes one cached token costs across every attention layer.
    ``kv_cache_dtype`` is the pool's storage dtype: "" (the model dtype) or
    "int8" (1 byte per element plus one float32 scale per (token, kv
    head) vector). Any other dtype is refused loudly: a wrong estimate
    over-admits the pool."""
    if not cfg.has_attention:
        return 0.0
    hd = cfg.resolved_head_dim
    if kv_cache_dtype == "":
        per_vec = hd * _dtype_bytes(cfg)
    elif kv_cache_dtype == "int8":
        per_vec = hd * 1 + 4.0
    else:
        raise AssertionError(
            f"kv_bytes_per_token: unknown kv_cache_dtype "
            f"{kv_cache_dtype!r}: capacity planning would over-admit")
    return 2.0 * _n_attn_layers(cfg) * cfg.num_kv_heads * per_vec


def _attn_flops(cfg, batch: int, s_q: int, s_kv: int) -> float:
    if not cfg.has_attention:
        return 0.0
    hd = cfg.resolved_head_dim
    pairs = s_q * s_kv * (0.5 if (cfg.causal and s_q == s_kv) else 1.0)
    if cfg.arch_type == "hybrid":
        pairs = min(pairs, s_q * cfg.local_window)
    return 4.0 * batch * _n_attn_layers(cfg) * cfg.num_heads * pairs * hd


def _axes_chips(mesh_axes) -> int:
    n = 1
    for _, size in mesh_axes:
        n *= int(size)
    return n


def estimate_prefill(cfg, batch: int, seq: int, *, chip: Chip = H100_SXM,
                     n_chips: int = 1, collective_bytes: float = 0.0,
                     prefix_hit: int = 0, mesh_axes=None) -> WorkEstimate:
    """``prefix_hit`` > 0 prices a suffix prefill over a cached prefix:
    only ``seq - prefix_hit`` tokens flow through the model (attending all
    ``seq`` keys), and the prefix's KV is read instead of computed: the
    discount the router's prefix affinity scores. ``mesh_axes`` sets the
    card count and, unless ``collective_bytes`` is given, the per-axis
    collective bytes."""
    new = max(1, seq - prefix_hit) if prefix_hit > 0 else seq
    flops = (2.0 * cfg.active_param_count() * batch * new
             + _attn_flops(cfg, batch, new, seq))
    wb = _dtype_bytes(cfg)
    hbm = cfg.param_count() * wb + 12.0 * batch * new * cfg.d_model * wb
    if prefix_hit > 0:
        hbm += kv_bytes_per_token(cfg) * min(prefix_hit, seq) * batch
    if mesh_axes is not None:
        n_chips = _axes_chips(mesh_axes)
        if collective_bytes == 0.0:
            collective_bytes = sum(collective_bytes_per_axis(
                cfg, batch * new, mesh_axes=mesh_axes).values())
    return WorkEstimate(flops, hbm, collective_bytes, chip, n_chips)


def estimate_decode(cfg, batch: int, context: int, *, chip: Chip = H100_SXM,
                    n_chips: int = 1, window: int = 0,
                    collective_bytes: float = 0.0,
                    mesh_axes=None) -> WorkEstimate:
    """One decode tick of ``batch`` slots at ``context`` tokens (``window``
    caps the attended keys); ``mesh_axes`` as in ``estimate_prefill``."""
    wb = _dtype_bytes(cfg)
    kv_len = min(context, window) if window else context
    flops = (2.0 * cfg.active_param_count() * batch
             + _attn_flops(cfg, batch, 1, kv_len))
    kv_bytes = 0.0
    if cfg.has_attention:
        if cfg.arch_type == "hybrid":
            kv_len = min(kv_len, cfg.local_window)
        kv_bytes = (2.0 * batch * _n_attn_layers(cfg) * kv_len
                    * cfg.num_kv_heads * cfg.resolved_head_dim * wb)
    if cfg.arch_type in ("ssm", "hybrid"):
        # recurrent state read and write
        kv_bytes += batch * cfg.num_layers * cfg.d_model * 4 * 4.0
    hbm = cfg.param_count() * wb + kv_bytes
    if mesh_axes is not None:
        n_chips = _axes_chips(mesh_axes)
        if collective_bytes == 0.0:
            collective_bytes = sum(collective_bytes_per_axis(
                cfg, batch, mesh_axes=mesh_axes).values())
    return WorkEstimate(flops, hbm, collective_bytes, chip, n_chips)


def collective_bytes_per_axis(cfg, tokens: int, *, mesh_axes=None) -> dict:
    """Collective bytes per mesh axis (per participating card) for one
    forward pass over ``tokens`` tokens, keyed off the mesh shape
    ``((axis, size), ...)``: two activation collectives per layer on a
    ``model`` axis of n > 1 cards (ring cost (n - 1) / n of the (tokens,
    d) residual each), plus the expert all-to-all on MoE archs; ``data``
    axes move nothing per step. One card (``mesh_axes`` None) has no
    axis: ``{}``."""
    wb = _dtype_bytes(cfg)
    out = {}
    for name, n in mesh_axes or ():
        n = int(n)
        traffic = 0.0
        if name == "model" and n > 1:
            ring = (n - 1) / n
            traffic = 4.0 * cfg.num_layers * tokens * cfg.d_model * wb * ring
            if cfg.arch_type == "moe" and cfg.num_experts:
                moe_layers = cfg.num_layers // max(1, cfg.moe_layer_period)
                k = max(1, cfg.experts_per_token)
                traffic += (2.0 * moe_layers * tokens * k * cfg.d_model
                            * wb * ring)
        out[name] = traffic
    return out


def collective_s_per_axis(cfg, tokens: int, *, mesh_axes=None,
                          chip: Chip = H100_SXM) -> dict:
    """Collective seconds per mesh axis for one forward pass, at the
    card's per-direction link rate; ``{}`` on one card."""
    per_axis = collective_bytes_per_axis(cfg, tokens, mesh_axes=mesh_axes)
    return {a: b / chip.link_bw for a, b in per_axis.items()}


def estimate_backlog_s(cfg, *, queued_prefill_tokens: int,
                       decode_tokens_remaining: int, slots: int,
                       context: int, chip: Chip = H100_SXM,
                       n_chips: int = 1, mesh_axes=None) -> float:
    """Seconds to drain an engine's outstanding work, the scalar a router
    reads from ``ServingEngine.load_report``: every queued or unfinished
    prefill token flows through prefill once, and every remaining decode
    token costs a share of a batched decode tick (B slots emit up to B
    tokens a tick). Both terms are monotone in load."""
    s = 0.0
    if queued_prefill_tokens > 0:
        s += estimate_prefill(cfg, 1, queued_prefill_tokens, chip=chip,
                              n_chips=n_chips, mesh_axes=mesh_axes).latency_s
    if decode_tokens_remaining > 0:
        b = max(1, slots)
        per_tick = estimate_decode(cfg, b, context, chip=chip,
                                   n_chips=n_chips,
                                   mesh_axes=mesh_axes).latency_s
        s += per_tick * decode_tokens_remaining / b
    return s


def suggest_health_timeout_s(cfg, *, slots: int, context: int,
                             chip: Chip = H100_SXM, n_chips: int = 1,
                             ticks: int = 8) -> float:
    """The health watchdog's staleness budget for a replica of this shape:
    the cost model's time for ``ticks`` full-batch decode ticks. A healthy
    replica that holds work moves its progress signature at least once a
    tick, so ``ticks`` missed in a row mark a wedge while a slow host (2-4x)
    stays under the bar."""
    per_tick = estimate_decode(cfg, max(1, slots), context, chip=chip,
                               n_chips=n_chips).latency_s
    return max(1, ticks) * per_tick
