"""Engine configuration of the port: ``PrecisionConfig``,
``DeviceTopology`` and the frozen ``EngineConfig``, with the JAX package's
fields (``repro/serving/config.py``).

The port serves one card: the paged KV cache on dense archs, rolling
caches (``paged=False``, and recurrentgemma's rings and RG-LRU states),
single-shot and chunked prefill (``chunk_prefill`` defaults to 64, as in
the reference), the prefix cache, cancel, timeouts, shedding and
preemption, model-dtype or int8 pools and weights, span tracing and the
profiler hook. ``validate()`` refuses every option whose path is not
ported yet (sharded replicas, other block families) and names the
``ROADMAP.md`` item that brings it, so nothing silently runs a different
path than the one asked for; the engine keeps the reference's own
refusals (a prefix cache or preemption without pages, an unknown
``preempt_policy``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

MOE_CAPACITY_POLICIES = ("strict", "backpressure", "drop")
KV_CACHE_DTYPES = ("", "int8")
WEIGHT_DTYPES = ("", "int8")
#: Scale granularity of the quantized KV cache. Storage is identical (one
#: float32 scale per (token, kv head) vector); "page" coarsens prefill
#: writes to one scale per (page, kv head), while decode-time appends
#: always get their own scale. "token" keeps per-token scales everywhere.
KV_SCALE_GRANULARITIES = ("page", "token")

#: Block types whose attention/MLP matmul weights may quantize to int8
#: (the reference's list): an arch with any other block, such as
#: recurrentgemma's rglru, is refused int8 weights, as in the reference.
WEIGHT_QUANT_BLOCKS = ("dense", "encoder", "local_attn")


@dataclass(frozen=True)
class PrecisionConfig:
    """Serving-path numeric precision ("" = the model dtype)."""

    kv_cache_dtype: str = ""
    weight_dtype: str = ""
    kv_scale_granularity: str = "page"

    def __post_init__(self):
        if self.kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(f"unknown kv_cache_dtype "
                             f"{self.kv_cache_dtype!r} (want one of "
                             f"{KV_CACHE_DTYPES})")
        if self.weight_dtype not in WEIGHT_DTYPES:
            raise ValueError(f"unknown weight_dtype {self.weight_dtype!r} "
                             f"(want one of {WEIGHT_DTYPES})")
        if self.kv_scale_granularity not in KV_SCALE_GRANULARITIES:
            raise ValueError(f"unknown kv_scale_granularity "
                             f"{self.kv_scale_granularity!r} (want one of "
                             f"{KV_SCALE_GRANULARITIES})")

    @property
    def quantized_kv(self) -> bool:
        return self.kv_cache_dtype != ""

    @property
    def quantized_weights(self) -> bool:
        return self.weight_dtype != ""


@dataclass(frozen=True)
class DeviceTopology:
    """Mesh shape one engine replica spans (dp x tp); (1, 1) is one card."""

    dp: int = 1
    tp: int = 1

    def __post_init__(self):
        if self.dp < 1 or self.tp < 1:
            raise ValueError(f"DeviceTopology axes must be >= 1 (got "
                             f"dp={self.dp}, tp={self.tp})")

    @property
    def n_chips(self) -> int:
        return self.dp * self.tp

    @property
    def sharded(self) -> bool:
        return self.n_chips > 1

    @property
    def mesh_axes(self) -> tuple:
        return (("data", self.dp), ("model", self.tp))


@dataclass(frozen=True)
class EngineConfig:
    """Everything that shapes a ``ServingEngine`` besides (cfg, params);
    field semantics as in the JAX package."""

    slots: Optional[int] = 4
    window: int = 512
    eos_id: int = -1
    sync_every: int = 8
    donate: bool = True
    bucket_prompts: bool = True
    chunk_prefill: int = 64
    sla_s: float = 0.05
    prefill_policy: Optional[object] = None  # ChunkedPrefillPolicy
    paged: Optional[bool] = None
    page_size: int = 16
    pool_pages: Optional[int] = None
    max_seq: Optional[int] = None
    kv_hbm_budget: Optional[float] = None
    expected_len: Optional[int] = None
    edf_backlog: bool = False
    prefix_cache: bool = False
    preemption: bool = False
    preempt_policy: str = "latest-deadline"
    shed_overdue: bool = False
    topology: DeviceTopology = DeviceTopology()
    modeled_chips: int = 0
    moe_capacity_policy: Optional[str] = None
    precision: PrecisionConfig = PrecisionConfig()
    tracing: bool = False
    trace_sample_n: int = 1
    trace_ring: int = 0
    profile_dir: Optional[str] = None

    def __post_init__(self):
        if (self.moe_capacity_policy is not None
                and self.moe_capacity_policy not in MOE_CAPACITY_POLICIES):
            raise ValueError(f"unknown moe_capacity_policy "
                             f"{self.moe_capacity_policy!r} (want one of "
                             f"{MOE_CAPACITY_POLICIES})")
        if self.modeled_chips < 0:
            raise ValueError(f"modeled_chips must be >= 0, got "
                             f"{self.modeled_chips}")
        if self.trace_sample_n < 1:
            raise ValueError(f"trace_sample_n must be >= 1, got "
                             f"{self.trace_sample_n}")
        if self.trace_ring < 0:
            raise ValueError(f"trace_ring must be >= 0, got "
                             f"{self.trace_ring}")

    @property
    def n_chips(self) -> int:
        return self.modeled_chips or self.topology.n_chips

    def validate(self, cfg=None) -> "EngineConfig":
        """Refuse, before any work, a paged cache or a precision the
        reference refuses (with its message), then every option whose path
        the port does not serve yet; that message names the ROADMAP.md
        item."""
        if cfg is not None and self.paged:
            from repro_torch.models import paged_ok

            if not paged_ok(cfg):
                raise ValueError(
                    f"{cfg.name}: arch has non-pageable blocks (recurrent "
                    f"or local-attention); pass paged=None to auto-fall "
                    f"back to rolling windows")
        self._validate_precision(cfg)
        q1 = "ROADMAP.md queue 1"
        not_yet = []
        if self.topology.sharded:
            not_yet.append((f"topology dp={self.topology.dp} "
                            f"tp={self.topology.tp} (sharded replica)",
                            f"{q1}, 'Multi-GPU'"))
        if cfg is not None:
            from repro_torch.models import layer_types, ported
            from repro_torch.models.blocks import PORTED_BLOCKS

            if not ported(cfg):
                bad = sorted(set(layer_types(cfg)) - set(PORTED_BLOCKS))
                not_yet.append((f"arch {cfg.name} with {bad} blocks",
                                f"{q1}, 'Other block families'"))
        if not_yet:
            what, item = not_yet[0]
            raise ValueError(f"{what} is not ported to repro_torch yet "
                             f"(see {item})")
        return self

    def _validate_precision(self, cfg):
        """The reference's rules: int8 KV needs the paged cache and an arch
        whose every block is pageable; int8 weights need
        ``WEIGHT_QUANT_BLOCKS`` and one card."""
        pr = self.precision
        if cfg is not None and pr.quantized_kv:
            from repro_torch.models import paged_ok

            if self.paged is False:
                raise ValueError(
                    f"precision.kv_cache_dtype={pr.kv_cache_dtype!r} "
                    f"quantizes KV-cache PAGES; the rolling cache "
                    f"(paged=False) has no paged pools — drop paged=False "
                    f"or clear kv_cache_dtype")
            if not paged_ok(cfg):
                raise ValueError(
                    f"precision.kv_cache_dtype={pr.kv_cache_dtype!r} "
                    f"needs every block pageable, but {cfg.name} has "
                    f"rolling/recurrent-cache blocks (local_attn/rglru/"
                    f"ssd) that cannot serve from quantized pages — clear "
                    f"kv_cache_dtype for this arch")
        if cfg is not None and pr.quantized_weights:
            from repro_torch.models import block_program

            pattern, _, tail = block_program(cfg)
            bad = sorted({bt for bt in pattern + tail
                          if bt not in WEIGHT_QUANT_BLOCKS})
            if bad:
                raise ValueError(
                    f"precision.weight_dtype={pr.weight_dtype!r} supports "
                    f"blocks {WEIGHT_QUANT_BLOCKS} only, but {cfg.name} "
                    f"contains {bad} — clear weight_dtype for this arch")
            if self.topology.sharded:
                raise ValueError(
                    f"precision.weight_dtype={pr.weight_dtype!r} is not "
                    f"supported on sharded replicas yet (int8 weight "
                    f"leaves have no GSPMD profile) — serve quantized "
                    f"weights on 1-chip replicas or clear weight_dtype")

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)
