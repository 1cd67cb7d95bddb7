"""Serving stack of the PyTorch port: the JAX package's ``repro.serving``
(the engine, on one card or as one replica over the shards of a device
grid, and the cluster frontend over its replicas), with the same exports
for the modules ported so far."""
from repro_torch.serving.cluster import ClusterFrontend, EngineInstance
from repro_torch.serving.config import (
    KV_CACHE_DTYPES,
    KV_SCALE_GRANULARITIES,
    MOE_CAPACITY_POLICIES,
    WEIGHT_DTYPES,
    WEIGHT_QUANT_BLOCKS,
    DeviceTopology,
    EngineConfig,
    PrecisionConfig,
)
from repro_torch.serving.engine import (
    PREEMPT_POLICIES,
    ServingEngine,
    bucketed_prefill_step,
    cache_insert,
    decode_scan_step,
    decode_tick,
    generate,
    page_table_append,
    paged_prefill_step,
    pages_insert,
    pages_insert_prefix,
    prefill_chunk_step,
    prefill_step,
    prefix_seed_cache,
    prompt_bucket,
    serve_step,
    slot_release,
)
from repro_torch.serving.faults import (
    EngineFailure,
    FaultInjector,
    FaultyEngine,
)
from repro_torch.serving.metrics import (
    BUCKET_PRESETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    latency_histogram,
    residual_histogram,
)
from repro_torch.serving.overload import (
    BROWNOUT,
    LADDER_LEVELS,
    NORMAL,
    REJECT,
    SHED,
    CircuitBreaker,
    OverloadDetector,
    TenantAdmission,
    TenantClass,
    TokenBucket,
    WeightedFairQueue,
    request_cost,
)
from repro_torch.serving.paging import (
    OutOfPagesError,
    PageAllocator,
    PrefixHit,
    PrefixIndex,
)
from repro_torch.serving.request import (
    Request,
    RequestRejected,
    RequestState,
    SamplingParams,
    ServeMetrics,
    TenantMetrics,
)
from repro_torch.serving.telemetry import SCHEMA_VERSION, LoadReport
from repro_torch.serving.trace_export import (
    chrome_trace,
    request_traces,
    validate_chrome_trace,
    write_chrome_trace,
)
from repro_torch.serving.tracing import Span, Trace, Tracer

__all__ = [
    "BROWNOUT", "BUCKET_PRESETS", "KV_CACHE_DTYPES",
    "KV_SCALE_GRANULARITIES", "LADDER_LEVELS", "MOE_CAPACITY_POLICIES",
    "NORMAL", "PREEMPT_POLICIES", "REJECT", "SCHEMA_VERSION", "SHED",
    "WEIGHT_DTYPES", "WEIGHT_QUANT_BLOCKS", "CircuitBreaker",
    "ClusterFrontend", "Counter", "DeviceTopology", "EngineConfig",
    "EngineFailure", "EngineInstance", "FaultInjector", "FaultyEngine",
    "Gauge", "Histogram", "LoadReport", "MetricsRegistry",
    "OutOfPagesError", "OverloadDetector", "PageAllocator",
    "PrecisionConfig", "PrefixHit", "PrefixIndex", "Request",
    "RequestRejected", "RequestState", "SamplingParams", "ServeMetrics",
    "ServingEngine", "Span", "TenantAdmission", "TenantClass",
    "TenantMetrics", "TokenBucket", "Trace", "Tracer", "WeightedFairQueue",
    "bucketed_prefill_step", "cache_insert", "chrome_trace",
    "decode_scan_step", "decode_tick", "generate", "latency_histogram",
    "page_table_append", "paged_prefill_step", "pages_insert",
    "pages_insert_prefix", "prefill_chunk_step", "prefill_step",
    "prefix_seed_cache", "prompt_bucket", "request_cost", "request_traces",
    "residual_histogram", "serve_step", "slot_release",
    "validate_chrome_trace", "write_chrome_trace",
]
