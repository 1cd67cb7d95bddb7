"""Serving stack of the PyTorch port: the main path of the JAX package's
``repro.serving`` (paged continuous batching on dense archs)."""
from repro_torch.serving.config import (
    DeviceTopology,
    EngineConfig,
    PrecisionConfig,
)
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.paging import PageAllocator, PrefixIndex
from repro_torch.serving.request import (
    Request,
    RequestRejected,
    RequestState,
    SamplingParams,
    ServeMetrics,
)

__all__ = ["DeviceTopology", "EngineConfig", "PageAllocator",
           "PrecisionConfig", "PrefixIndex", "Request", "RequestRejected",
           "RequestState", "SamplingParams", "ServeMetrics", "ServingEngine"]
