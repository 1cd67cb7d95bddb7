"""Cost model and hardware constants of the PyTorch port (the parts of the
JAX package's ``repro.core`` the serving engine needs), defaulting to one
NVIDIA H100."""
from repro_torch.core.costmodel import (
    WorkEstimate,
    collective_bytes_per_axis,
    collective_s_per_axis,
    estimate_backlog_s,
    estimate_decode,
    estimate_prefill,
    kv_bytes_per_token,
    stream_occupancy,
    suggest_health_timeout_s,
)
from repro_torch.core.hardware import H100_SXM, Chip
from repro_torch.core.misd.batching import (
    AdmissionPlan,
    BatchAccumulator,
    adaptive_batch_size,
    plan_admission,
)

__all__ = [
    "AdmissionPlan", "BatchAccumulator", "Chip", "H100_SXM", "WorkEstimate",
    "adaptive_batch_size", "collective_bytes_per_axis",
    "collective_s_per_axis", "estimate_backlog_s", "estimate_decode",
    "estimate_prefill", "kv_bytes_per_token", "plan_admission",
    "stream_occupancy", "suggest_health_timeout_s",
]
