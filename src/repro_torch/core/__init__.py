"""The survey's taxonomy of the PyTorch port, defaulting to one NVIDIA
H100: the cost model and hardware constants at the root, one subpackage
per quadrant (``misd/``, ``simd/``, ``mimd/``), the SISD baseline
(``sisd.py``) and the paradigm classifier (``paradigm.py``)."""
from repro_torch.core.costmodel import (
    WorkEstimate,
    collective_bytes_per_axis,
    collective_s_per_axis,
    estimate,
    estimate_backlog_s,
    estimate_decode,
    estimate_prefill,
    estimate_train,
    kv_bytes_per_token,
    model_flops,
    stream_occupancy,
    suggest_health_timeout_s,
)
from repro_torch.core.hardware import CHIPS, H100_SXM, Chip
from repro_torch.core.misd.batching import (
    AdmissionPlan,
    BatchAccumulator,
    adaptive_batch_size,
    plan_admission,
)
from repro_torch.core.paradigm import (
    Deployment,
    Paradigm,
    classify,
    executor_for,
)

__all__ = [
    "CHIPS", "AdmissionPlan", "BatchAccumulator", "Chip", "Deployment",
    "H100_SXM", "Paradigm", "WorkEstimate", "adaptive_batch_size",
    "classify", "collective_bytes_per_axis", "collective_s_per_axis",
    "estimate", "estimate_backlog_s", "estimate_decode", "estimate_prefill",
    "estimate_train", "executor_for", "kv_bytes_per_token", "model_flops",
    "plan_admission", "stream_occupancy", "suggest_health_timeout_s",
]
