from repro_torch.core.misd.batching import (
    AdmissionPlan,
    BatchAccumulator,
    adaptive_batch_size,
    plan_admission,
)

__all__ = ["AdmissionPlan", "BatchAccumulator", "adaptive_batch_size",
           "plan_admission"]
