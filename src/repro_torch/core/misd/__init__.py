from repro_torch.core.misd.batching import (
    AdmissionPlan,
    BatchAccumulator,
    adaptive_batch_size,
    plan_admission,
)
from repro_torch.core.misd.interference import (
    InterferencePredictor,
    pairwise_degradation,
    progress_rates,
)
from repro_torch.core.misd.partition import (
    MeshPartitioner,
    Meshlet,
    PartitionPlan,
)
from repro_torch.core.misd.scheduler import (
    SCHEDULERS,
    ChunkedPrefillPolicy,
    Device,
    FIFOScheduler,
    InterferenceAwareScheduler,
    Job,
    MISDSimulator,
    PremaScheduler,
    SJFScheduler,
    SimResult,
)

__all__ = ["SCHEDULERS", "AdmissionPlan", "BatchAccumulator",
           "ChunkedPrefillPolicy", "Device", "FIFOScheduler",
           "InterferenceAwareScheduler", "InterferencePredictor", "Job",
           "MISDSimulator", "MeshPartitioner", "Meshlet", "PartitionPlan",
           "PremaScheduler", "SJFScheduler", "SimResult",
           "adaptive_batch_size", "pairwise_degradation", "plan_admission",
           "progress_rates"]
