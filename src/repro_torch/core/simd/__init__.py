"""The SIMD quadrant of the port on one card: DLRM embedding inference and
the heterogeneous-memory offload plan. The reference's sharding rules
(``core/simd/sharding.py``, DLRM's ``shard_specs`` / ``batch_specs``) wait
for the multi-GPU slice (ROADMAP.md queue 1)."""
from repro_torch.core.simd.embedding import (
    dlrm_forward,
    init_dlrm,
    lookup_traffic_bytes,
)
from repro_torch.core.simd.offload import (
    OffloadPlan,
    effective_bandwidth,
    plan_offload,
    zipf_hit_rate,
)

__all__ = ["OffloadPlan", "dlrm_forward", "effective_bandwidth",
           "init_dlrm", "lookup_traffic_bytes", "plan_offload",
           "zipf_hit_rate"]
