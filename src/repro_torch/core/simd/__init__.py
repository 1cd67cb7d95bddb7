"""The SIMD quadrant of the port: DLRM embedding inference (row-split
tables over a mesh: ``shard_specs``, ``batch_specs``), the
heterogeneous-memory offload plan, and the sharding rules of a sharded
replica (``sharding``)."""
from repro_torch.core.simd.embedding import (
    batch_specs,
    dlrm_forward,
    init_dlrm,
    lookup_traffic_bytes,
    shard_specs,
    sharded_lookup,
)
from repro_torch.core.simd.offload import (
    OffloadPlan,
    effective_bandwidth,
    plan_offload,
    zipf_hit_rate,
)

__all__ = ["OffloadPlan", "batch_specs", "dlrm_forward",
           "effective_bandwidth", "init_dlrm", "lookup_traffic_bytes",
           "plan_offload", "shard_specs", "sharded_lookup",
           "zipf_hit_rate"]
