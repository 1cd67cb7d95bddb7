from repro_torch.models.convert import (
    cache_from_jax,
    dlrm_params_from_jax,
    params_from_jax,
)
from repro_torch.models.model import (
    QUANT_WEIGHT_KEYS,
    block_program,
    cache_specs,
    decode_step,
    dtype_of,
    forward,
    init_cache,
    init_paged_cache,
    init_params,
    layer_types,
    paged_ok,
    param_count_tree,
    param_specs,
    ported,
    quantize_weights,
    shard_cache,
    shard_params,
)

__all__ = ["QUANT_WEIGHT_KEYS", "block_program", "cache_from_jax",
           "cache_specs", "decode_step", "dlrm_params_from_jax", "dtype_of",
           "forward", "init_cache", "init_paged_cache", "init_params",
           "layer_types", "paged_ok", "param_count_tree", "param_specs",
           "params_from_jax", "ported", "quantize_weights", "shard_cache",
           "shard_params"]
