from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import (
    block_program,
    decode_step,
    dtype_of,
    forward,
    init_paged_cache,
    init_params,
    layer_types,
    ported,
)

__all__ = ["block_program", "decode_step", "dtype_of", "forward",
           "init_paged_cache", "init_params", "layer_types",
           "params_from_jax", "ported"]
