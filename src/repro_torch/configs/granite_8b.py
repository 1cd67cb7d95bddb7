"""Granite-8B Code — llama-architecture dense code model [arXiv:2405.04324]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b",
    arch_type="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    rope_variant="standard",
    rope_theta=10_000_000.0,
    mlp_variant="swiglu",
    norm="rmsnorm",
    citation="arXiv:2405.04324",
)
