"""Grok-1 314B — MoE decoder, 8 experts top-2, GQA [hf:xai-org/grok-1]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    arch_type="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    num_experts=8,
    experts_per_token=2,
    rope_variant="standard",
    mlp_variant="geglu",
    norm="rmsnorm",
    citation="hf:xai-org/grok-1",
)
