"""Llama-4 Maverick 400B-A17B — MoE decoder, 128 experts top-1 with a
shared expert, early-fusion multimodal [hf:meta-llama/Llama-4-Scout-17B-16E].

128 experts divide the 16-way model axis exactly, so this config enables
the expert-parallel layout (the survey's 'efficient model sharding' space).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    arch_type="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    num_experts=128,
    experts_per_token=1,
    moe_shared_expert=True,
    moe_expert_parallel=True,
    moe_layer_period=2,  # MoE every other layer, dense (ff=16384) between
    dense_d_ff=16384,
    rope_variant="standard",
    mlp_variant="swiglu",
    norm="rmsnorm",
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
)
