"""Phi-3-medium 14B — dense, RoPE + SwiGLU + GQA [arXiv:2404.14219]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b",
    arch_type="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
    rope_variant="standard",
    mlp_variant="swiglu",
    norm="rmsnorm",
    citation="arXiv:2404.14219",
)
