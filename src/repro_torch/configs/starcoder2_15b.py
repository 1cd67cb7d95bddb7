"""StarCoder2-15B — dense code LLM with GQA + RoPE [arXiv:2402.19173]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b",
    arch_type="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    rope_variant="standard",
    rope_theta=100_000.0,
    mlp_variant="gelu",
    norm="layernorm",
    citation="arXiv:2402.19173",
)
