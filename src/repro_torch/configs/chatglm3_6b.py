"""ChatGLM3-6B — 2d (half-dim) RoPE, GQA kv=2 [arXiv:2406.12793]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    arch_type="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope_variant="half",  # ChatGLM applies RoPE to half of each head dim
    mlp_variant="swiglu",
    norm="rmsnorm",
    citation="arXiv:2406.12793",
)
