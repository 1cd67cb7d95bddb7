"""Mamba2-1.3B — attention-free SSM with SSD (state-space duality)
[arXiv:2405.21060]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    arch_type="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,  # attention-free, no separate MLP (SSD block has its own expand)
    vocab_size=50280,
    ssm_state_dim=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    attention="none",
    rope_variant="none",
    norm="rmsnorm",
    tie_embeddings=True,
    sliding_window_decode=0,  # O(1) state; no KV cache at all
    citation="arXiv:2405.21060",
)
