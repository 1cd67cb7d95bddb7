"""RecurrentGemma-9B — RG-LRU recurrent blocks + local attention, 2:1
pattern (two recurrent blocks per local-attention block) [arXiv:2402.19427]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    num_layers=38,  # 38 temporal-mixing blocks; pattern tiles (r, r, a)
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,  # MQA in the local-attention blocks
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "local_attn"),
    lru_width=4096,
    attention="local",
    local_window=2048,
    rope_variant="standard",
    mlp_variant="geglu",
    norm="rmsnorm",
    tie_embeddings=True,
    sliding_window_decode=2048,  # native: local attention window
    citation="arXiv:2402.19427",
)
