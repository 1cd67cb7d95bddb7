"""HuBERT X-Large — encoder-only audio transformer (w2v2 arch)
[arXiv:2106.07447]. The conv feature extractor is a stubbed frontend: the
model takes precomputed 1280-d frame embeddings (``frames``)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    arch_type="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,  # full MHA
    d_ff=5120,
    vocab_size=504,  # masked-unit prediction codebook
    is_encoder=True,
    causal=False,
    modality="audio",
    rope_variant="none",
    mlp_variant="gelu",
    norm="layernorm",
    sliding_window_decode=0,
    citation="arXiv:2106.07447",
)
