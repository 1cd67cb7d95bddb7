"""Qwen2-VL-7B — VLM decoder backbone with M-RoPE (3-section multimodal
rotary positions) [arXiv:2409.12191]. The ViT vision encoder + projector is a
stubbed frontend: ``models.forward`` takes precomputed patch embeddings
(``patches``) and the (3, B, S) M-RoPE position ids (``positions``)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    arch_type="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    modality="vision_text",
    rope_variant="mrope",
    mrope_sections=(16, 24, 24),  # temporal / height / width over head_dim/2
    mlp_variant="swiglu",
    norm="rmsnorm",
    citation="arXiv:2409.12191",
)
