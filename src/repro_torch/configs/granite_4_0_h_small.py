"""IBM Granite 4.0-H Small — a hybrid of Mamba-2 SSD layers and full
GQA attention layers (NoPE) at a 9:1 ratio, every layer's MLP a MoE of
72 experts top 10 (the softmax over the 10 picked logits) plus a shared
expert [hf:ibm-granite/granite-4.0-h-small, ``granitemoehybrid``].

``layer_types`` puts attention at layers 5, 15, 25 and 35: the period of
10 below. Published scalars: the embedding x 12, each sublayer's output
x 0.22 into the residual, the softmax scale 1/128, the logits / 16.
``d_ff`` is one expert's width (``intermediate_size``); the shared
expert's is ``shared_intermediate_size``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-4.0-h-small",
    arch_type="hybrid",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=768,
    vocab_size=100352,
    num_experts=72,
    experts_per_token=10,
    moe_shared_expert=True,
    moe_shared_d_ff=1536,
    moe_router="topk_softmax",
    ssm_state_dim=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    conv_kernel=4,
    ssm_conv_bias=True,
    block_pattern=("ssd_moe",) * 5 + ("moe",) + ("ssd_moe",) * 4,
    attention="full",
    rope_variant="none",
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    attention_multiplier=0.0078125,
    logits_scaling=16.0,
    mlp_variant="swiglu",
    norm="rmsnorm",
    norm_eps=1e-5,
    tie_embeddings=True,
    sliding_window_decode=0,
    citation="hf:ibm-granite/granite-4.0-h-small",
)
