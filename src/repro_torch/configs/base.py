"""Config system of the PyTorch port (its own copy of the JAX package's
``configs/base.py``; the port imports nothing of ``repro``).

Every assigned architecture is an ``ArchConfig`` (one module per arch under
``repro_torch.configs``); input shapes are ``ShapeConfig``s. Both are
hashable, frozen dataclasses.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Tuple

# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned (seq_len, global_batch) workload shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    """Unified architecture description covering all assigned families.

    ``arch_type`` selects the block family:
      dense   — standard decoder (GQA attention + MLP)
      moe     — decoder with MoE MLPs (capacity-based top-k dispatch)
      ssm     — Mamba-2 SSD blocks (attention-free)
      hybrid  — the layers of ``block_pattern``: RG-LRU recurrent blocks :
                local-attention blocks (ratio 2:1) by default, or SSD blocks
                beside attention blocks, each with a MoE MLP ("ssd_moe",
                "moe": granite-4.0-h-small)
      audio   — encoder-only transformer over precomputed frame embeddings
      vlm     — decoder with M-RoPE over precomputed patch+text embeddings
    """

    name: str
    arch_type: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    moe_expert_parallel: bool = False  # expert-parallel layout (vs ff-sharded)
    moe_shared_expert: bool = False
    moe_layer_period: int = 1  # every k-th layer is MoE (llama4: 2)
    dense_d_ff: int = 0  # ff width of interleaved dense layers; 0 -> d_ff
    moe_shared_d_ff: int = 0  # the shared expert's ff width; 0 -> d_ff
    # "softmax_topk": softmax over all E, then k argmax rounds (gates not
    # renormalised); "topk_softmax": the top k of the logits, then the
    # softmax over those k (gates sum to 1; Granite's TopKGating)
    moe_router: str = "softmax_topk"

    # --- SSM (Mamba-2 SSD) ---
    ssm_state_dim: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_kernel: int = 4
    ssm_conv_bias: bool = False  # a bias on the SSD mixer's causal conv

    # --- hybrid (RG-LRU) ---
    block_pattern: Tuple[str, ...] = ()  # e.g. ("rglru", "rglru", "local_attn")
    lru_width: int = 0  # 0 -> d_model

    # --- attention / positions ---
    attention: str = "full"  # full | local | none
    local_window: int = 4_096
    causal: bool = True
    rope_variant: str = "standard"  # standard | half | mrope | none
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)

    # --- scalar multipliers (Granite's; the defaults leave a model as is) ---
    embedding_multiplier: float = 1.0  # x0 = multiplier * embed[ids]
    residual_multiplier: float = 1.0  # x + multiplier * sublayer(norm(x))
    attention_multiplier: float = 0.0  # softmax scale; 0 -> head_dim^-0.5
    logits_scaling: float = 1.0  # logits = head(x) / logits_scaling

    # --- MLP / norm ---
    mlp_variant: str = "swiglu"  # swiglu | geglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-6  # RMSNorm's (layernorm keeps 1e-5)

    # --- modality / mode ---
    is_encoder: bool = False
    modality: str = "text"  # text | audio | vision_text
    tie_embeddings: bool = False

    # --- serving ---
    # For `long_500k` decode of full-attention archs we use a bounded
    # sliding-window KV (sub-quadratic / O(window) decode). 0 disables.
    sliding_window_decode: int = 8_192

    dtype: str = "bfloat16"
    citation: str = ""

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def resolved_lru_width(self) -> int:
        return self.lru_width or self.d_model

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def has_attention(self) -> bool:
        return self.arch_type != "ssm"

    @property
    def supports_decode(self) -> bool:
        return not self.is_encoder

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (matches the materialized pytree; see
        tests/test_configs.py)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        q_dim = self.num_heads * hd
        kv_dim = self.num_kv_heads * hd

        def attn_params() -> int:
            return d * q_dim + 2 * d * kv_dim + q_dim * d

        def mlp_params(width: int) -> int:
            if self.mlp_variant in ("swiglu", "geglu"):
                return 3 * d * width
            return 2 * d * width

        def moe_params() -> int:
            p = d * self.num_experts  # router
            p += self.num_experts * mlp_params(ff) // 1
            if self.moe_shared_expert:
                p += mlp_params(self.moe_shared_d_ff or ff)
            return p

        norm = 2 * d if self.norm == "layernorm" else d

        def block_params(btype: str) -> int:
            if btype in ("dense", "encoder", "local_attn"):
                width = ff
                if btype == "dense" and self.arch_type == "moe":
                    width = self.dense_d_ff or ff
                return attn_params() + mlp_params(width) + 2 * norm
            if btype == "moe":
                return attn_params() + moe_params() + 2 * norm
            if btype in ("ssd", "ssd_moe"):
                di, ns = self.d_inner, self.ssm_state_dim
                nh = self.ssm_num_heads
                # in_proj (z,x,B,C,dt) ; out_proj ; conv ; A,D,dt_bias ; norms
                p = (d * (2 * di + 2 * ns + nh) + di * d
                     + self.conv_kernel * (di + 2 * ns) + 3 * nh
                     + di + norm)
                if self.ssm_conv_bias:
                    p += di + 2 * ns
                if btype == "ssd_moe":  # norm2 and the MoE MLP
                    p += moe_params() + norm
                return p
            if btype == "rglru":
                lw = self.resolved_lru_width
                rec = (d * 2 * lw + lw * d + 2 * lw * lw + 3 * lw
                       + self.conv_kernel * lw)
                return rec + mlp_params(ff) + 2 * norm
            raise ValueError(btype)

        # exact block counts from the block program (handles tails)
        counts = self.block_counts()
        total = sum(block_params(bt) * n for bt, n in counts.items())
        total += norm  # final norm
        if self.modality != "audio":
            total += v * d  # embedding
        if not self.tie_embeddings:
            total += v * d  # lm head / classifier
        return total

    def block_counts(self) -> dict:
        """{block type: layers} from the block program (handles tails)."""
        from collections import Counter

        if self.arch_type in ("dense", "vlm"):
            pattern = ("dense",)
        elif self.arch_type == "audio":
            pattern = ("encoder",)
        elif self.arch_type == "moe":
            pattern = ("dense",) * (self.moe_layer_period - 1) + ("moe",)
        elif self.arch_type == "ssm":
            pattern = ("ssd",)
        else:
            pattern = self.block_pattern or ("rglru", "rglru", "local_attn")
        n_rep, rem = divmod(self.num_layers, len(pattern))
        counts = Counter()
        for bt in pattern:
            counts[bt] += n_rep
        for bt in pattern[:rem]:
            counts[bt] += 1
        return counts

    @property
    def num_moe_layers(self) -> int:
        """Layers with a MoE MLP (``moe`` and ``ssd_moe`` blocks)."""
        counts = self.block_counts()
        return counts["moe"] + counts["ssd_moe"]

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if not self.num_moe_layers:
            return self.param_count()
        full = self.param_count()
        d, ff = self.d_model, self.d_ff
        per_expert = (3 if self.mlp_variant in ("swiglu", "geglu") else 2) * d * ff
        inactive = (self.num_experts - self.experts_per_token) * per_expert
        return full - self.num_moe_layers * inactive

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Smoke-test variant of the same family: 2 layers, d_model<=512,
        <=4 experts, tiny vocab. Used by per-arch CPU smoke tests. A
        pattern of SSD and attention blocks with MoE MLPs (``ssd_moe``)
        keeps two periods of its shortest form ("ssd_moe", "moe"), 8
        experts top 2 of width 64 and a shared expert of 128, GQA 4/2, the
        softmax scale at the same multiple of 1 / head_dim."""
        d = min(self.d_model, 256)
        hd = 32
        heads = max(2, min(4, self.num_heads))
        kv = max(1, min(self.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        changes = dict(
            num_layers=2,
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512) or self.d_ff,
            vocab_size=min(self.vocab_size, 512),
            local_window=min(self.local_window, 64),
            sliding_window_decode=min(self.sliding_window_decode, 128) if self.sliding_window_decode else 0,
            ssm_chunk=32,
            dtype="float32",
        )
        if self.num_experts:
            changes["num_experts"] = min(4, self.num_experts)
            changes["experts_per_token"] = min(self.experts_per_token, 2)
            # non-binding capacity so prefill/decode token grouping cannot
            # change which tokens are served (smoke-test determinism)
            changes["moe_capacity_factor"] = 8.0
        if self.ssm_state_dim:
            changes["ssm_state_dim"] = 16
            changes["ssm_head_dim"] = 16
        if self.lru_width:
            changes["lru_width"] = d
        if self.block_pattern:
            changes["block_pattern"] = self.block_pattern
        if "ssd_moe" in self.block_pattern:
            changes.update(block_pattern=("ssd_moe", "moe"), num_layers=4,
                           num_kv_heads=2, num_experts=8,
                           experts_per_token=2, d_ff=64, moe_shared_d_ff=128)
            changes["attention_multiplier"] = (
                self.attention_multiplier * self.resolved_head_dim / hd)
        if self.rope_variant == "mrope":
            half = hd // 2
            t = half // 4
            changes["mrope_sections"] = (t, (half - t) // 2, half - t - (half - t) // 2)
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ASSIGNED_ARCHS = (
    "starcoder2_15b",
    "grok_1_314b",
    "granite_8b",
    "chatglm3_6b",
    "mamba2_1_3b",
    "recurrentgemma_9b",
    "phi3_medium_14b",
    "llama4_maverick_400b",
    "hubert_xlarge",
    "qwen2_vl_7b",
)

_ALIAS = {
    "starcoder2-15b": "starcoder2_15b",
    "grok-1-314b": "grok_1_314b",
    "granite-8b": "granite_8b",
    "chatglm3-6b": "chatglm3_6b",
    "mamba2-1.3b": "mamba2_1_3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "phi3-medium-14b": "phi3_medium_14b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "hubert-xlarge": "hubert_xlarge",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "dlrm": "dlrm",
    "granite-4.0-h-small": "granite_4_0_h_small",
}


#: Architectures whose config module the port carries: every assigned
#: arch, and DLRM, the survey's SIMD workload.
PORTED_ARCHS = ("granite_8b", "recurrentgemma_9b", "phi3_medium_14b",
                "starcoder2_15b", "chatglm3_6b", "mamba2_1_3b",
                "grok_1_314b", "llama4_maverick_400b", "qwen2_vl_7b",
                "hubert_xlarge", "dlrm")


#: Architectures the port alone serves: the JAX package has no twin to
#: hold them to (their CPU tests hold the port to ldsbench's plain
#: reference instead).
PORT_ONLY_ARCHS = ("granite_4_0_h_small",)

#: ``ArchConfig`` fields the JAX package's lacks; their defaults leave a
#: model as that package builds it.
PORT_ONLY_FIELDS = ("moe_shared_d_ff", "moe_router", "ssm_conv_bias",
                    "embedding_multiplier", "residual_multiplier",
                    "attention_multiplier", "logits_scaling", "norm_eps")


def reference_view(cfg: ArchConfig) -> dict:
    """``cfg`` as the JAX package's ``ArchConfig`` holds it: every field
    but ``PORT_ONLY_FIELDS``, which must hold their defaults (a config
    that needs them has no reference twin)."""
    d = dataclasses.asdict(cfg)
    for f in dataclasses.fields(ArchConfig):
        if f.name in PORT_ONLY_FIELDS and d.pop(f.name) != f.default:
            raise ValueError(f"{cfg.name}: {f.name} is port-only")
    return d


def get_config(name: str) -> ArchConfig:
    mod_name = _ALIAS.get(name, name).replace("-", "_").replace(".", "_")
    if mod_name not in PORTED_ARCHS + PORT_ONLY_ARCHS:
        raise ValueError(
            f"arch {name!r} is not ported to repro_torch yet (ported: "
            f"{PORTED_ARCHS + PORT_ONLY_ARCHS}); see ROADMAP.md queue 1, "
            f"'Other block families'")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs() -> dict:
    """Every assigned arch's config, keyed by its module name (the
    reference's ``all_configs``)."""
    return {n: get_config(n) for n in ASSIGNED_ARCHS}


def get_shape(name: str) -> ShapeConfig:
    return INPUT_SHAPES[name]


def applicable_shapes(cfg: ArchConfig) -> list:
    """Shapes that apply to an arch (encoder-only archs have no decode)."""
    return [s for s in INPUT_SHAPES.values()
            if s.kind != "decode" or cfg.supports_decode]
