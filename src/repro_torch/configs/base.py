"""Model architectures and input shapes of the LM zoo.

The port's own copy of the reference's config system
(``src/repro/configs/base.py``): every architecture is a frozen
``ModelConfig``, the four canonical input shapes are ``ShapeConfig``s, and
``ModelConfig.reduced()`` gives the tiny same-family config the CPU tests
run; ``DLRMConfig`` describes the paper's own models (Table 6).
``tests/test_torch_transformer.py`` and ``tests/test_torch_workloads.py``
hold the copy to the original field by field.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Input shapes (seq_len x global_batch)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: Mapping[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
SHAPE_ORDER: Sequence[str] = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A transformer-family LM config (covers dense/MoE/SSM/hybrid/encoder/VLM)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encoder | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # FFN
    ffn_gated: bool = True  # SwiGLU (llama) vs plain GELU MLP

    # Attention
    qkv_bias: bool = False
    causal: bool = True
    sliding_window: int = 0  # 0 = full attention
    rope_theta: float = 10_000.0

    # MoE
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim (fine-grained MoE); 0 -> d_ff
    moe_capacity_factor: float = 1.25

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # Hybrid (zamba2-style): mamba2 backbone + shared attention block
    shared_attn_every: int = 0

    # VLM backbone: cross-attention layers every N self-attn layers
    cross_attn_every: int = 0
    num_image_tokens: int = 0

    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # Training and sharding knobs of the reference, kept so the copy stays
    # field-for-field equal; the serving path reads none of them.
    remat_span: int = 1
    microbatches: int = 1
    seq_parallel: bool = True

    # Which canonical shapes this arch skips, with reasons.
    skip_shapes: Tuple[Tuple[str, str], ...] = ()

    sharding_overrides: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = ()

    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_experts and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    # -- derived ------------------------------------------------------------

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_encoder_only(self) -> bool:
        return self.family == "encoder"

    @property
    def subquadratic(self) -> bool:
        """Can this arch serve a 500k-token decode context?"""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def skipped(self, shape_name: str) -> Optional[str]:
        for s, reason in self.skip_shapes:
            if s == shape_name:
                return reason
        return None

    def param_count(self) -> int:
        """Analytic parameter count (embedding + per-layer), for rooflines."""
        d, h, kv, hd = self.d_model, self.num_heads, self.num_kv_heads, self.head_dim
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "moe", "encoder", "vlm", "hybrid"):
            attn = d * h * hd + 2 * d * kv * hd + h * hd * d
            if self.family == "hybrid":
                # one shared block, invoked many times
                total = embed + self.num_layers * self._ssm_params()
                total += attn + self._ffn_params(self.d_ff)
                total += self.num_layers * 2 * d  # norms
                return total
            per_layer += attn
        if self.num_experts:
            expert = self._ffn_params(self.moe_d_ff)
            per_layer += self.num_experts * expert + self.num_shared_experts * expert
            per_layer += d * self.num_experts  # router
        elif self.family != "ssm":
            per_layer += self._ffn_params(self.d_ff)
        if self.family == "ssm":
            per_layer += self._ssm_params()
        if self.cross_attn_every:
            n_cross = self.num_layers // self.cross_attn_every
            cross = d * h * hd + 2 * d * kv * hd + h * hd * d + self._ffn_params(self.d_ff)
            return embed + self.num_layers * (per_layer + 2 * d) + n_cross * cross
        return embed + self.num_layers * (per_layer + 2 * d)

    def _ffn_params(self, d_ff: int) -> int:
        mult = 3 if self.ffn_gated else 2
        return mult * self.d_model * d_ff

    def _ssm_params(self) -> int:
        di, ns = self.d_inner, self.ssm_state
        in_proj = self.d_model * (2 * di + 2 * ns + self.ssm_heads)
        out_proj = di * self.d_model
        conv = self.ssm_conv * (di + 2 * ns)
        return in_proj + out_proj + conv + 2 * self.ssm_heads

    # -- smoke-test reduction ------------------------------------------------

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU tests."""
        scale = {
            "num_layers": min(self.num_layers, 2 + (1 if self.shared_attn_every else 0)),
            "d_model": 64,
            "num_heads": 4,
            "num_kv_heads": max(1, min(self.num_kv_heads, 2)),
            "head_dim": 16,
            "d_ff": 128,
            "vocab_size": 256,
            "moe_d_ff": 32 if self.num_experts else 0,
            "num_experts": min(self.num_experts, 4),
            "top_k": min(self.top_k, 2),
            "num_shared_experts": min(self.num_shared_experts, 1),
            "ssm_state": min(self.ssm_state, 16),
            "ssm_head_dim": 16,
            "ssm_chunk": 16,
            "sliding_window": min(self.sliding_window, 16) if self.sliding_window else 0,
            "shared_attn_every": 2 if self.shared_attn_every else 0,
            "cross_attn_every": 2 if self.cross_attn_every else 0,
            "num_image_tokens": 8 if self.cross_attn_every else 0,
            "name": self.name + "-reduced",
        }
        if self.shared_attn_every or self.cross_attn_every:
            scale["num_layers"] = 4
        return dataclasses.replace(self, **scale)


# ---------------------------------------------------------------------------
# DLRM config (the paper's own model family, Table 6)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    """Paper Table 6 model description.

    Embedding dims in the paper are *bytes per quantized row*; we model rows as
    int8 row-wise-quantized payloads of ``dim_bytes - 8`` elements (8 bytes of
    fp32 scale+bias header, matching §4.1.1 / footnote 4).
    """

    name: str
    num_params: int  # total (reported)
    size_gb: float
    num_user_tables: int
    user_dim_bytes: Tuple[int, int]  # [min, max]
    user_avg_pool: int
    num_item_tables: int
    item_dim_bytes: Tuple[int, int]
    item_avg_pool: int
    user_batch: int
    item_batch: int
    num_mlp_layers: int
    avg_mlp_size: int
    qps_target: int = 0

    def reduced(self) -> "DLRMConfig":
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            size_gb=0.001,
            num_user_tables=4,
            num_item_tables=3,
            num_mlp_layers=3,
            avg_mlp_size=32,
            item_batch=8,
        )


REGISTRY: dict = {}
DLRM_REGISTRY: dict = {}


def register(cfg):
    reg = DLRM_REGISTRY if isinstance(cfg, DLRMConfig) else REGISTRY
    reg[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name in REGISTRY:
        return REGISTRY[name]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")


def get_dlrm_config(name: str) -> DLRMConfig:
    return DLRM_REGISTRY[name]


def list_archs() -> Sequence[str]:
    return sorted(REGISTRY)
