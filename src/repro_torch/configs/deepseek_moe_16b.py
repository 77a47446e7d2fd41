"""DeepSeekMoE 16B — fine-grained MoE: 2 shared + 64 routed experts, top-6.

[arXiv:2401.06066; hf] 28L d_model=2048 16H (MHA kv=16) d_ff=1408 (per expert)
vocab=102400. Full attention -> skips long_500k.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    moe_d_ff=1408,
    vocab_size=102400,
    num_experts=64,
    top_k=6,
    num_shared_experts=2,
    ffn_gated=True,
    skip_shapes=(
        ("long_500k", "full attention (quadratic); 500k decode context infeasible"),
    ),
    source="arXiv:2401.06066; hf",
))
