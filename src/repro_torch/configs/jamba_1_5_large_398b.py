"""Jamba-1.5-Large (398B): hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887; hf]  72L, d_model=8192, 64 heads (GQA kv=8), d_ff=24576,
vocab=65536.  One attention layer per 8-layer period (rest Mamba); MoE FFN on
every other layer.
"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    num_experts=16,
    num_experts_per_tok=2,
    moe_period=2,
    moe_offset=0,
    attn_period=8,
    ssm_d_state=16,
    ssm_d_conv=4,
    ssm_expand=2,
    optimizer="adafactor",
    master_dtype="bfloat16",
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="jamba-1.5-large-398b-smoke",
    family="hybrid",
    num_layers=16,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    num_experts=4,
    num_experts_per_tok=2,
    moe_period=2,
    moe_offset=0,
    attn_period=8,
    ssm_d_state=8,
    ssm_d_conv=4,
    ssm_expand=2,
    rope_theta=10_000.0,
)

register(FULL, SMOKE)
