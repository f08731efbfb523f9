"""Moonshot-v1-16B-A3B (Moonlight): fine-grained MoE, 64 experts top-6.

[hf:moonshotai/Moonlight-16B-A3B; hf]  48L, d_model=2048, 16 heads (GQA
kv=16), per-expert d_ff=1408, vocab=163840.  Full attention -> long_500k
skipped.
"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    num_experts=64,
    num_experts_per_tok=6,
    moe_period=1,
    rope_theta=50_000.0,
)

SMOKE = ModelConfig(
    name="moonshot-v1-16b-a3b-smoke",
    family="moe",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=32,
    vocab_size=256,
    num_experts=8,
    num_experts_per_tok=3,
    moe_period=1,
    rope_theta=10_000.0,
)

register(FULL, SMOKE)
