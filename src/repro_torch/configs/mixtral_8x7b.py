"""Mixtral-8x7B: 8 experts top-2 MoE with sliding-window attention.

[arXiv:2401.04088; hf]  32L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336,
vocab=32000, SWA window 4096.  SWA bounds the decode KV cache -> long_500k
runs with a rolling-window cache.
"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    num_experts=8,
    num_experts_per_tok=2,
    moe_period=1,
    sliding_window=4096,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="mixtral-8x7b-smoke",
    family="moe",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    num_experts=4,
    num_experts_per_tok=2,
    moe_period=1,
    sliding_window=32,
    rope_theta=10_000.0,
)

register(FULL, SMOKE)
