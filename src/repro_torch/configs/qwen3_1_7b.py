"""Qwen3-1.7B: dense decoder with per-head QK-norm and GQA.

[hf:Qwen/Qwen3-8B; hf]  28L, d_model=2048, 16 heads (GQA kv=8), d_ff=6144,
vocab=151936.  Full attention -> long_500k skipped.
"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    use_qk_norm=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen3-1.7b-smoke",
    family="dense",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    use_qk_norm=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
)

register(FULL, SMOKE)
