"""Qwen2-7B: dense decoder, GQA kv=4, QKV bias.

[arXiv:2407.10671; hf]  28L, d_model=3584, 28 heads (GQA kv=4), d_ff=18944,
vocab=152064.  Full attention -> long_500k skipped.
"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    use_qkv_bias=True,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen2-7b-smoke",
    family="dense",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    use_qkv_bias=True,
    rope_theta=10_000.0,
)

register(FULL, SMOKE)
