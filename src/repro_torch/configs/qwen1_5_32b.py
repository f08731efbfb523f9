"""Qwen1.5-32B: dense decoder with QKV bias, MHA (kv=heads).

[hf:Qwen/Qwen1.5-0.5B; hf]  64L, d_model=5120, 40 heads (kv=40),
d_ff=27392, vocab=152064.  Full attention -> long_500k skipped.
"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    use_qkv_bias=True,
    rope_theta=1_000_000.0,
    # MHA (kv=40): an int8 KV cache (per-head-vector scales) halves the
    # cache's bytes.
    kv_cache_dtype="int8",
)

SMOKE = ModelConfig(
    name="qwen1.5-32b-smoke",
    family="dense",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    use_qkv_bias=True,
    rope_theta=10_000.0,
    kv_cache_dtype="int8",  # smoke-covers the quantized-cache path
)

register(FULL, SMOKE)
