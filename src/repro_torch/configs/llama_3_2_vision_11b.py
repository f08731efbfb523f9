"""Llama-3.2-Vision-11B: decoder backbone with interleaved cross-attention
image layers.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified]  40L, d_model=4096, 32
heads (GQA kv=8), d_ff=14336, vocab=128256.  One gated cross-attention layer
per 5-layer period attends to precomputed image-patch embeddings (the
vision front end is a stub: the serving engine feeds zeros of [batch,
num_image_tokens, d_model]).  Full attention -> long_500k skipped.
"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    cross_attn_period=5,
    num_image_tokens=6404,  # 4 tiles x 1601 patches
    rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="llama-3.2-vision-11b-smoke",
    family="vlm",
    num_layers=10,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    cross_attn_period=5,
    num_image_tokens=16,
    rope_theta=10_000.0,
)

register(FULL, SMOKE)
