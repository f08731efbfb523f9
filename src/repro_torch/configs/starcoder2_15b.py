"""StarCoder2-15B: dense code model, GQA kv=4, RoPE.

[arXiv:2402.19173; hf]  40L, d_model=6144, 48 heads (GQA kv=4), d_ff=24576,
vocab=49152.  (StarCoder2-15B uses gelu MLP and learned+rope hybrid; we use
RoPE + gelu per the published config.)  Full attention -> long_500k skipped.
"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    act="gelu",
    use_qkv_bias=True,
    rope_theta=100_000.0,
)

SMOKE = ModelConfig(
    name="starcoder2-15b-smoke",
    family="dense",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    act="gelu",
    use_qkv_bias=True,
    rope_theta=10_000.0,
)

register(FULL, SMOKE)
