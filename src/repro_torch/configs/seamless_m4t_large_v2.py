"""SeamlessM4T-Large-v2: encoder-decoder multimodal (audio) transformer.

[arXiv:2308.11596; hf]  24L total (12 encoder + 12 decoder), d_model=1024,
16 heads (kv=16), d_ff=8192, vocab=256206.  The audio front end is a stub:
the serving engine feeds zero frame embeddings [batch, frames, d_model].  Decoder decodes with self-attn KV cache +
cross-attn memory.  Full attention -> long_500k skipped.
"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,
    num_encoder_layers=12,
    num_decoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="seamless-m4t-large-v2-smoke",
    family="encdec",
    num_layers=4,
    num_encoder_layers=2,
    num_decoder_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    rope_theta=10_000.0,
)

register(FULL, SMOKE)
