"""xLSTM-1.3B: sLSTM + mLSTM recurrent blocks (no attention, no FFN).

[arXiv:2405.04517; unverified]  48 blocks, d_model=2048, 4 heads
(head_dim=512), vocab=50304, d_ff=0 (blocks carry their own up/down
projections).  xLSTM[7:1]: one sLSTM block per 8-block period, rest mLSTM.
O(1) recurrent state -> long_500k decode runs.
"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50304,
    slstm_period=8,
)

SMOKE = ModelConfig(
    name="xlstm-1.3b-smoke",
    family="ssm",
    num_layers=8,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=0,
    vocab_size=256,
    slstm_period=8,
)

register(FULL, SMOKE)
