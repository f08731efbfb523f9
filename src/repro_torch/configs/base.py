"""Model configuration (counterpart of ``repro.configs.base``).

Every architecture registers its exact published config and a reduced
"smoke" config of the same family for CPU tests.  ``ModelConfig`` is a
field-for-field copy of the reference's, so a config compares equal
across the two packages by ``dataclasses.asdict``.  The port registers
the reference's ten architectures.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_period: int = 1  # MoE FFN at layers where l % moe_period == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    # --- attention variants ---
    use_qkv_bias: bool = False
    use_qk_norm: bool = False
    sliding_window: int = 0  # 0 = full attention
    rope_theta: float = 1_000_000.0
    # --- hybrid (jamba): one attention layer per attn_period, rest SSM ---
    attn_period: int = 0
    ssm_d_state: int = 16
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    # --- xLSTM: one sLSTM per slstm_period, rest mLSTM ---
    slstm_period: int = 0
    # --- enc-dec ---
    num_encoder_layers: int = 0
    num_decoder_layers: int = 0
    # --- VLM: one cross-attn block per cross_attn_period ---
    cross_attn_period: int = 0
    num_image_tokens: int = 1024
    # --- misc ---
    norm_eps: float = 1e-5
    act: str = "silu"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    master_dtype: str = "float32"
    optimizer: str = "adamw"  # adamw | adafactor (398B-scale)
    remat_policy: str = "block"  # none | dots | block
    scan_layers: bool = True
    # serving
    decode_seq_shard: bool = True  # shard KV cache seq dim over model axis
    # int8 KV cache with per-(token, head) scales: half the cache bytes
    kv_cache_dtype: str = "bfloat16"  # bfloat16 | int8

    @property
    def d_inner(self) -> int:  # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context decode is tractable (SSM/hybrid/SWA)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def has_decoder(self) -> bool:
        return True

    def param_count(self) -> int:
        from repro_torch.models import registry

        return registry.param_count(self)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: dict[str, ModelConfig] = {}
_SMOKE: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig, smoke: ModelConfig) -> None:
    _REGISTRY[cfg.name] = cfg
    _SMOKE[cfg.name] = smoke


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def get_smoke_config(name: str) -> ModelConfig:
    return _SMOKE[name]


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """The input shapes that apply to this arch: ``long_500k`` only where
    long-context decode is tractable (``sub_quadratic``)."""
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        shapes.append("long_500k")
    return shapes
