"""Architecture + shape configuration for the model zoo."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | vlm | ssm | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int                 # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads

    # attention flavor
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: Optional[int] = None      # SWA window (tokens)
    rope_theta: float = 1e4

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_dense_residual: bool = False          # arctic: parallel dense FFN
    capacity_factor: float = 1.25

    # SSM / hybrid
    attn_free: bool = False                   # rwkv6
    hybrid_ssm: bool = False                  # hymba: parallel attn+SSM heads
    ssm_state: int = 0
    rwkv_head_dim: int = 64

    # modality frontend stub (vlm / audio): inputs are precomputed embeddings
    embedding_stub: bool = False

    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    # training knobs (perf-tunable; defaults overridden per arch/shape)
    grad_accum: int = 1
    remat: bool = True
    optimizer: str = "adamw"                  # adamw | adafactor
    param_dtype: str = "bfloat16"
    source: str = ""

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(1, self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def reduced(self) -> "ArchConfig":
        """A tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2,
            d_model=64,
            n_heads=0 if self.attn_free else 4,
            n_kv_heads=0 if self.attn_free else max(1, min(self.n_kv_heads, 2)),
            head_dim=0 if self.attn_free else 16,
            d_ff=128,
            vocab_size=256,
            n_experts=min(self.n_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            # drop-free capacity so prefill/decode agree exactly in tests
            capacity_factor=float(max(1, self.n_experts)),
            sliding_window=16 if self.sliding_window else None,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            rwkv_head_dim=16 if self.attn_free else self.rwkv_head_dim,
            grad_accum=1,
        )

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        per_layer = 0
        if not self.attn_free:
            q = d * self.n_heads * self.hd
            kv = 2 * d * self.n_kv_heads * self.hd
            o = self.n_heads * self.hd * d
            per_layer += q + kv + o
        if self.attn_free:
            # rwkv6 time-mix: r,k,v,g,o (5 d*d) + decay/shift loras (small)
            per_layer += 5 * d * d + 2 * d * 64
            per_layer += 2 * d * f // 2 + d * f  # channel-mix approx
        elif self.hybrid_ssm:
            di = self.n_heads * self.hd
            per_layer += 2 * d * di + di * (2 * self.ssm_state + 2) + di * d
        if self.is_moe:
            experts = self.n_experts * 3 * d * f
            router = d * self.n_experts
            per_layer += experts + router
            if self.moe_dense_residual:
                per_layer += 3 * d * f
        elif not self.attn_free:
            per_layer += 3 * d * f              # swiglu
        per_layer += 2 * d                      # norms
        total = self.n_layers * per_layer + v * d + 2 * d
        if not self.tie_embeddings:
            total += v * d
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        inactive = self.n_layers * (self.n_experts - self.experts_per_token) \
            * 3 * d * f
        return self.param_count() - inactive


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                    # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524288, 1)

ALL_SHAPES = [TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K]


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """long_500k needs sub-quadratic attention / bounded state (DESIGN.md
    §Arch-applicability)."""
    if shape.name == "long_500k":
        sub_quadratic = arch.attn_free or arch.hybrid_ssm or \
            (arch.sliding_window is not None)
        if not sub_quadratic:
            return False, ("pure full-attention arch: 500k-context decode "
                           "requires sub-quadratic attention (skip noted in "
                           "DESIGN.md)")
    return True, ""
