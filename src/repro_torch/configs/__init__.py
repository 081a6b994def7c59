"""Model-zoo registry: ``--arch <id>`` resolves here."""

from .base import (ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K, TRAIN_4K,
                   ArchConfig, ShapeConfig, shape_applicable)
from .arctic_480b import CONFIG as ARCTIC_480B
from .h2o_danube_1_8b import CONFIG as H2O_DANUBE_1_8B
from .hymba_1_5b import CONFIG as HYMBA_1_5B
from .moonshot_v1_16b_a3b import CONFIG as MOONSHOT_V1_16B_A3B
from .musicgen_large import CONFIG as MUSICGEN_LARGE
from .phi3_mini_3_8b import CONFIG as PHI3_MINI_3_8B
from .pixtral_12b import CONFIG as PIXTRAL_12B
from .qwen2_5_3b import CONFIG as QWEN2_5_3B
from .qwen3_8b import CONFIG as QWEN3_8B
from .rwkv6_3b import CONFIG as RWKV6_3B

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in [
        MOONSHOT_V1_16B_A3B, ARCTIC_480B, PIXTRAL_12B, QWEN3_8B,
        PHI3_MINI_3_8B, QWEN2_5_3B, H2O_DANUBE_1_8B, RWKV6_3B, HYMBA_1_5B,
        MUSICGEN_LARGE,
    ]
}

SHAPES: dict[str, ShapeConfig] = {s.name: s for s in ALL_SHAPES}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


__all__ = ["ARCHS", "SHAPES", "ArchConfig", "ShapeConfig", "get_arch",
           "get_shape", "shape_applicable", "ALL_SHAPES", "TRAIN_4K",
           "PREFILL_32K", "DECODE_32K", "LONG_500K"]
