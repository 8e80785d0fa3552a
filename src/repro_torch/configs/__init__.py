"""Architecture registry (counterpart of ``repro/configs/__init__.py``):
``get_config("<arch-id>")`` resolves the ten ids the reference knows
(decoder, MoE, VLM, recurrent, hybrid and encoder-decoder); an unknown
id raises ``KeyError``."""
from __future__ import annotations

import importlib
from typing import Dict, List

from .base import (ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K, SHAPES,
                   TRAIN_4K, ArchConfig, MoEConfig, ShapeConfig, SSMConfig)

# arch-id -> module name (the reference's table)
_ARCH_MODULES: Dict[str, str] = {
    "mixtral-8x22b": "mixtral_8x22b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "granite-8b": "granite_8b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "internlm2-1.8b": "internlm2_1_8b",
    "qwen2-1.5b": "qwen2_1_5b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "rwkv6-7b": "rwkv6_7b",
    "zamba2-7b": "zamba2_7b",
}
ARCH_IDS: List[str] = list(_ARCH_MODULES)
#: the arch ids whose config modules are ported: all of them
PORTED = tuple(ARCH_IDS)


def get_config(arch: str) -> ArchConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(f".{_ARCH_MODULES[arch]}", __package__)
    return mod.CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


__all__ = [
    "ArchConfig", "MoEConfig", "SSMConfig", "ShapeConfig",
    "ALL_SHAPES", "SHAPES", "TRAIN_4K", "PREFILL_32K", "DECODE_32K",
    "LONG_500K", "ARCH_IDS", "PORTED", "get_config", "all_configs",
]
