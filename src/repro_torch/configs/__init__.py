"""Architecture registry of the port: ``get_config(name)`` /
``get_smoke_config(name)``.

The reference's architectures in its order, less those whose model family
is not ported yet (xLSTM, Whisper), plus the paper's own LLaMA-65B (used by
the serving reproduction, not part of the reference's 40-cell table).
"""
from __future__ import annotations

import importlib
from typing import List

from .base import ArchConfig

ARCH_IDS: List[str] = [
    "mixtral_8x22b",
    "olmoe_1b_7b",
    "qwen3_8b",
    "starcoder2_7b",
    "granite_3_8b",
    "nemotron_4_15b",
    "qwen2_vl_7b",
    "recurrentgemma_9b",
]

EXTRA_IDS = ["llama_65b"]


def _module(name: str):
    key = name.replace("-", "_")
    if key not in ARCH_IDS + EXTRA_IDS:
        raise KeyError(f"unknown arch {name!r}; the port has {ARCH_IDS + EXTRA_IDS}")
    return importlib.import_module(f".{key}", __package__)


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    return _module(name).SMOKE_CONFIG
