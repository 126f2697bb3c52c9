"""Architecture registry of the port: ``get_config(name)`` /
``get_smoke_config(name)``.

Only the configurations the port serves are registered; the reference
package's other architectures join as their model families are ported.
"""
from __future__ import annotations

import importlib
from typing import List

from .base import ArchConfig

ARCH_IDS: List[str] = ["qwen3_8b", "recurrentgemma_9b"]


def _module(name: str):
    key = name.replace("-", "_")
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; the port has {ARCH_IDS}")
    return importlib.import_module(f".{key}", __package__)


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    return _module(name).SMOKE_CONFIG
