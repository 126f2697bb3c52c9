"""Model family → model class (counterpart of ``repro.models.registry``)."""
from __future__ import annotations

from typing import Any

from ..configs.base import ArchConfig


def model_class(cfg: ArchConfig) -> type:
    """The port's model class for ``cfg``'s family."""
    if cfg.family in ("dense", "moe", "vlm"):
        from .transformer import TransformerLM

        return TransformerLM
    if cfg.family == "ssm":
        from .xlstm import XLSTM

        return XLSTM
    if cfg.family == "hybrid":
        from .recurrentgemma import RecurrentGemma

        return RecurrentGemma
    if cfg.family == "audio":
        from .whisper import Whisper

        return Whisper
    raise KeyError(f"unknown model family {cfg.family!r}")


def get_model(cfg: ArchConfig, device="cuda") -> Any:
    """The port's model for ``cfg`` on ``device`` (default the CUDA device;
    ``device="cpu"`` runs the kernels' plain versions)."""
    return model_class(cfg)(cfg, device=device)
