"""Model family → model class (counterpart of ``repro.models.registry``)."""
from __future__ import annotations

from typing import Any

from ..configs.base import ArchConfig


def get_model(cfg: ArchConfig, device="cuda") -> Any:
    """The port's model for ``cfg`` on ``device`` (default the CUDA device;
    ``device="cpu"`` runs the kernels' plain versions)."""
    if cfg.family in ("dense", "moe", "vlm"):
        from .transformer import TransformerLM

        return TransformerLM(cfg, device=device)
    if cfg.family == "hybrid":
        from .recurrentgemma import RecurrentGemma

        return RecurrentGemma(cfg, device=device)
    raise NotImplementedError(
        f"{cfg.name}: model family {cfg.family!r} is not ported yet (see ROADMAP.md)"
    )
