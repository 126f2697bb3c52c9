"""The four assigned input-shape cells and family applicability rules."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from .base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def cell_applicable(cfg: ArchConfig, shape: ShapeCell) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped). Skips follow DESIGN.md §Arch-applicability:
    ``long_500k`` requires sub-quadratic attention; every assigned arch has a
    decode step (whisper is enc-dec, not encoder-only)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full quadratic attention — 500k decode KV infeasible (per brief)"
    return True, ""


def applicable_cells(cfg: ArchConfig) -> List[ShapeCell]:
    return [s for s in SHAPES if cell_applicable(cfg, s)[0]]
