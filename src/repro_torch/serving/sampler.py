"""Token samplers (counterpart of ``repro.serving.sampler``): objects mapping
per-row logits to token ids on the device, usable inside the fused decode
loop (``models.transformer.decode_steps``) and from host code.

Only greedy sampling is ported. The reference's ``TopPSampler`` draws from
``jax.random`` threefry streams folded from (seed, rid, token index); its
port waits for a threefry implementation in PyTorch (see ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Sampler:
    """Base sampler: (B, V) logits → (B,) int32 tokens."""

    #: whether per-row keys must be provided (no ported sampler needs them)
    stochastic = False

    def __call__(
        self, logits: torch.Tensor, keys: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class GreedySampler(Sampler):
    def __call__(
        self, logits: torch.Tensor, keys: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        # first index on ties, as jnp.argmax
        return torch.argmax(logits, dim=-1).to(torch.int32)


#: module-level default
greedy = GreedySampler()
