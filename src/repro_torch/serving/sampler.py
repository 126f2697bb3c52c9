"""Token samplers (counterpart of ``repro.serving.sampler``): objects mapping
per-row logits to token ids on the device, usable inside the fused decode
loop (``models.transformer.decode_steps``) and from host code.

  * A ``Sampler`` is a frozen dataclass mapping (B, V) logits to (B,) token
    ids.
  * Stochastic samplers take one threefry key **per batch row** (``keys``:
    (B, 2), see ``serving.threefry``). The engine folds a base key with the
    request id and the token index, so a request's stream is a pure function
    of ``(seed, rid, token_index)`` — independent of horizon grouping, slot
    placement, batch composition and KV layout — and equals the reference's
    JAX stream for the same seed.
  * ``greedy`` is the module-level default; ``sample_top_p`` keeps the
    reference's single-key functional form.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .threefry import categorical, fold_in


def fold_row_keys(
    base_key: torch.Tensor, rids: torch.Tensor, steps: torch.Tensor
) -> torch.Tensor:
    """Per-row sampling keys (B, 2): fold the engine's base key (2,) with
    each row's request id, then with its token index (``rids``: (B,)
    integer tensor; ``steps``: (B,), or (..., B) for several indices of each
    row at once, giving keys (..., B, 2))."""
    return fold_in(fold_in(base_key, rids), steps)


def _top_p_filter(
    logits: torch.Tensor, top_p: float, temperature: float
) -> torch.Tensor:
    """(B, V) logits → (B, V) logits with the nucleus tail set to -inf.

    The cutoff is the sorted logit at index ``sum(cum < top_p)``. When the
    float32 cumulative sum ends under ``top_p`` that index is V, past the
    end: the reference's ``take_along_axis`` then reads NaN (its fill mode),
    every comparison with it fails and the whole row becomes -inf, so the
    draw returns token 0. The port gives that row a NaN cutoff the same way,
    with an explicit ``where`` rather than a gather past the end."""
    # the reference's scalars are float32: divide and compare with them
    temp = float(np.float32(max(temperature, 1e-6)))
    logits = logits / temp
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    v = logits.shape[-1]
    idx = (cum < float(np.float32(top_p))).sum(dim=-1, keepdim=True)
    cutoff = torch.gather(sorted_logits, -1, idx.clamp(max=v - 1))
    cutoff = torch.where(idx < v, cutoff, float("nan"))
    return torch.where(logits >= cutoff, logits, float("-inf"))


@dataclasses.dataclass(frozen=True)
class Sampler:
    """Base sampler: (B, V) logits → (B,) int32 tokens."""

    #: whether ``keys`` must be provided (drives the engine's base key)
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


@dataclasses.dataclass(frozen=True)
class TopPSampler(Sampler):
    """Nucleus sampling with per-row key threading."""

    top_p: float = 0.9
    temperature: float = 1.0
    stochastic = True

    def __call__(
        self, logits: torch.Tensor, keys: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        if keys is None:
            raise ValueError(
                "TopPSampler needs per-row PRNG keys; pass keys=(B, 2) "
                "(the engine threads them from its seed)"
            )
        filtered = _top_p_filter(logits, self.top_p, self.temperature)
        return categorical(keys, filtered).to(torch.int32)


#: module-level default
greedy = GreedySampler()


def sample_top_p(
    logits: torch.Tensor, key: torch.Tensor, top_p: float = 0.9,
    temperature: float = 1.0,
) -> torch.Tensor:
    """Nucleus sampling with one key (2,) for the whole batch (the legacy
    form): the gumbel noise spans (B, V) by its linear index. (B, V) →
    (B,)."""
    filtered = _top_p_filter(logits, top_p, temperature)
    return categorical(key, filtered).to(torch.int32)
