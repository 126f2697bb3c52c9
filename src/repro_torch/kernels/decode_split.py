"""The split-key plan and scratch shared by the two decode-attention kernels
(paged, ``csrc/paged_decode_attention.cu``, and dense,
``csrc/decode_attention.cu``).

Both kernels split each row's keys across CTAs and merge the splits in the
same launch (``csrc/split_merge.cuh``). A row holds ``keys`` keys: the block
table's MB x page_size for the paged kernel, the cache length S for the dense
one. The split count comes from shapes only, never from ``lengths``, which
live on the device: the paged kernel places its splits at fixed edges of
``split_keys`` keys, the dense one from each slot's length on the device.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

#: a split covers a multiple of this many keys
SPLIT_TILE = 32
_CTA_GROUPS = (1, 2, 4, 8)


class DecodePlan(NamedTuple):
    splits: int      # CTAs along each row's keys
    split_keys: int  # keys a split covers at the full row (splits x split_keys >= its keys)
    group: int       # query heads a CTA holds
    parts: int       # CTAs along the query-head group: ceil(g / group)

    def scratch(self, b: int, kv: int, d: int) -> Tuple[int, int]:
        """(floats, counters) the splits' merge needs; (0, 0) unsplit."""
        if self.splits == 1:
            return 0, 0
        units = b * kv * self.parts
        return units * self.splits * self.group * (d + 2), units


def cta_group(g: int) -> Tuple[int, int]:
    """(heads a CTA, head parts) of the CUDA-core key loop: at most 8 heads
    a CTA, the register shape of g = 8."""
    group = next(x for x in _CTA_GROUPS if x >= min(g, 8))
    return group, -(-g // group)


def split_plan(b: int, kv: int, keys: int, group: int, parts: int, n_sms: int,
               ctas_per_sm: float = 1.5, max_split_keys: Optional[int] = None) -> DecodePlan:
    """Splits for about ``ctas_per_sm`` CTAs an SM over the
    ``b x kv x parts`` (slot, KV head, head part) units, and no more than
    a split of ``max_split_keys`` keys needs (where given); never more than
    the ``SPLIT_TILE``-key tiles of a full row, never fewer than 1."""
    tiles = max(1, -(-keys // SPLIT_TILE))
    if max_split_keys:
        tiles = min(tiles, max(1, -(-keys // max_split_keys)))
    splits = max(1, min(tiles, round(ctas_per_sm * n_sms / max(1, b * kv * parts))))
    return plan_with_splits(splits, keys, group, parts)


def plan_with_splits(splits: int, keys: int, group: int, parts: int) -> DecodePlan:
    """The plan of ``splits`` CTAs over a row of ``keys`` keys: each split
    covers an equal share of the row rounded up to ``SPLIT_TILE`` keys."""
    split_keys = -(-max(1, -(-keys // splits)) // SPLIT_TILE) * SPLIT_TILE
    return DecodePlan(splits, split_keys, group, parts)


_workspaces: Dict[Tuple[str, Optional[int]], Tuple[torch.Tensor, torch.Tensor]] = {}


def workspace(device: torch.device, n_floats: int, n_counters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The float32 partials and int32 tickets of split launches on
    ``device``: one pair per device, shared by both decode kernels, reused
    by every call whose plan fits and replaced by a larger one (tickets
    zeroed once, at allocation) when a plan needs more. The kernels leave
    every ticket at 0 when they end.

    One pair per device is safe because the port launches every kernel on
    one stream: two launches that share the scratch never overlap."""
    key = (device.type, device.index)
    cur = _workspaces.get(key)
    if cur is None or cur[0].numel() < n_floats or cur[1].numel() < n_counters:
        old_f, old_c = (cur[0].numel(), cur[1].numel()) if cur is not None else (0, 0)
        cur = (torch.empty(max(n_floats, old_f), dtype=torch.float32, device=device),
               torch.zeros(max(n_counters, old_c), dtype=torch.int32, device=device))
        _workspaces[key] = cur
    return cur
