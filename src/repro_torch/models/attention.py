"""Reference attention with GQA and position-based masks (counterpart of
``attention`` and ``attention_paged`` in ``repro.models.attention``).

These are the plain versions the tests hold the port against the reference
with. The serving path itself calls the kernels in ``repro_torch.kernels``
(whose own plain versions run on CPU tensors); the two differ only on rows
with no valid key, where these functions return the mean of V (a softmax
over an all-``NEG_INF`` row, as the reference does) and the kernels return 0.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def attention(
    q: torch.Tensor,                  # (B, Sq, H, D)
    k: torch.Tensor,                  # (B, Sk, KV, D)
    v: torch.Tensor,                  # (B, Sk, KV, D)
    *,
    q_positions: torch.Tensor,        # (B, Sq) int32
    k_positions: torch.Tensor,        # (B, Sk) int32; -1 = invalid slot
    causal: bool = True,
    window: int = 0,                  # 0 = unbounded
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Masked multi-head attention with grouped KV heads. Masks: invalid
    ``k_pos < 0``; causal ``k_pos > q_pos``; window ``q_pos - k_pos >= window``
    (when window > 0)."""
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    if h % kv != 0:
        raise ValueError(f"q heads {h} not divisible by kv heads {kv}")
    g = h // kv
    scale = scale if scale is not None else d ** -0.5

    qf = (q.float() * scale).reshape(b, sq, kv, g, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())

    qpos = q_positions[:, None, None, :, None]
    kpos = k_positions[:, None, None, None, :]
    mask = kpos >= 0
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (qpos - kpos < window)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def attention_paged(
    q: torch.Tensor,                  # (B, Sq, H, D)
    k_pages: torch.Tensor,            # (KV, P, bs, D) — one layer's page pool
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,       # (B, MB) int32; -1 = unallocated
    *,
    q_positions: torch.Tensor,        # (B, Sq) int32
    valid_lengths: torch.Tensor,      # (B,) int32 — valid tokens per slot,
                                      # counted *after* this step's KV writes
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention against a paged KV cache: gather each slot's pages into its
    logical (MB·bs) sequence and mask unallocated/past-length positions."""
    from .cache import paged_gather_kv, paged_key_positions

    k_ctx, v_ctx = paged_gather_kv(k_pages, v_pages, block_tables)
    k_positions = paged_key_positions(block_tables, valid_lengths, k_pages.shape[2])
    return attention(
        q, k_ctx, v_ctx,
        q_positions=q_positions,
        k_positions=k_positions,
        causal=causal,
        scale=scale,
    )
