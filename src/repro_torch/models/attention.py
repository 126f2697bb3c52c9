"""Attention with GQA and position-based masks (counterpart of
``attention``, ``attention_any``, ``attention_cross`` and
``attention_paged`` in ``repro.models.attention``).

``attention``, ``attention_cross_plain`` and ``attention_paged`` are the
plain versions the tests hold the port against the reference with. The serving path itself calls the
kernels in ``repro_torch.kernels`` (whose own plain versions run on CPU
tensors) — ``attention_any`` routes a dense prefill to one; the two differ
only on rows with no valid key, where these functions return the mean of V
(a softmax over an all-``NEG_INF`` row, as the reference does) and the
kernels return 0.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..distributed import spmd
from ..distributed.sharding import is_dtensor
from ..kernels.decode_attention import decode_attention
from ..kernels.flash_attention import flash_attention, paged_chunk_attention
from ..kernels.flash_attention_bwd import FlashAttentionFn

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


def attention_any(
    q: torch.Tensor,                  # (B, S, H, D)
    k: torch.Tensor,                  # (B, S, KV, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Self-attention of a dense prefill, ``bshk`` in and out. Query i and
    key i sit at position i and every key is valid (the reference passes
    ``k_positions = positions``), so ``causal`` and ``window`` are the whole
    mask. Runs the dense entry of ``kernels.flash_attention`` on
    ``(B, H, S, D)`` views of the same memory (no copy), whose plain version
    takes CPU tensors. Query rows past a prompt's length are padding: their
    output is computed and ignored. Where autograd records (grad enabled and
    an input requires grad: the training forward), the same launch goes
    through ``FlashAttentionFn``, which also saves the row log-sum-exp and
    differentiates with the backward kernel; serving calls never do. On
    DTensors it runs on each rank's batch and heads (``distributed.spmd``;
    K/V stay on the heads their projection left them on: the reference's
    batch-only constraint on a long prompt's K/V gathers heads a rank already
    holds, the port's gather would double it with the virtual heads of
    ``spmd.gqa_kv``); queries
    sharded by sequence over the TP axis (a prefill whose heads do not
    divide it, ``spmd.sequence_parallel``) attend over the gathered keys
    from their positions (``_attention_from``)."""
    if is_dtensor(q):
        if spmd.is_seq_sharded(q):
            return spmd.seq_attention(
                lambda q, k, v, lo: _attention_from(q, k, v, lo, causal=causal, window=window,
                                                    scale=scale),
                q, k, v)
        return spmd.attention(
            lambda q, k, v: attention_any(q, k, v, causal=causal, window=window, scale=scale),
            q, k, v)
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        out = FlashAttentionFn.apply(qh, kh, vh, causal, window, scale)
    else:
        out = flash_attention(qh, kh, vh, causal=causal, window=window, scale=scale)
    return out.transpose(1, 2)


def _attention_from(q, k, v, lo: int, *, causal: bool, window: int, scale: Optional[float]):
    """Plain ``bshk`` queries at positions ``lo ..`` over keys at ``0 ..``
    (a sequence shard's queries over every key, ``spmd.seq_attention``):
    without a mask kernel 2's dense entry; causal, its paged-chunk entry,
    whose rows start at a position, over a pool of one page a row (each
    row's keys), as a chunk of a prompt attends over its slot."""
    if not causal:
        return attention_any(q, k, v, causal=False, scale=scale)
    if window > 0 or torch.is_grad_enabled():
        raise NotImplementedError("a sequence shard's queries attend causally without a window, "
                                  "in a prefill")
    b, sk = k.shape[:2]
    pool = lambda t: t.permute(2, 0, 1, 3).contiguous()          # (KV, B pages, Sk, D)
    row = lambda x: torch.full((b,), x, dtype=torch.int32, device=q.device)
    tables = torch.arange(b, dtype=torch.int32, device=q.device)[:, None]
    return paged_chunk_attention(q.contiguous(), pool(k), pool(v), tables, row(lo), row(sk),
                                 scale=scale)


def decode_any(
    q: torch.Tensor,                  # (B, H, D) — one token a slot
    k_cache: torch.Tensor,            # (B, S, KV, D) — a layer of a dense cache
    v_cache: torch.Tensor,
    lengths: torch.Tensor,            # (B,) int32 — valid keys a slot
) -> torch.Tensor:
    """One token a slot against a dense cache's layer through kernel 3 on
    ``(B, KV, S, D)`` views of the cache (no copy); on DTensors each rank
    decodes its shard of the cache (``distributed.spmd.decode_attention``:
    a sequence-sharded cache merges the shards' partials)."""
    def run(q, k, v, lengths, lse: bool):
        out = decode_attention(q, k, v, lengths, return_lse=lse)
        return out if lse else (out, None)

    if is_dtensor(k_cache):
        return spmd.decode_attention(run, q, k_cache, v_cache, lengths)
    return decode_attention(q, k_cache.transpose(1, 2), v_cache.transpose(1, 2), lengths)


def attention_cross(
    q: torch.Tensor,                  # (B, Sq, H, D)
    k: torch.Tensor,                  # (B, Sk, KV, D)
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Bidirectional or cross attention (Whisper's encoder and cross blocks),
    ``bshk`` in and out, every key visible to every query and Sq free of
    Sk: kernel 2's dense entry without a mask (``attention_any`` with
    ``causal=False``), and under autograd its backward kernel."""
    return attention_any(q, k, v, causal=False, scale=scale)


def attention_cross_plain(
    q: torch.Tensor,                  # (B, Sq, H, D)
    k: torch.Tensor,                  # (B, Sk, KV, D)
    v: torch.Tensor,
    k_valid: Optional[torch.Tensor] = None,   # (B, Sk) bool
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The plain version (the reference's ``attention_cross``): float32
    softmax attention over the keys ``k_valid`` allows (all by default)."""
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    g = h // kv
    scale = scale if scale is not None else d ** -0.5
    qf = (q.float() * scale).reshape(b, sq, kv, g, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    if k_valid is not None:
        scores = torch.where(k_valid[:, None, None, None, :], scores, NEG_INF)
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
