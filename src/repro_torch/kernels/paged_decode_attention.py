"""Paged decode attention: the CUDA port of the Pallas kernel
``repro.kernels.paged_decode_attention`` (``csrc/paged_decode_attention.cu``).

One query token per slot against that slot's pages of one layer's
``(KV, P, bs, D)`` pool, addressed through a ``(B, MB)`` int32 block table
(-1 = unallocated), GQA with g = H / KV. Keys at positions ``>= lengths[b]``
and on -1 pages are masked; a slot with no valid key (an idle decode lane)
gives 0, as the Pallas kernel does. q and the output keep the model's
``bshk`` layout, ``(B, 1, H, D)``; the reference kernel's ``(B, H, D)`` is
the same memory with the unit axis dropped.

The kernel splits each slot's key range across CTAs and merges the splits
in the same launch. ``decode_plan`` picks the split count and the heads a
CTA from shapes alone (never from ``lengths``, which live on the device);
``workspace`` holds the splits' partials and tickets, allocated once per
device and grown only when a larger plan needs more.

The wrapper checks device, dtype, shape and contiguity and raises on what
the kernel does not take (a head_dim it has no variant for, only before a
launch). For a CUDA tensor it launches the kernel on the
current stream (``launch_count`` counts those launches); for a CPU tensor it
runs the plain PyTorch version in this module, and only then.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .decode_split import (  # noqa: F401  (kernel 1's plan names, shared with kernel 3)
    SPLIT_TILE,
    DecodePlan,
    _workspaces,
    cta_group,
    plan_with_splits,
    split_plan,
    workspace,
)
from .flash_attention import _sm_count, check_head_dim, check_vector_aligned, masked_attention

#: launches of the CUDA kernel since the last reset
launch_count = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
_MAX_GROUP = 16


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def decode_plan(b: int, h: int, kv: int, mb: int, page_size: int, n_sms: int) -> DecodePlan:
    """Split count, keys a split and heads a CTA from shapes only
    (``decode_split.split_plan`` over a row of the table's MB x page_size
    keys: about one and a half CTAs an SM; ``chip_smoke.py --sweep`` times
    every split count at the serving shape)."""
    group, parts = cta_group(h // kv)
    return split_plan(b, kv, mb * page_size, group, parts, n_sms)


def paged_decode_attention_plain(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    block_tables: torch.Tensor, lengths: torch.Tensor,
    *, scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version: gather the pages, mask, float32 softmax."""
    from ..models.cache import paged_gather_kv, paged_key_positions

    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    k_ctx, v_ctx = paged_gather_kv(k_pages, v_pages, block_tables)
    kpos = paged_key_positions(block_tables, lengths, k_pages.shape[2])
    return masked_attention(q, k_ctx, v_ctx, (kpos >= 0)[:, None, :], scale)


def _fn():
    fn = build.load("paged_decode_attention").paged_decode_attention_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 8 + [i] * 9 + [ll] * 8 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn


def paged_decode_attention(
    q: torch.Tensor,             # (B, 1, H, D) bshk — one new token per slot
    k_pages: torch.Tensor,       # (KV, P, bs, D) — one layer's pool (a view)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # (B, MB) int32; -1 = unallocated
    lengths: torch.Tensor,       # (B,) int32 — valid tokens per slot
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"paged_decode_attention: q must be (B, 1, H, D), got {tuple(q.shape)}")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("paged_decode_attention: pages must be (KV, P, bs, D)")
    b, _, h, d = q.shape
    kv, _, bs, kd = k_pages.shape
    dev = q.device
    if any(t.device != dev for t in (k_pages, v_pages, block_tables, lengths)):
        raise ValueError("paged_decode_attention: all tensors must be on one device")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(
            f"paged_decode_attention takes float32 or bfloat16 q/pages of one "
            f"dtype, got {q.dtype}/{k_pages.dtype}/{v_pages.dtype}"
        )
    if kd != d:
        raise ValueError(f"paged_decode_attention: head_dim {d} vs pool {kd}")
    if kv <= 0 or h % kv or h // kv > _MAX_GROUP:
        raise ValueError(
            f"paged_decode_attention: H={h} must be a multiple of KV={kv} "
            f"with at most {_MAX_GROUP} query heads per KV head"
        )
    for name, t, shape in (
        ("block_tables", block_tables, (b, block_tables.shape[-1])),
        ("lengths", lengths, (b,)),
    ):
        if t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be contiguous int32 {shape}")
    if q.stride(-1) != 1 or any(
        t.stride(-1) != 1 or t.stride(-2) != d for t in (k_pages, v_pages)
    ):
        raise ValueError(
            "paged_decode_attention: head_dim must be contiguous and each page "
            "a contiguous (bs, D) tile"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"paged_decode_attention: unsupported device {dev}")
    scale = scale if scale is not None else d ** -0.5
    if dev.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pages, v_pages, block_tables, lengths, scale=scale
        )
    check_head_dim("paged_decode_attention", d, _HEAD_DIMS)
    for t in (k_pages, v_pages):
        check_vector_aligned("paged_decode_attention", t, t.stride()[:3])
    plan = decode_plan(b, h, kv, block_tables.shape[1], bs, _sm_count(dev.index))
    return _launch(q, k_pages, v_pages, block_tables, lengths, scale, plan)


def _launch(q, k_pages, v_pages, block_tables, lengths, scale, plan: DecodePlan):
    global launch_count
    b, _, h, d = q.shape
    kv, bs = k_pages.shape[0], k_pages.shape[2]
    dev = q.device
    n_floats, n_counters = plan.scratch(b, kv, d)
    part, counters = workspace(dev, n_floats, n_counters) if n_counters else (None, None)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    err = _fn()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if counters is None else counters.data_ptr(),
        b, h, kv, d, bs, block_tables.shape[1], plan.splits, plan.split_keys, plan.group,
        q.stride(0), q.stride(2), out.stride(0), out.stride(2),
        k_pages.stride(0), k_pages.stride(1),
        v_pages.stride(0), v_pages.stride(1),
        float(scale), _DTYPES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"paged_decode_attention: CUDA launch failed with error {err}")
    launch_count += 1
    return out
