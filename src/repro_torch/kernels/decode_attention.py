"""Decode attention: the CUDA port of the Pallas kernel
``repro.kernels.decode_attention`` (``csrc/decode_attention.cu``).

One query token per slot against that slot's row of a dense cache: q
``(B, H, D)``, k / v ``(B, KV, S, D)``, GQA with g = H / KV, keys at
positions ``>= lengths[b]`` masked. A slot with no valid key (an idle decode
lane) gives 0, as the Pallas kernel does (``max(l, 1e-30)``). The reference
oracle is ``kernels/ref.py:decode_attention_ref``; it differs only on such
empty rows, where its softmax over an all-masked row gives the mean of V.

k and v may be strided views: the model passes its ``(B, S, KV, D)`` layer
slice of the ``(L, B, S, KV, D)`` cache as ``slice.transpose(1, 2)``, so the
cache is never copied. Only the head_dim axis must be contiguous.

The kernel splits each slot's keys across CTAs and merges the splits in the
same launch. ``plan`` picks the body (tensor cores for bf16 at head_dim 64,
128 and 256, with the whole group of up to 16 heads in one CTA; CUDA cores
for float32 and head_dim 16), the split count, the keys a split takes at
the full row and the heads a CTA from shapes alone; the kernel places each
slot's splits from its length on the device. The splits' scratch is
``decode_split.workspace``, shared with kernel 1.

The wrapper checks device, dtype, shape, strides and alignment and raises on
what the kernel does not take (a head_dim it has no variant for, only before
a launch). For a CUDA tensor it launches the kernel on
the current stream (``launch_count`` counts those launches); for a CPU tensor
it runs the plain PyTorch version in this module, and only then.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import build
from .decode_split import DecodePlan, cta_group, split_plan, workspace
from .flash_attention import _sm_count, check_head_dim, check_vector_aligned, masked_attention

#: launches of the CUDA kernel since the last reset
launch_count = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 64, 128, 256)
_MAX_GROUP = 16

#: the kernel's two bodies, by the code the launcher takes
CUDA_CORES, TENSOR_CORES = 0, 1
BODIES = {CUDA_CORES: "cuda_cores", TENSOR_CORES: "tensor_cores"}
_TC_HEAD_DIMS = (64, 128, 256)
#: CTAs an SM the split count aims at, by body, and the longest split of the
#: tensor-core body (two tiles, one for each warp group) where that target
#: allows. One CTA of the tensor-core body fits an SM, so its splits stay in
#: one wave: 2 splits of 320 keys at Qwen3-8B's shape, 10 of 64 at
#: RecurrentGemma-9B's. A slot of ``len`` keys takes round(len / split_keys)
#: of them (the kernel's ``split_range``), so Qwen3's rows under 480 keys run
#: unsplit and pay no merge. ``chip_smoke.py --sweep`` times every split
#: count, cold and inside the models' decode, at both serving shapes.
CTAS_PER_SM = {CUDA_CORES: 2.0, TENSOR_CORES: 1.0}
TC_SPLIT_KEYS = 64


class Plan(NamedTuple):
    body: int          # CUDA_CORES or TENSOR_CORES
    split: DecodePlan  # splits, keys a split, heads a CTA, head parts


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def plan(dtype: torch.dtype, b: int, h: int, kv: int, s: int, d: int, n_sms: int) -> Plan:
    """Body, split count, keys a split and heads a CTA from shapes only
    (never from ``lengths``): bf16 at head_dim 64, 128 and 256 (both serving
    paths) takes the tensor-core body, which holds the whole group of
    g <= 16 query heads in one CTA; float32 and head_dim 16 take the
    CUDA-core body, at most 8 heads a CTA (``decode_split.cta_group``).
    Splits over the cache length S by ``CTAS_PER_SM`` and
    ``TC_SPLIT_KEYS``; ``split_keys`` is a split's share of a full row, and
    a shorter row takes fewer splits (``CTAS_PER_SM``'s note)."""
    g = h // kv
    if dtype == torch.bfloat16 and d in _TC_HEAD_DIMS:
        return Plan(TENSOR_CORES, split_plan(b, kv, s, g, 1, n_sms, CTAS_PER_SM[TENSOR_CORES],
                                             TC_SPLIT_KEYS))
    group, parts = cta_group(g)
    return Plan(CUDA_CORES, split_plan(b, kv, s, group, parts, n_sms, CTAS_PER_SM[CUDA_CORES]))


def decode_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor,
    *, scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version: mask by length, float32 softmax."""
    d, s = q.shape[-1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    valid = torch.arange(s, device=q.device)[None, :] < lengths.long()[:, None]
    out = masked_attention(
        q[:, None], k.transpose(1, 2), v.transpose(1, 2), valid[:, None, :], scale
    )
    return out[:, 0]


def _fn():
    fn = build.load("decode_attention").decode_attention_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 7 + [i] * 9 + [ll] * 10 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn


def decode_attention(
    q: torch.Tensor,             # (B, H, D) — one new token per slot
    k: torch.Tensor,             # (B, KV, S, D) — any strides, head_dim contiguous
    v: torch.Tensor,
    lengths: torch.Tensor,       # (B,) int32 — valid entries per slot
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Returns ``(B, H, D)`` in q's dtype (contiguous)."""
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"decode_attention: q (B, H, D), k/v (B, KV, S, D), got "
            f"{tuple(q.shape)} / {tuple(k.shape)} / {tuple(v.shape)}"
        )
    b, h, d = q.shape
    kb, kv, s, kd = k.shape
    dev = q.device
    if any(t.device != dev for t in (k, v, lengths)):
        raise ValueError("decode_attention: all tensors must be on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"decode_attention takes float32 or bfloat16 q/k/v of one dtype, "
            f"got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if kb != b or kd != d:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if kv <= 0 or h % kv or h // kv > _MAX_GROUP:
        raise ValueError(
            f"decode_attention: H={h} must be a multiple of KV={kv} "
            f"with at most {_MAX_GROUP} query heads per KV head"
        )
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,) or not lengths.is_contiguous():
        raise ValueError(f"decode_attention: lengths must be contiguous int32 ({b},)")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("decode_attention: the head_dim axis must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"decode_attention: unsupported device {dev}")
    scale = scale if scale is not None else d ** -0.5
    if dev.type == "cpu":
        return decode_attention_plain(q, k, v, lengths, scale=scale)
    check_head_dim("decode_attention", d, _HEAD_DIMS)
    for t in (k, v):
        check_vector_aligned("decode_attention", t, t.stride()[:3])
    return _launch(q, k, v, lengths, scale, plan(q.dtype, b, h, kv, s, d, _sm_count(dev.index)))


def _launch(q, k, v, lengths, scale, p: Plan):
    """Launch the kernel under plan ``p`` (any plan the launcher can serve)."""
    global launch_count
    b, h, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    dev = q.device
    n_floats, n_counters = p.split.scratch(b, kv, d)
    part, counters = workspace(dev, n_floats, n_counters) if n_counters else (None, None)
    out = torch.empty((b, h, d), dtype=q.dtype, device=dev)
    err = _fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if counters is None else counters.data_ptr(),
        b, h, kv, s, d, p.body, p.split.splits, p.split.split_keys, p.split.group,
        q.stride(0), q.stride(1),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1),
        float(scale), _DTYPES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention: CUDA launch failed with error {err}")
    launch_count += 1
    return out
