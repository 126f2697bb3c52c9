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

The wrapper checks device, dtype, shape, strides and alignment and raises on
what the kernel does not take. For a CUDA tensor it launches the kernel on
the current stream (``launch_count`` counts those launches); for a CPU tensor
it runs the plain PyTorch version in this module, and only then.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .flash_attention import check_vector_aligned, masked_attention

#: launches of the CUDA kernel since the last reset
launch_count = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 64, 128, 256)
_GROUPS = (1, 2, 4, 8, 16)


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


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
        fn.argtypes = [p] * 5 + [i] * 5 + [ll] * 10 + [ctypes.c_float, i, p]
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
    global launch_count
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
    if kb != b or kd != d or d not in _HEAD_DIMS:
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)} vs k {tuple(k.shape)}; "
            f"head_dim must be one of {_HEAD_DIMS}"
        )
    if kv <= 0 or h % kv or h // kv not in _GROUPS:
        raise ValueError(
            f"decode_attention: H={h} over KV={kv} must give a group of {_GROUPS}"
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
    for t in (k, v):
        check_vector_aligned("decode_attention", t, t.stride()[:3])
    out = torch.empty((b, h, d), dtype=q.dtype, device=dev)
    err = _fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, h, kv, s, d,
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
