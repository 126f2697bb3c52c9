"""Flash attention: the CUDA port of the Pallas kernel
``repro.kernels.flash_attention`` with a dense entry and a paged
chunked-prefill entry (``csrc/flash_attention.cu``; one device body).

* ``flash_attention(q, k, v, causal, window)`` — dense prefill attention,
  ``(B, H, Sq, D)`` x ``(B, KV, Sk, D)``, the reference kernel's contract
  (its oracle is ``kernels/ref.py:flash_attention_ref``).
* ``paged_chunk_attention(q, k_pages, v_pages, tables, starts, valid_lens)``
  — what the serving path runs for every prefill-chunk row of
  ``prefill_chunk`` / ``mixed_step``: queries ``(R, C, H, D)`` in the model's
  ``bshk`` layout at positions ``starts + arange(C)``, causal over the keys
  at positions ``< valid_lens`` read from one layer's ``(KV, P, bs, D)`` pool
  through the block table. A row with ``valid_lens == 0`` (a pad row) gives 0.

Each wrapper checks device, dtype, shape and contiguity and raises on what
the kernel does not take. For a CUDA tensor it launches the kernel on the
current stream (``launch_count`` counts those launches); for a CPU tensor it
runs the plain PyTorch version in this module, and only then.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

#: launches of the CUDA kernel (both entries) since the last reset
launch_count = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


# --------------------------------------------------------------------------- #
# Plain PyTorch versions                                                      #
# --------------------------------------------------------------------------- #
def masked_attention(
    q: torch.Tensor,          # (B, Sq, H, D)
    k: torch.Tensor,          # (B, Sk, KV, D)
    v: torch.Tensor,
    mask: torch.Tensor,       # (B, Sq, Sk) bool — key visible to query
    scale: float,
) -> torch.Tensor:
    """Float32 softmax attention under an explicit mask; a query with no
    visible key gives 0 (the kernels' ``max(l, 1e-30)`` rule)."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    qf = q.float().reshape(b, sq, kv, g, d) * scale
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    m = mask[:, None, None]
    s = torch.where(m, s, float("-inf"))
    mx = s.amax(dim=-1, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    p = torch.where(m, torch.exp(s - mx), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgqs,bskd->bkgqd", p, v.float()) / l
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, scale: Optional[float] = None,
) -> torch.Tensor:
    """Dense form: q (B, H, Sq, D), k/v (B, KV, Sk, D) → (B, H, Sq, D)."""
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    scale = scale if scale is not None else d ** -0.5
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (qpos - kpos < window)
    out = masked_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        mask.expand(q.shape[0], sq, sk), scale,
    )
    return out.transpose(1, 2)


def paged_chunk_attention_plain(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    block_tables: torch.Tensor, starts: torch.Tensor, valid_lens: torch.Tensor,
    *, scale: Optional[float] = None,
) -> torch.Tensor:
    """Paged chunk form: q (R, C, H, D) → (R, C, H, D)."""
    from ..models.cache import paged_gather_kv, paged_key_positions

    c, d = q.shape[1], q.shape[3]
    scale = scale if scale is not None else d ** -0.5
    k_ctx, v_ctx = paged_gather_kv(k_pages, v_pages, block_tables)
    kpos = paged_key_positions(block_tables, valid_lens, k_pages.shape[2])
    qpos = starts.long()[:, None] + torch.arange(c, device=q.device)[None, :]
    mask = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qpos[:, :, None])
    return masked_attention(q, k_ctx, v_ctx, mask, scale)


# --------------------------------------------------------------------------- #
# Kernel wrappers                                                             #
# --------------------------------------------------------------------------- #
def _check_common(q, k, v, h, kv, d, tensors):
    dev = q.device
    if any(t.device != dev for t in tensors):
        raise ValueError("flash_attention: all tensors must be on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention takes float32 or bfloat16 q/k/v of one dtype, "
            f"got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {_HEAD_DIMS}")
    if kv <= 0 or h % kv:
        raise ValueError(f"flash_attention: H={h} not divisible by KV={kv}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head_dim axis must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {dev}")


def check_vector_aligned(what: str, t: torch.Tensor, strides) -> None:
    """The kernels read 16-byte vectors along head_dim: the base pointer and
    every stride they step by must keep that alignment."""
    vec = 16 // t.element_size()
    if t.data_ptr() % 16 or any(s % vec for s in strides):
        raise ValueError(
            f"{what}: tensor must be 16-byte aligned with strides that are "
            f"multiples of {vec} elements, got strides {tuple(t.stride())}"
        )


def _fn(name: str):
    lib = build.load("flash_attention")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == "flash_attention_dense_launch":
            fn.argtypes = [p, p, p, p] + [i] * 8 + [ll] * 12 + [
                ctypes.c_float, i, p,
            ]
        else:
            fn.argtypes = [p] * 7 + [i] * 7 + [ll] * 10 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def flash_attention(
    q: torch.Tensor,          # (B, H, Sq, D)
    k: torch.Tensor,          # (B, KV, Sk, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Dense flash attention (positions 0..Sq-1 and 0..Sk-1)."""
    global launch_count
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: q (B,H,Sq,D), k/v (B,KV,Sk,D)")
    b, h, sq, d = q.shape
    kb, kv, sk, kd = k.shape
    if kb != b or kd != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    _check_common(q, k, v, h, kv, d, (k, v))
    scale = scale if scale is not None else d ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale)
    for t in (q, k, v):
        check_vector_aligned("flash_attention", t, t.stride()[:3])
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    err = _fn("flash_attention_dense_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, kv, sq, sk, d, int(causal), int(window),
        q.stride(0), q.stride(1), q.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        float(scale), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "flash_attention")
    launch_count += 1
    return out


def paged_chunk_attention(
    q: torch.Tensor,             # (R, C, H, D)
    k_pages: torch.Tensor,       # (KV, P, bs, D) — one layer's pool
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # (R, MB) int32
    starts: torch.Tensor,        # (R,) int32 — position of each row's first query
    valid_lens: torch.Tensor,    # (R,) int32 — valid keys per row (after writes)
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal chunked-prefill attention over the paged pool."""
    global launch_count
    if q.dim() != 4 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            "paged_chunk_attention: q (R,C,H,D), pages (KV,P,bs,D)"
        )
    r, c, h, d = q.shape
    kv, _, bs, kd = k_pages.shape
    if kd != d:
        raise ValueError(f"paged_chunk_attention: head_dim {d} vs pool {kd}")
    _check_common(q, k_pages, v_pages, h, kv, d, (k_pages, v_pages, block_tables, starts, valid_lens))
    for name, t, shape in (
        ("block_tables", block_tables, (r, block_tables.shape[-1])),
        ("starts", starts, (r,)),
        ("valid_lens", valid_lens, (r,)),
    ):
        if t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"paged_chunk_attention: {name} must be contiguous int32 {shape}")
    if any(t.stride(-2) != d for t in (k_pages, v_pages)):
        raise ValueError("paged_chunk_attention: each page must be a contiguous (bs, D) tile")
    scale = scale if scale is not None else d ** -0.5
    if q.device.type == "cpu":
        return paged_chunk_attention_plain(
            q, k_pages, v_pages, block_tables, starts, valid_lens, scale=scale
        )
    for t in (q, k_pages, v_pages):
        check_vector_aligned("paged_chunk_attention", t, t.stride()[:3])
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    err = _fn("flash_attention_paged_launch")(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), starts.data_ptr(), valid_lens.data_ptr(),
        out.data_ptr(),
        r, c, h, kv, d, bs, block_tables.shape[1],
        q.stride(0), q.stride(1), q.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        k_pages.stride(0), k_pages.stride(1),
        v_pages.stride(0), v_pages.stride(1),
        float(scale), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "paged_chunk_attention")
    launch_count += 1
    return out
