"""Flash attention: the CUDA port of the Pallas kernel
``repro.kernels.flash_attention`` with a dense entry and a paged
chunked-prefill entry (``csrc/flash_attention.cu``: a tensor-core body for
bf16 at head_dim 64/128/256, a CUDA-core body for the rest; ``variant``).

* ``flash_attention(q, k, v, causal, window)`` — dense prefill attention,
  ``(B, H, Sq, D)`` x ``(B, KV, Sk, D)``, the reference kernel's contract
  (its oracle is ``kernels/ref.py:flash_attention_ref``); what every prefill
  stage of the dense KV layout runs (``models.attention.attention_any``),
  on strided views of the model's ``bshk`` tensors. With
  ``return_lse=True`` it also returns each row's float32 log-sum-exp
  ``(B, H, Sq)``, which the training path's backward
  (``kernels.flash_attention_bwd``) recomputes the softmax from; serving
  never asks for it, and the kernel then writes none.
* ``paged_chunk_attention(q, k_pages, v_pages, tables, starts, valid_lens)``
  — what the serving path runs for every prefill-chunk row of
  ``prefill_chunk`` / ``mixed_step``: queries ``(R, C, H, D)`` in the model's
  ``bshk`` layout at positions ``starts + arange(C)``, causal over the keys
  at positions ``< valid_lens`` read from one layer's ``(KV, P, bs, D)`` pool
  through the block table. A row with ``valid_lens == 0`` (a pad row) gives 0.

Each wrapper checks device, dtype, shape and contiguity and raises on what
the kernel does not take (a head_dim it has no variant for, only before a
launch: ``check_head_dim``). For a CUDA tensor it launches the kernel on the
current stream (``launch_count`` counts those launches, and
``launch_count_by_variant`` which device body served each: ``variant``
is the dispatch table, and the kernel serves the body and tile it is
given); for a CPU tensor it runs the plain PyTorch version in this module,
and only then.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from . import build

#: the kernel's device bodies
VARIANTS = ("cuda_cores", "tensor_cores")
#: launches of the CUDA kernel (both entries) since the last reset
launch_count = 0
#: the same launches by the body that served them
launch_count_by_variant = dict.fromkeys(VARIANTS, 0)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128, 256)
_TENSOR_CORE_HEAD_DIMS = (64, 128, 256)


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0
    for name in VARIANTS:
        launch_count_by_variant[name] = 0


def variant(dtype: torch.dtype, head_dim: int) -> str:
    """The device body that serves ``dtype`` at ``head_dim``: bf16 at 64,
    128 and 256 runs on the tensor cores (wgmma); float32 (which wgmma would
    compute as TF32) and bf16 at 16 and 32 on the CUDA cores. This is the
    one dispatch table: the launch passes its choice to the kernel."""
    if dtype == torch.bfloat16 and head_dim in _TENSOR_CORE_HEAD_DIMS:
        return "tensor_cores"
    return "cuda_cores"


#: the tensor-core body's CTA tiles, by the kernel's tile index
TILES = ("64 rows", "128 rows", "64 rows, keys split")
#: the tile index that asks the kernel for its CUDA-core body
CUDA_CORES = -1


def tensor_core_tile(units: int, n_rows: int, max_keys: int, head_dim: int, n_sms: int) -> int:
    """The tensor-core body's CTA tile (an index of ``TILES``), from shapes
    only. ``units`` is rows x KV heads, ``n_rows`` the (query, head) pairs
    of a unit (queries x group) and ``max_keys`` the most keys a row can
    have. 128-row CTAs share each K/V tile between two warpgroups but
    take more than one wave of the card's SMs sooner; past a wave, 64-row
    CTAs. Within a wave, a key range longer than two tiles goes to 64-row
    CTAs whose two warpgroups split every key tile (head_dim <= 128, where
    the doubled stages fit in shared memory)."""
    if units * -(-n_rows // 128) > n_sms:
        return 0
    if head_dim <= 128 and max_keys > 128:
        return 2
    return 1


def plan(dtype: torch.dtype, units: int, n_rows: int, max_keys: int, head_dim: int, n_sms: int) -> int:
    """The kernel's tile argument: ``CUDA_CORES`` where ``variant`` says so,
    else the tensor-core body's tile (``tensor_core_tile``)."""
    if variant(dtype, head_dim) == "cuda_cores":
        return CUDA_CORES
    return tensor_core_tile(units, n_rows, max_keys, head_dim, n_sms)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    mask = dense_mask(sq, sk, causal, window, q.device)
    out = masked_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        mask.expand(q.shape[0], sq, sk), scale,
    )
    return out.transpose(1, 2)


def flash_attention_lse_plain(
    q: torch.Tensor, k: torch.Tensor, *,
    causal: bool = True, window: int = 0, scale: Optional[float] = None,
) -> torch.Tensor:
    """The dense form's row log-sum-exp: logsumexp over the visible keys of
    ``scale q k^T`` in float32, (B, H, Sq); -inf for a row without keys."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("bkgqd,bksd->bkgqs", q.float().reshape(b, kv, h // kv, sq, d), k.float())
    s = torch.where(dense_mask(sq, sk, causal, window, q.device), s * scale, float("-inf"))
    return torch.logsumexp(s, dim=-1).reshape(b, h, sq)


def dense_mask(sq: int, sk: int, causal: bool, window: int, device) -> torch.Tensor:
    """(Sq, Sk) bool: key j is visible to query i (positions i and j)."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (qpos - kpos < window)
    return mask


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
    if kv <= 0 or h % kv:
        raise ValueError(f"flash_attention: H={h} not divisible by KV={kv}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head_dim axis must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {dev}")


def check_head_dim(what: str, d: int, head_dims) -> None:
    """The head_dims a kernel has variants for; checked before a launch only,
    since the plain version a CPU tensor takes computes any head_dim (the
    smoke StarCoder2's 12 among them)."""
    if d not in head_dims:
        raise ValueError(f"{what}: head_dim {d} not in {head_dims}")


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
            fn.argtypes = [p, p, p, p] + [i] * 8 + [ll] * 12 + [ctypes.c_float, i, i, p, p]
        else:
            fn.argtypes = [p] * 7 + [i] * 7 + [ll] * 10 + [ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _count(err: int, what: str, tile: int) -> None:
    global launch_count
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
    launch_count += 1
    launch_count_by_variant["cuda_cores" if tile == CUDA_CORES else "tensor_cores"] += 1


def flash_attention(
    q: torch.Tensor,          # (B, H, Sq, D)
    k: torch.Tensor,          # (B, KV, Sk, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Dense flash attention (positions 0..Sq-1 and 0..Sk-1): the output,
    or ``(output, lse)`` with ``return_lse``."""
    check_dense(q, k, v)
    scale = scale if scale is not None else q.shape[3] ** -0.5
    out, lse = torch.ops.repro_torch.flash_attention(q, k, v, causal, int(window), float(scale),
                                                     return_lse)
    return (out, lse) if return_lse else out


#: the reference's ``attention_any`` dispatch (``models/attention.py``): keys
#: up to ``DENSE_MAX_SEQ`` take the dense einsum, longer windowed keys the
#: band of ``window + Q_CHUNK`` keys a query chunk, the rest the chunked
#: einsum over every key
DENSE_MAX_SEQ, Q_CHUNK = 2048, 512


def attention_pairs(sq: int, sk: int, window: int) -> int:
    """The (query, key) pairs the reference's attention computes for a dense
    prefill of ``sq`` queries over ``sk`` keys: every pair, masked or not
    (causal block skipping is not subtracted), except a long sliding window,
    whose banded form computes ``window + Q_CHUNK`` keys a query."""
    if window > 0 and sk > DENSE_MAX_SEQ and window + Q_CHUNK < sk:
        return sq * (window + min(Q_CHUNK, sq))
    return sq * sk


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(), device_types="cpu")
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                       window: int, scale: float,
                       return_lse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The op behind the dense entry (checked arguments, ``scale``
    resolved): ``(out, lse)``, the log-sum-exp ``(B, H, Sq)`` float32 where
    ``return_lse``, else an empty float32 tensor (the kernel writes none).
    ``out`` has q's strides. CPU: the plain versions. CUDA: the kernel
    under ``plan``. Fake: the outputs; the kernel allocates nothing else.
    FLOPs: 4 B H D times ``attention_pairs(Sq, Sk, window)`` (two products
    over the pairs the reference computes)."""
    out = torch.empty_like(q)
    out.copy_(flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale))
    if not return_lse:
        return out, q.new_empty((0,), dtype=torch.float32)
    return out, flash_attention_lse_plain(q, k, causal=causal, window=window, scale=scale)


@flash_attention_op.register_kernel("cuda")
def _flash_attention_cuda(q, k, v, causal, window, scale, return_lse):
    d = q.shape[3]
    check_head_dim("flash_attention", d, _HEAD_DIMS)
    for t in (q, k, v):
        check_vector_aligned("flash_attention", t, t.stride()[:3])
    b, h, sq, _ = q.shape
    kv, sk = k.shape[1], k.shape[2]
    tile = plan(q.dtype, b * kv, sq * (h // kv), sk, d, _sm_count(q.device.index))
    lse = torch.empty((b, h, sq) if return_lse else (0,), dtype=torch.float32, device=q.device)
    out = _launch_dense(q, k, v, causal, window, scale, tile, lse if return_lse else None)
    return out, lse


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, causal, window, scale, return_lse):
    b, h, sq, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, sq) if return_lse else (0,), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_attention_flops(q, k, v, causal, window, *args, out_shape=None, **kwargs) -> int:
    b, h, sq, d = q
    return 4 * b * h * d * attention_pairs(sq, k[2], window)


def check_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """The dense entry's shape, device and dtype checks (the backward's too)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: q (B,H,Sq,D), k/v (B,KV,Sk,D)")
    b, h, _, d = q.shape
    kb, kv, _, kd = k.shape
    if kb != b or kd != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    _check_common(q, k, v, h, kv, d, (k, v))


def _launch_dense(q, k, v, causal, window, scale, tile, lse=None):
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    # q's own strides where q is a permuted dense tensor (a bshk prefill
    # passes q.transpose(1, 2)), so the caller's transpose back is free
    out = torch.empty_like(q)
    err = _fn("flash_attention_dense_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, kv, sq, sk, d, int(causal), int(window),
        q.stride(0), q.stride(1), q.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        float(scale), _DTYPES[q.dtype], tile, None if lse is None else lse.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _count(err, "flash_attention", tile)
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
    return torch.ops.repro_torch.paged_chunk_attention(
        q, k_pages, v_pages, block_tables, starts, valid_lens, float(scale))


@torch.library.custom_op("repro_torch::paged_chunk_attention", mutates_args=(),
                         device_types="cpu")
def paged_chunk_attention_op(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                             block_tables: torch.Tensor, starts: torch.Tensor,
                             valid_lens: torch.Tensor, scale: float) -> torch.Tensor:
    """The op behind ``paged_chunk_attention`` (checked arguments, ``scale``
    resolved). CPU: the plain version. CUDA: the kernel under ``plan``.
    Fake: the ``(R, C, H, D)`` output. FLOPs: 4 R H C (MB bs) D, every
    position of the table's pages counted for every query."""
    return paged_chunk_attention_plain(q, k_pages, v_pages, block_tables, starts, valid_lens,
                                       scale=scale).contiguous()


@paged_chunk_attention_op.register_kernel("cuda")
def _paged_chunk_attention_cuda(q, k_pages, v_pages, block_tables, starts, valid_lens, scale):
    r, c, h, d = q.shape
    kv, _, bs, _ = k_pages.shape
    check_head_dim("paged_chunk_attention", d, _HEAD_DIMS)
    for t in (q, k_pages, v_pages):
        check_vector_aligned("paged_chunk_attention", t, t.stride()[:3])
    tile = plan(q.dtype, r * kv, c * (h // kv), block_tables.shape[1] * bs, d,
                _sm_count(q.device.index))
    return _launch_paged(q, k_pages, v_pages, block_tables, starts, valid_lens, scale, tile)


@paged_chunk_attention_op.register_fake
def _paged_chunk_attention_fake(q, k_pages, v_pages, block_tables, starts, valid_lens, scale):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


@register_flop_formula(torch.ops.repro_torch.paged_chunk_attention)
def _paged_chunk_attention_flops(q, k_pages, v_pages, block_tables, *args, out_shape=None,
                                 **kwargs) -> int:
    r, c, h, d = q
    return 4 * r * h * c * block_tables[1] * k_pages[2] * d


def _launch_paged(q, k_pages, v_pages, block_tables, starts, valid_lens, scale, tile):
    r, c, h, d = q.shape
    kv, bs = k_pages.shape[0], k_pages.shape[2]
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
        float(scale), _DTYPES[q.dtype], tile,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _count(err, "paged_chunk_attention", tile)
    return out
