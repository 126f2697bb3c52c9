"""Backward of flash attention's dense entry: the CUDA kernel
``csrc/flash_attention_bwd.cu`` and the autograd function of the training
path.

The reference trains through ``jax.grad`` of ``models/attention.py:
attention`` (the einsum that ``attention_any`` takes); the port's forward is
kernel 2's dense entry, so its gradient is a kernel too. There is no Pallas
kernel for it.

* ``flash_attention_backward(q, k, v, out, lse, d_out, causal, window,
  scale) -> (dq, dk, dv)`` — the wrapper: ``q``, ``out``, ``d_out``
  ``(B, H, Sq, D)``, ``k``, ``v`` ``(B, KV, Sk, D)``, ``lse`` the forward's
  float32 ``(B, H, Sq)``. bf16 at head_dim 64 and 128 runs the wgmma body,
  the rest a CUDA-core body (``variant``; ``launch_count_by_variant``
  counts launches by body). ``backward_plan`` says from shapes and mask
  what a call launches: the body, the tiles, the grids, the scratch, and
  the device kernels in order (the dQ pass, the dK/dV pass and, where the
  plan splits the GQA group over CTAs, the fixed-order sum of the group's
  partials; ``split_group``). It honours the strides of ``q``, ``k``,
  ``v`` and ``out`` (head_dim contiguous and 16-byte vectors, as the
  forward takes them; the model passes ``bshk`` tensors seen as
  ``(B, H, S, D)``), makes ``d_out`` contiguous only where its strides
  break the vector alignment, and returns gradients laid out like their
  inputs. It checks as the forward checks and raises on what the kernel
  does not take (head_dim other than 16, 32, 64 or 128, before a launch).
  For a CUDA tensor it launches the plan's kernels (``launch_count``
  counts the calls, each all the kernels of its plan); for a CPU tensor it
  runs ``flash_attention_backward_plain``, and only then.
* ``FlashAttentionFn`` — ``torch.autograd.Function`` whose forward runs the
  dense entry with the log-sum-exp and saves ``q, k, v, out, lse``, and
  whose backward calls ``flash_attention_backward``. On CPU tensors both
  sides run the plain versions.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from . import build
from .flash_attention import (
    _DTYPES,
    _sm_count,
    check_dense,
    check_head_dim,
    check_vector_aligned,
    dense_mask,
    flash_attention,
)

#: the kernel's device bodies
VARIANTS = ("cuda_cores", "tensor_cores")
#: launches of the backward kernel (one a call: every pass of the plan) since the last reset
launch_count = 0
#: the same launches by the body that served them
launch_count_by_variant = dict.fromkeys(VARIANTS, 0)

_HEAD_DIMS = (16, 32, 64, 128)
_TENSOR_CORE_HEAD_DIMS = (64, 128)
#: rows a CTA owns (queries in the dQ pass, keys in the dK/dV pass) and
#: rows of each tile its inner loop streams (keys, queries), by body
_TILES = {"tensor_cores": (64, 64), "cuda_cores": (64, 32)}
#: CTAs of the wgmma body an SM holds at once, by head_dim (shared memory
#: and registers: 2 at 128, 3 at 64)
_CTAS_PER_SM = {64: 3, 128: 2}
#: the dK/dV pass splits the group where its heaviest CTA would run this
#: many times the work a CTA slot gets on average (the split pays the
#: partials' traffic and a second kernel)
_SPLIT_IMBALANCE = 1.25
_SUM_THREADS = 256


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0
    for name in VARIANTS:
        launch_count_by_variant[name] = 0


def variant(dtype: torch.dtype, head_dim: int) -> str:
    """The device body that serves ``dtype`` at ``head_dim``: bf16 at 64 and
    128 on the tensor cores (wgmma); float32 (which the tensor cores would
    compute as TF32) and bf16 at 16 and 32 on the CUDA cores."""
    if dtype == torch.bfloat16 and head_dim in _TENSOR_CORE_HEAD_DIMS:
        return "tensor_cores"
    return "cuda_cores"


class BackwardPlan(NamedTuple):
    """What one call of the backward launches, from shapes and mask alone."""
    body: str                               # a name of VARIANTS
    split_group: bool                       # dK/dV: a CTA per query head, partials summed in head order
    rows: int                               # rows a CTA owns: queries (dQ pass), keys (dK/dV pass)
    cols: int                               # rows of a streamed tile: keys (dQ pass), queries (dK/dV pass)
    kernels: Tuple[str, ...]                # device kernels a call launches, in order
    grids: Tuple[Tuple[int, int, int], ...] # each kernel's grid (x, y, z)
    scratch_bytes: int                      # Delta, and the float32 partials where split


def query_tiles(t0: int, sq: int, sk: int, causal: bool, window: int, rows: int = 64) -> int:
    """Query tiles of ``rows`` the dK/dV pass runs for the key tile at
    ``t0`` (one head): those holding a query that sees one of its keys."""
    qlo = t0 if causal else 0
    qhi = sq
    if window > 0:
        qhi = min(qhi, min(sk, t0 + rows) - 1 + window)
    return -(-(qhi - qlo) // rows) if qhi > qlo else 0


def split_group(b: int, h: int, kv: int, sq: int, sk: int, d: int, causal: bool, window: int,
                n_sms: int) -> bool:
    """Whether the wgmma body's dK/dV pass splits each KV head's group of g
    query heads over CTAs. Unsplit, a CTA runs the group's g heads in turn,
    so under a causal mask the first key tiles' CTAs run g times the most
    query tiles; split, a CTA runs one head. Split where the unsplit
    heaviest CTA exceeds the average work of a CTA slot (the card's SMs x
    CTAs an SM holds) by ``_SPLIT_IMBALANCE``: the tail is then the pass's
    time, and the split's g-fold grid balances it."""
    g = h // kv
    if g == 1 or b * sq * sk == 0:
        return False
    tiles = [query_tiles(t0, sq, sk, causal, window) for t0 in range(0, sk, 64)]
    slots = n_sms * _CTAS_PER_SM[d]
    heaviest = g * max(tiles)
    average = b * h * sum(tiles) / min(slots, b * kv * len(tiles))
    return heaviest > _SPLIT_IMBALANCE * average


def backward_plan(b: int, h: int, kv: int, sq: int, sk: int, d: int, dtype: torch.dtype, *,
                  causal: bool = True, window: int = 0, n_sms: int = 132,
                  split: Optional[bool] = None) -> BackwardPlan:
    """The body (``variant``), tiles, grids, scratch and the ordered device
    kernels of one call at these shapes and mask; ``split`` forces the wgmma
    body's group split (default ``split_group``). The wgmma body's grids run
    the heaviest tiles first under a causal mask (``tile_in_launch_order``)."""
    body = variant(dtype, d)
    rows, cols = _TILES[body]
    scratch = b * h * sq * 4                              # Delta
    if body == "cuda_cores":
        split = False
        launches = [("flash_bwd_dq_kernel", (b, h, -(-sq // rows)), sq),
                    ("flash_bwd_dkv_kernel", (b, kv, -(-sk // rows)), sk)]
    else:
        if split is None:
            split = split_group(b, h, kv, sq, sk, d, causal, window, n_sms)
        launches = [("flash_bwd_dq_wgmma_kernel", (h, b, -(-sq // rows)), sq),
                    ("flash_bwd_dkv_wgmma_kernel", (h if split else kv, b, -(-sk // rows)), sk)]
        if split:
            blocks = min(-(-b * kv * sk * (d // 8) // _SUM_THREADS), 1 << 20)
            launches.append(("flash_bwd_dkv_sum_kernel", (blocks, 1, 1), sk))
            scratch += 2 * b * h * sk * d * 4                 # the partials of dK and dV
    # a pass with no rows launches nothing
    launches = [(name, grid) for name, grid, n in launches if b > 0 and n > 0]
    return BackwardPlan(body, split, rows, cols, tuple(n for n, _ in launches),
                        tuple(grid for _, grid in launches), scratch)


def tile_in_launch_order(kernel: str, z: int, n_tiles: int, causal: bool) -> int:
    """The tile the wgmma body's CTA at ``blockIdx.z == z`` owns: under a
    causal mask the dQ pass takes the query tiles last first (the last rows
    see the most keys) and the dK/dV pass the key tiles first to last (the
    first keys are seen by the most queries), so the longest CTAs start
    first and the tail is short."""
    if kernel == "flash_bwd_dq_wgmma_kernel" and causal:
        return n_tiles - 1 - z
    return z


def flash_attention_backward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, d_out: torch.Tensor, *,
    causal: bool = True, window: int = 0, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The explicit formulas in float32: P = exp(scale S - lse) on the
    visible keys, dV = P^T dO, dP = dO V^T, Delta = rowsum(dO o),
    dS = P (dP - Delta), dQ = scale dS K, dK = scale dS^T Q, with dK and
    dV summed over the g query heads of each KV head."""
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    scale = scale if scale is not None else d ** -0.5
    grp = lambda x: x.float().reshape(b, kv, g, sq, d)
    qf, of, dof = grp(q), grp(out), grp(d_out)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, kf) * scale
    mask = dense_mask(sq, sk, causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse.reshape(b, kv, g, sq, 1)), 0.0)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dof)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dof, vf)
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qf) * scale
    return dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def group_partials_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, d_out: torch.Tensor, *,
    causal: bool = True, window: int = 0, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each query head's float32 share of dK and dV, ``(B, H, Sk, D)``:
    what the split plan's dK/dV pass writes to its partials (dK's already
    scaled)."""
    b, h, sq, d = q.shape
    kv = k.shape[1]
    g = h // kv
    scale = scale if scale is not None else d ** -0.5
    qf, of, dof = q.float(), out.float(), d_out.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhsd->bhqs", qf, kf) * scale
    mask = dense_mask(sq, k.shape[2], causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhsd->bhqs", dof, vf)
    ds = p * (dp - (dof * of).sum(dim=-1, keepdim=True))
    return (torch.einsum("bhqs,bhqd->bhsd", ds, qf) * scale,
            torch.einsum("bhqs,bhqd->bhsd", p, dof))


def group_sum_plain(dk_part: torch.Tensor, dv_part: torch.Tensor, kv: int,
                    dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK and dV ``(B, KV, Sk, D)`` from the query heads' float32 partials
    ``(B, H, Sk, D)``: each KV head's g partials added in head order, in
    float32, then cast, as flash_bwd_dkv_sum_kernel adds them."""
    b, h, sk, d = dk_part.shape
    g = h // kv
    sums = []
    for part in (dk_part, dv_part):
        grouped = part.reshape(b, kv, g, sk, d)
        acc = grouped[:, :, 0].clone()
        for hh in range(1, g):
            acc += grouped[:, :, hh]
        sums.append(acc.to(dtype))
    return sums[0], sums[1]


def _fn():
    lib = build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 10 + [i] * 8 + [p, ctypes.c_float, i, i, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_backward(
    q: torch.Tensor,          # (B, H, Sq, D)
    k: torch.Tensor,          # (B, KV, Sk, D)
    v: torch.Tensor,
    out: torch.Tensor,        # (B, H, Sq, D), the forward's output
    lse: torch.Tensor,        # (B, H, Sq) float32, the forward's log-sum-exp
    d_out: torch.Tensor,      # (B, H, Sq, D)
    *,
    causal: bool = True,
    window: int = 0,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of the dense entry with respect to q, k and v."""
    check_dense(q, k, v)
    b, h, sq, d = q.shape
    for name, t in (("out", out), ("d_out", d_out)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention_backward: {name} must match q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"flash_attention_backward: lse must be float32 {(b, h, sq)}")
    scale = scale if scale is not None else d ** -0.5
    if q.device.type == "cpu":
        return flash_attention_backward_plain(
            q, k, v, out, lse, d_out, causal=causal, window=window, scale=scale)
    check_head_dim("flash_attention_backward", d, _HEAD_DIMS)
    vec = 16 // q.element_size()
    if d_out.stride(-1) != 1 or d_out.data_ptr() % 16 or any(s % vec for s in d_out.stride()[:3]):
        d_out = d_out.contiguous()
    for t in (q, k, v, out, d_out):
        check_vector_aligned("flash_attention_backward", t, t.stride()[:3])
    lse = lse.contiguous()
    plan = backward_plan(b, h, k.shape[1], sq, k.shape[2], d, q.dtype, causal=causal, window=window,
                         n_sms=_sm_count(q.device.index or 0))
    return _launch(q, k, v, out, lse, d_out, causal, window, scale, plan)


#: the kernel's body argument: the CUDA cores, wgmma with the group in the
#: CTA, wgmma with the group split
_BODY_CODE = {("cuda_cores", False): 0, ("tensor_cores", False): 1, ("tensor_cores", True): 2}


def _launch(q, k, v, out, lse, d_out, causal, window, scale, plan: BackwardPlan):
    """Launch the kernels of ``plan`` (any plan of ``backward_plan`` at
    these shapes)."""
    global launch_count
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    # the split group's float32 partials: every element is written by the
    # dK/dV pass before the sum reads it
    parts = (torch.empty((2, b, h, sk, d), dtype=torch.float32, device=q.device)
             if plan.split_group else None)
    strides = (ctypes.c_longlong * 24)(
        *(s for t in (q, out, d_out, dq, k, v, dk, dv) for s in t.stride()[:3]))
    err = _fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), d_out.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, h, kv, sq, sk, d, int(causal), int(window), strides, float(scale),
        _DTYPES[q.dtype], _BODY_CODE[plan.body, plan.split_group],
        parts[0].data_ptr() if parts is not None else None,
        parts[1].data_ptr() if parts is not None else None,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_backward: CUDA launch failed with error {err}")
    launch_count += 1
    launch_count_by_variant[plan.body] += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Dense flash attention with its gradient: ``apply(q, k, v, causal,
    window, scale)`` on ``(B, H, S, D)`` / ``(B, KV, S, D)`` tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, scale: Optional[float]):
        scale = scale if scale is not None else q.shape[-1] ** -0.5
        out, lse = flash_attention(q, k, v, causal=causal, window=window, scale=scale,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.mask
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, d_out, causal=causal, window=window, scale=scale)
        return dq, dk, dv, None, None, None
