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
  float32 ``(B, H, Sq)``. bf16 at head_dim 64 and 128 runs a tensor-core
  body (``mma.sync``), the rest a CUDA-core body (``variant``;
  ``launch_count_by_variant`` counts launches by body). It honours the
  strides of ``q``, ``k``, ``v`` and
  ``out`` (head_dim contiguous and 16-byte vectors, as the forward takes
  them; the model passes ``bshk`` tensors seen as ``(B, H, S, D)``), makes
  ``d_out`` contiguous only where its strides break the vector alignment,
  and returns gradients laid out like their inputs. It checks as the
  forward checks and raises on what the kernel does not take (head_dim
  other than 16, 32, 64 or 128, before a launch). For a CUDA tensor it
  launches the kernel (``launch_count`` counts the launches: each is the
  dQ pass and the dK/dV pass); for a CPU tensor it runs
  ``flash_attention_backward_plain``, and only then.
* ``FlashAttentionFn`` — ``torch.autograd.Function`` whose forward runs the
  dense entry with the log-sum-exp and saves ``q, k, v, out, lse``, and
  whose backward calls ``flash_attention_backward``. On CPU tensors both
  sides run the plain versions.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build
from .flash_attention import (
    _DTYPES,
    check_dense,
    check_head_dim,
    check_vector_aligned,
    dense_mask,
    flash_attention,
)

#: the kernel's device bodies
VARIANTS = ("cuda_cores", "tensor_cores")
#: launches of the backward kernel (one a call: both passes) since the last reset
launch_count = 0
#: the same launches by the body that served them
launch_count_by_variant = dict.fromkeys(VARIANTS, 0)

_HEAD_DIMS = (16, 32, 64, 128)
_TENSOR_CORE_HEAD_DIMS = (64, 128)


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0
    for name in VARIANTS:
        launch_count_by_variant[name] = 0


def variant(dtype: torch.dtype, head_dim: int) -> str:
    """The device body that serves ``dtype`` at ``head_dim``: bf16 at 64 and
    128 on the tensor cores (mma.sync); float32 (which the tensor cores
    would compute as TF32) and bf16 at 16 and 32 on the CUDA cores."""
    if dtype == torch.bfloat16 and head_dim in _TENSOR_CORE_HEAD_DIMS:
        return "tensor_cores"
    return "cuda_cores"


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


def _fn():
    lib = build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 10 + [i] * 8 + [p, ctypes.c_float, i, i, p]
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
    return _launch(q, k, v, out, lse, d_out, causal, window, scale, variant(q.dtype, d))


def _launch(q, k, v, out, lse, d_out, causal, window, scale, body):
    """Launch both passes on the body ``body`` (a name of ``VARIANTS``)."""
    global launch_count
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(
        *(s for t in (q, out, d_out, dq, k, v, dk, dv) for s in t.stride()[:3]))
    err = _fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), d_out.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, h, kv, sq, sk, d, int(causal), int(window), strides, float(scale),
        _DTYPES[q.dtype], int(body == "tensor_cores"),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_backward: CUDA launch failed with error {err}")
    launch_count += 1
    launch_count_by_variant[body] += 1
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
