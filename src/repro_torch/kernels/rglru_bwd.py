"""Backward of the RG-LRU linear recurrence: the CUDA kernel
``csrc/rglru_bwd.cu``, the reverse scan that ``rglru.RGLRUScanFn`` runs.
The JAX package has no Pallas backward; its oracle is ``jax.grad`` of
``kernels/ref.py:rglru_scan_ref``.

For h_t = a_t · h_{t-1} + x_t with g_t the gradient of h_t (and that of the
final state added to g_S): dh_t = g_t + a_{t+1} · dh_{t+1}, da_t = dh_t ·
h_{t-1} (h_0 = h0), dx_t = dh_t and dh0 = a_1 · dh_1.

``rglru_scan_backward(a, h, h0, g, g_fin) -> (da, dx, dh0)``, all float32,
checks device and shapes and raises on what the kernel does not take. For a
CUDA tensor it launches the kernel on the current stream (``launch_count``
counts those launches); for a CPU tensor it runs
``rglru_scan_backward_plain``, and only then.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

#: launches of the CUDA kernel since the last reset
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def rglru_scan_backward_plain(
    a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor, g: torch.Tensor, g_fin: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the reverse scan, float32: ``(da, dx, dh0)``
    from ``a``, the forward's ``h`` and ``h0``, and the gradients ``g`` of
    ``h`` and ``g_fin`` of the final state."""
    s = a.shape[1]
    da = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    dx = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    carry = g_fin.float()
    for t in range(s - 1, -1, -1):
        dh = g[:, t].float() + carry
        da[:, t] = dh * (h[:, t - 1].float() if t > 0 else h0.float())
        dx[:, t] = dh
        carry = a[:, t].float() * dh
    return da, dx, carry


def _fn():
    fn = build.load("rglru_bwd").rglru_scan_bwd_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [i] * 3 + [p]
        fn.restype = ctypes.c_int
    return fn


def rglru_scan_backward(
    a: torch.Tensor,        # (B, S, R) decay of the forward
    h: torch.Tensor,        # (B, S, R) the forward's states
    h0: torch.Tensor,       # (B, R) the forward's initial state
    g: torch.Tensor,        # (B, S, R) gradient of h
    g_fin: torch.Tensor,    # (B, R) gradient of h_final
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``(da, dx, dh0)``, float32. CPU tensors run
    ``rglru_scan_backward_plain``; CUDA tensors launch the kernel."""
    global launch_count
    if a.dim() != 3 or any(t.shape != a.shape for t in (h, g)):
        raise ValueError(
            f"rglru_scan_backward: a, h and g must be (B, S, R) of one shape, got "
            f"{tuple(a.shape)} / {tuple(h.shape)} / {tuple(g.shape)}")
    b, s, r = a.shape
    if tuple(h0.shape) != (b, r) or tuple(g_fin.shape) != (b, r):
        raise ValueError(f"rglru_scan_backward: h0 and g_fin must be ({b}, {r})")
    dev = a.device
    if any(t.device != dev for t in (h, h0, g, g_fin)):
        raise ValueError("rglru_scan_backward: all tensors must be on one device")
    if dev.type == "cpu":
        return rglru_scan_backward_plain(a, h, h0, g, g_fin)
    if dev.type != "cuda":
        raise ValueError(f"rglru_scan_backward: unsupported device {dev}")
    if b > 65535:
        raise ValueError(f"rglru_scan_backward: batch {b} exceeds the grid's 65535")
    a, h, h0, g, g_fin = (t.to(torch.float32).contiguous() for t in (a, h, h0, g, g_fin))
    da = torch.empty((b, s, r), dtype=torch.float32, device=dev)
    dx = torch.empty((b, s, r), dtype=torch.float32, device=dev)
    dh0 = torch.empty((b, r), dtype=torch.float32, device=dev)
    err = _fn()(
        a.data_ptr(), h.data_ptr(), h0.data_ptr(), g.data_ptr(), g_fin.data_ptr(),
        da.data_ptr(), dx.data_ptr(), dh0.data_ptr(), b, s, r,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"rglru_scan_backward: CUDA launch failed with error {err}")
    launch_count += 1
    return da, dx, dh0
