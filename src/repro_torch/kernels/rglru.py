"""RG-LRU linear recurrence: the CUDA port of the Pallas kernel
``repro.kernels.rglru.rglru_scan`` (``csrc/rglru.cu``).

``rglru_scan(a, x, h0)`` computes h_t = a_t · h_{t-1} + x_t per channel over
``(B, S, R)`` from the state ``h0`` ``(B, R)`` (zeros when ``None``) and
returns ``(h (B, S, R), h_final (B, R))``, all float32; inputs are cast to
float32 first, as the Pallas wrapper casts them. The final state of one call
seeds the next, so a prefill (S = prompt length) and a decode step (S = 1)
run the same recurrence. Its oracle is ``kernels/ref.py:rglru_scan_ref``.

The wrapper checks device and shapes and raises on what the kernel does not
take. For a CUDA tensor it launches the kernel on the current stream
(``launch_count`` counts those launches); for a CPU tensor it runs
``rglru_scan_plain``, and only then.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build

#: launches of the CUDA kernel since the last reset
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def rglru_scan_plain(
    a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: a float32 loop over time."""
    h = h0.to(torch.float32, copy=True)
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    for t in range(a.shape[1]):
        h = a[:, t].float() * h + x[:, t].float()
        out[:, t] = h
    return out, h


def _fn():
    fn = build.load("rglru").rglru_scan_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 5 + [i] * 3 + [p]
        fn.restype = ctypes.c_int
    return fn


def rglru_scan(
    a: torch.Tensor,                      # (B, S, R) decay
    x: torch.Tensor,                      # (B, S, R) gated input
    h0: Optional[torch.Tensor] = None,    # (B, R) initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(h (B, S, R), h_final (B, R))``, float32."""
    global launch_count
    if a.dim() != 3 or x.shape != a.shape:
        raise ValueError(
            f"rglru_scan: a and x must be (B, S, R) of one shape, got "
            f"{tuple(a.shape)} / {tuple(x.shape)}"
        )
    b, s, r = a.shape
    dev = a.device
    if h0 is None:
        h0 = torch.zeros((b, r), dtype=torch.float32, device=dev)
    if tuple(h0.shape) != (b, r):
        raise ValueError(f"rglru_scan: h0 must be ({b}, {r}), got {tuple(h0.shape)}")
    if x.device != dev or h0.device != dev:
        raise ValueError("rglru_scan: all tensors must be on one device")
    if dev.type == "cpu":
        return rglru_scan_plain(a, x, h0)
    if dev.type != "cuda":
        raise ValueError(f"rglru_scan: unsupported device {dev}")
    if b > 65535:
        raise ValueError(f"rglru_scan: batch {b} exceeds the grid's 65535")
    a, x, h0 = (t.to(torch.float32).contiguous() for t in (a, x, h0))
    out = torch.empty((b, s, r), dtype=torch.float32, device=dev)
    h_final = torch.empty((b, r), dtype=torch.float32, device=dev)
    err = _fn()(
        a.data_ptr(), x.data_ptr(), h0.data_ptr(), out.data_ptr(), h_final.data_ptr(),
        b, s, r, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"rglru_scan: CUDA launch failed with error {err}")
    launch_count += 1
    return out, h_final
