"""Backward of the RG-LRU linear recurrence: the CUDA kernel
``csrc/rglru_bwd.cu``, the reverse scan that ``rglru.RGLRUScanFn`` runs.
The JAX package has no Pallas backward; its oracle is ``jax.grad`` of
``kernels/ref.py:rglru_scan_ref``.

For h_t = a_t · h_{t-1} + x_t with g_t the gradient of h_t (and that of the
final state added to g_S): dh_t = g_t + a_{t+1} · dh_{t+1}, da_t = dh_t ·
h_{t-1} (h_0 = h0), dx_t = dh_t and dh0 = a_1 · dh_1.

``rglru_scan_backward(a, h, h0, g, g_fin) -> (da, dx, dh0)``, all float32,
checks device and shapes and raises on what the kernel does not take. For a
CUDA tensor it launches the kernels of ``scan_plan`` on the current stream
(``launch_count`` counts the calls); for a CPU tensor it runs
``rglru_scan_backward_plain``, and only then. ``scan_plan(b, s, r)`` chunks
time where B x R alone would leave the card short of threads: each chunk's
carry map (X_c, A_c), then every (batch, channel, chunk) in parallel, its
carry folded from the later chunks' maps;
``rglru_scan_backward_chunked_plain`` runs the same plan in that order.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from . import build
from .scratch import fake_scratch

#: calls that launched the CUDA kernels (one a call: every kernel of its plan) since the last reset
launch_count = 0
#: (batch, channel, chunk) threads the chunked scan aims for: about 1,000
#: an SM of 132, so that HBM sees enough loads in flight
_SCAN_THREADS = 128 * 1024
#: the shortest chunk the plan cuts (each chunk's map costs a read of its a
#: and g, and each thread folds one map a later chunk)
_MIN_CHUNK = 64
_THREADS = 128


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


class ScanPlan(NamedTuple):
    """What one call of the backward launches, from shapes alone."""
    chunk: int                               # time steps a thread walks
    n_chunks: int
    kernels: Tuple[str, ...]                 # device kernels in order
    grids: Tuple[Tuple[int, int, int], ...]  # each kernel's grid (x, y, z)
    scratch_bytes: int                       # the chunk maps X and A, float32 (C, B, R) each


def scan_plan(b: int, s: int, r: int) -> ScanPlan:
    """The chunk length and kernels of the backward at ``(b, s, r)``: one
    chunk where B x R threads already reach ``_SCAN_THREADS`` or S is at
    most ``_MIN_CHUNK``; otherwise chunks of at least ``_MIN_CHUNK`` steps,
    as many as reach the target (32 of 128 steps at (1, 4096, 4096))."""
    want = -(-_SCAN_THREADS // max(b * r, 1))
    chunk = max(s, 1)
    if want > 1 and s > _MIN_CHUNK:
        chunk = max(_MIN_CHUNK, -(-s // want))
    n = -(-s // chunk) if s > 0 else 1
    blocks = -(-r // _THREADS)
    kernels = (("rglru_bwd_chunk_kernel", (blocks, n - 1, b)),) if n > 1 else ()
    kernels += (("rglru_bwd_kernel", (blocks, n, b)),)
    if b == 0 or r == 0:
        kernels = ()
    return ScanPlan(chunk, n, tuple(k for k, _ in kernels), tuple(grid for _, grid in kernels),
                    2 * n * b * r * 4 if n > 1 else 0)


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


def rglru_scan_backward_chunked_plain(
    a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor, g: torch.Tensor, g_fin: torch.Tensor,
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reverse scan in the kernel's order for chunks of ``chunk`` steps:
    each chunk's carry map (X from a zero carry, A the product of its a,
    taken last step first), then each chunk from the carry the later
    chunks' maps give g_fin, last chunk first. Float32."""
    a, h, h0, g, g_fin = (t.float() for t in (a, h, h0, g, g_fin))
    s = a.shape[1]
    bounds = [(lo, min(s, lo + chunk)) for lo in range(0, s, chunk)] or [(0, 0)]
    maps = {}
    for c, (lo, hi) in enumerate(bounds[1:], start=1):
        carry, prod = torch.zeros_like(g_fin), torch.ones_like(g_fin)
        for t in range(hi - 1, lo - 1, -1):
            carry = a[:, t] * (g[:, t] + carry)
            prod = prod * a[:, t]
        maps[c] = carry, prod
    da, dx = torch.empty_like(a), torch.empty_like(a)
    dh0 = g_fin
    for c, (lo, hi) in enumerate(bounds):
        carry = g_fin
        for j in range(len(bounds) - 1, c, -1):
            carry = maps[j][0] + maps[j][1] * carry
        for t in range(hi - 1, lo - 1, -1):
            dh = g[:, t] + carry
            da[:, t] = dh * (h[:, t - 1] if t > 0 else h0)
            dx[:, t] = dh
            carry = a[:, t] * dh
        if c == 0:
            dh0 = carry
    return da, dx, dh0


def _fn():
    fn = build.load("rglru_bwd").rglru_scan_bwd_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 10 + [i] * 4 + [p]
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
    ``rglru_scan_backward_plain``; CUDA tensors launch the kernels of
    ``scan_plan``."""
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
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"rglru_scan_backward: unsupported device {dev}")
    return tuple(torch.ops.repro_torch.rglru_scan_backward(a, h, h0, g, g_fin))


@torch.library.custom_op("repro_torch::rglru_scan_backward", mutates_args=(), device_types="cpu")
def rglru_scan_backward_op(
    a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor, g: torch.Tensor, g_fin: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The op behind ``rglru_scan_backward`` (checked arguments): ``(da, dx,
    dh0)`` float32. CPU: ``rglru_scan_backward_plain``. CUDA: the kernels of
    ``scan_plan``. Fake: the gradients, the float32 contiguous copies the
    launch makes of inputs that are not, and the chunk maps where the plan
    chunks time. FLOPs: 3 B S R (dh, da and the carry a step and
    channel)."""
    return rglru_scan_backward_plain(a, h, h0, g, g_fin)


@rglru_scan_backward_op.register_kernel("cuda")
def _rglru_scan_backward_cuda(a, h, h0, g, g_fin):
    global launch_count
    b, s, r = a.shape
    dev = a.device
    if b > 65535:
        raise ValueError(f"rglru_scan_backward: batch {b} exceeds the grid's 65535")
    a, h, h0, g, g_fin = (t.to(torch.float32).contiguous() for t in (a, h, h0, g, g_fin))
    da = torch.empty((b, s, r), dtype=torch.float32, device=dev)
    dx = torch.empty((b, s, r), dtype=torch.float32, device=dev)
    dh0 = torch.empty((b, r), dtype=torch.float32, device=dev)
    plan = scan_plan(b, s, r)
    # the chunk maps: every element the scan reads is written first
    maps = torch.empty((2, plan.n_chunks, b, r), dtype=torch.float32, device=dev) if plan.n_chunks > 1 else None
    err = _fn()(
        a.data_ptr(), h.data_ptr(), h0.data_ptr(), g.data_ptr(), g_fin.data_ptr(),
        da.data_ptr(), dx.data_ptr(), dh0.data_ptr(),
        maps[0].data_ptr() if maps is not None else None, maps[1].data_ptr() if maps is not None else None,
        b, s, r, plan.chunk, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"rglru_scan_backward: CUDA launch failed with error {err}")
    launch_count += 1
    return da, dx, dh0


def fake_f32_copies(*tensors: torch.Tensor) -> None:
    """What ``t.to(torch.float32).contiguous()`` allocates for each input
    of a launch, in a fake implementation: a copy of each that is not
    float32 and contiguous already (freed at once)."""
    for t in tensors:
        if t.dtype != torch.float32 or not t.is_contiguous():
            fake_scratch(t, tuple(t.shape), torch.float32)


@rglru_scan_backward_op.register_fake
def _rglru_scan_backward_fake(a, h, h0, g, g_fin):
    fake_f32_copies(a, h, h0, g, g_fin)
    b, s, r = a.shape
    plan = scan_plan(b, s, r)
    if plan.n_chunks > 1:
        fake_scratch(a, (2, plan.n_chunks, b, r), torch.float32)
    return (a.new_empty((b, s, r), dtype=torch.float32), a.new_empty((b, s, r), dtype=torch.float32),
            a.new_empty((b, r), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.rglru_scan_backward)
def _rglru_scan_backward_flops(a, *args, out_shape=None, **kwargs) -> int:
    b, s, r = a
    return 3 * b * s * r
