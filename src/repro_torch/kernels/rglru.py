"""RG-LRU linear recurrence: the CUDA port of the Pallas kernel
``repro.kernels.rglru.rglru_scan`` (``csrc/rglru.cu``).

``rglru_scan(a, x, h0)`` computes h_t = a_t · h_{t-1} + x_t per channel over
``(B, S, R)`` from the state ``h0`` ``(B, R)`` (zeros when ``None``) and
returns ``(h (B, S, R), h_final (B, R))``, all float32; inputs are cast to
float32 first, as the Pallas wrapper casts them. The final state of one call
seeds the next, so a prefill (S = prompt length) and a decode step (S = 1)
run the same recurrence. Its oracle is ``kernels/ref.py:rglru_scan_ref``.

The wrapper checks device and shapes and raises on what the kernel does not
take. For a CUDA tensor it launches the device kernel of ``scan_plan`` on
the current stream (``launch_count`` counts the calls,
``launch_count_by_kernel`` the calls by device kernel); for a CPU tensor it
runs ``rglru_scan_plain``, and only then.

``scan_plan(b, s, r)`` chunks time where B x R alone would leave the card
short of threads, the backward's rule (``rglru_bwd._SCAN_THREADS``), but in
chunks of its own fixed length ``CHUNK``: the forward is one pass that holds
a chunk's a and x tiles in shared memory (``CHUNK`` x 64 channels x 8
bytes a CTA), so its chunk is bounded by shared memory, where the
backward's two passes keep nothing there and lengthen their chunks as far
as the thread target allows. Each chunk's map (X from a zero carry, A the
product of its a) is published, and each group of ``GROUP`` chunks' map,
its chunks' maps composed; each chunk folds the earlier groups' maps and
then its own group's earlier chunks' from h0, in that order, before it
walks its own steps. ``rglru_scan_chunked_plain`` runs the same order on
the CPU.

The chunked kernel's ticket and maps live in one buffer a device
(``_control``), zeroed once when allocated: each launch tags its maps with
its own epoch and leaves the ticket ready for the next, so no call (and no
CUDA graph) needs a memset. It only grows, and a grown-out buffer is kept
alive, since a graph captured before the growth still points at it; it
grows only outside a capture.

Training: where autograd records (grad enabled and an input requires grad)
``rglru_scan`` goes through ``RGLRUScanFn``, whose backward is the reverse
scan ``rglru_bwd.rglru_scan_backward`` (``csrc/rglru_bwd.cu``, with its own
``launch_count``). It saves ``a``, ``h0`` and the forward's ``h``, never ``x``. Serving calls
run the forward kernel alone, so their counts do not change.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from . import build
from .rglru_bwd import _SCAN_THREADS, rglru_scan_backward

#: calls that launched the CUDA kernel since the last reset
launch_count = 0
#: the same calls by the device kernel their plan ran
launch_count_by_kernel: Dict[str, int] = {"rglru_kernel": 0, "rglru_chunked_kernel": 0}
#: time steps a chunk of the one-pass scan: its a and x tiles (64 channels)
#: take 32 KB of shared memory, so six CTAs share an SM and one's copy
#: overlaps the others' folds and walks
CHUNK = 64
#: chunks a group map composes: a chunk folds the earlier groups' maps, then
#: the earlier chunks' of its own group (at most C / GROUP + GROUP - 2 maps).
#: It and the three below are csrc/rglru.cu's kGroup, kRgThreads,
#: kChunkThreads and kMaxSmem: the plan sizes the buffer the kernel indexes
GROUP = 8
_THREADS = 128                     # rglru_kernel: channels a CTA
_CHUNK_THREADS = 64                # rglru_chunked_kernel: channels a CTA
_MAX_SMEM = 232448 - 1024          # its dynamic shared memory limit

_controls: Dict[Tuple[str, Optional[int]], torch.Tensor] = {}
_retired: List[torch.Tensor] = []


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0
    for k in launch_count_by_kernel:
        launch_count_by_kernel[k] = 0


class ScanPlan(NamedTuple):
    """What one call launches, from shapes alone."""
    chunk: int                               # time steps a CTA (or a thread, one chunk) walks
    n_chunks: int
    kernels: Tuple[str, ...]                 # device kernels in order
    grids: Tuple[Tuple[int, int, int], ...]  # each kernel's grid (x, y, z)
    scratch_bytes: int                       # the control buffer: the ticket, the tagged chunk and group maps
    smem_bytes: int                          # dynamic shared memory a CTA


def scan_plan(b: int, s: int, r: int, chunk: Optional[int] = None) -> ScanPlan:
    """The kernel of the scan at ``(b, s, r)``: one chunk (``rglru_kernel``,
    a thread a (batch, channel)) where B x R alone reaches the backward's
    thread target or S is at most ``CHUNK``; otherwise chunks of ``CHUNK``
    steps in one pass (``rglru_chunked_kernel``, a CTA a (batch, 64
    channels, chunk)): 64 of 64 at (1, 4096, 4096). ``chunk`` forces the
    chunk length (at least S: one chunk; the tiles fit shared memory up to
    452)."""
    if chunk is None:
        chunk = CHUNK if b * r < _SCAN_THREADS and s > CHUNK else max(s, 1)
    n = -(-s // chunk) if s > 0 else 1
    if b == 0 or r == 0:
        kernels = ()
    elif n == 1:
        kernels = (("rglru_kernel", (-(-r // _THREADS), b, 1)),)
    else:
        kernels = (("rglru_chunked_kernel", (n * b * -(-r // _CHUNK_THREADS), 1, 1)),)
    chunked = n > 1 and bool(kernels)
    smem = 2 * chunk * _CHUNK_THREADS * 4 if chunked else 0
    if smem > _MAX_SMEM:
        raise ValueError(f"rglru_scan: chunks of {chunk} need {smem} bytes of shared memory a CTA")
    return ScanPlan(chunk, n, tuple(k for k, _ in kernels), tuple(grid for _, grid in kernels),
                    16 + 16 * (n + -(-n // GROUP)) * b * r if chunked else 0, smem)


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


def rglru_scan_chunked_plain(
    a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor, chunk: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan in the chunked kernel's order for chunks of ``chunk``
    steps: each chunk's map from a zero carry (X the state at its end, A
    the product of its a); each group of ``GROUP`` chunks' map, its maps
    composed in order; then each chunk c = q GROUP + i from the carry that
    the maps of groups 0 .. q-1 and then of chunks q GROUP .. c-1, folded
    from h0 in that order, give it. Float32."""
    a, x, h0 = (t.float() for t in (a, x, h0))
    s = a.shape[1]
    bounds = [(lo, min(s, lo + chunk)) for lo in range(0, s, chunk)]
    maps = []
    for lo, hi in bounds:
        carry, prod = torch.zeros_like(h0), torch.ones_like(h0)
        for t in range(lo, hi):
            carry = a[:, t] * carry + x[:, t]
            prod = prod * a[:, t]
        maps.append((carry, prod))
    groups = []
    for g0 in range(0, len(bounds) - GROUP, GROUP):
        xg, ag = torch.zeros_like(h0), torch.ones_like(h0)
        for xs, as_ in maps[g0:g0 + GROUP]:
            xg, ag = as_ * xg + xs, ag * as_
        groups.append((xg, ag))
    out = torch.empty_like(a)
    h = h0.clone()
    for c, (lo, hi) in enumerate(bounds):
        h = h0
        q = c // GROUP
        for xs, as_ in groups[:q] + maps[q * GROUP:c]:
            h = as_ * h + xs
        for t in range(lo, hi):
            h = a[:, t] * h + x[:, t]
            out[:, t] = h
    return out, h


def _fn():
    fn = build.load("rglru").rglru_scan_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 6 + [i] * 4 + [p]
        fn.restype = ctypes.c_int
    return fn


def _control(device: torch.device, nbytes: int) -> torch.Tensor:
    """The chunked kernel's control buffer on ``device`` (the ticket and
    epoch word, then the tagged chunk and group maps), at least ``nbytes``:
    zeroed once, when allocated; a smaller one is replaced and kept alive
    (a captured graph may hold it). Growing it inside a capture would
    record a fill in the graph, so that raises."""
    key = (device.type, device.index)
    cur = _controls.get(key)
    words = -(-nbytes // 8)
    if cur is None or cur.numel() < words:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("rglru_scan: the chunked scan's control buffer must be sized by an "
                               "eager call before a graph capture")
        if cur is not None:
            _retired.append(cur)
        cur = _controls[key] = torch.zeros(max(words, 2 * (cur.numel() if cur is not None else 0)),
                                           dtype=torch.int64, device=device)
    return cur


def rglru_scan(
    a: torch.Tensor,                      # (B, S, R) decay
    x: torch.Tensor,                      # (B, S, R) gated input
    h0: Optional[torch.Tensor] = None,    # (B, R) initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(h (B, S, R), h_final (B, R))``, float32."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, x, h0)):
        if h0 is None:
            h0 = torch.zeros((a.shape[0], a.shape[-1]), dtype=torch.float32, device=a.device)
        return RGLRUScanFn.apply(a, x, h0)
    return _scan(a, x, h0)


def _scan(a, x, h0):
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
    return _launch(a, x, h0, scan_plan(b, s, r))


def _launch(a, x, h0, plan: ScanPlan):
    """Run ``plan`` on CUDA tensors (any plan of these shapes: ``scan_plan``
    with ``chunk`` forced times the alternatives)."""
    global launch_count
    b, s, r = a.shape
    dev = a.device
    a, x, h0 = (t.to(torch.float32).contiguous() for t in (a, x, h0))
    out = torch.empty((b, s, r), dtype=torch.float32, device=dev)
    h_final = torch.empty((b, r), dtype=torch.float32, device=dev)
    ctl = _control(dev, plan.scratch_bytes) if plan.scratch_bytes else None
    err = _fn()(
        a.data_ptr(), x.data_ptr(), h0.data_ptr(), out.data_ptr(), h_final.data_ptr(),
        ctl.data_ptr() if ctl is not None else None,
        b, s, r, plan.chunk, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"rglru_scan: CUDA launch failed with error {err}")
    launch_count += 1
    for k in plan.kernels:
        launch_count_by_kernel[k] += 1
    return out, h_final


class RGLRUScanFn(torch.autograd.Function):
    """``rglru_scan`` with its gradient: ``apply(a, x, h0) -> (h, h_final)``.
    Saves ``a``, ``h0`` and the forward's ``h`` (not ``x``: the reverse scan
    does not read it) and returns the gradients of ``a``, ``x`` and ``h0``
    in their input dtypes."""

    @staticmethod
    def forward(ctx, a, x, h0):
        out, h_final = _scan(a, x, h0)
        ctx.save_for_backward(a, h0, out)
        ctx.dtypes = (a.dtype, x.dtype, h0.dtype)
        return out, h_final

    @staticmethod
    def backward(ctx, g, g_fin):
        a, h0, out = ctx.saved_tensors
        da, dx, dh0 = rglru_scan_backward(a, out, h0, g, g_fin)
        ta, tx, th = ctx.dtypes
        return da.to(ta), dx.to(tx), dh0.to(th)
