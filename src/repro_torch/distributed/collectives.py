"""Distributed-optimization collectives over a ``torch.distributed`` process
group (counterpart of ``repro.distributed.collectives``).

``compressed_psum`` — int8 error-feedback gradient compression for the
data-parallel reduce: per-tensor max-abs scaling, with the quantization
residual fed back into the next step. The arithmetic is the reference's,
its bias included: each rank quantizes with its own scale, the int8 values
are summed as int32, and the sum is dequantized with the **largest** scale
of the group, so where the ranks' scales differ the mean leans towards the
ranks with the smaller ones. The residual is taken at the local scale.

Plain PyTorch, as the reference's is plain ``jnp`` (no Pallas kernel).
Trees are dicts of tensors; every rank of ``group`` calls each function with
the same tree structure, in the same order.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..models.layers import _leaves, tree_map

Tree = Any


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization → (q, scale)."""
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _unflatten(like: Tree, flat: Dict[Tuple[str, ...], torch.Tensor], path=()) -> Tree:
    if isinstance(like, dict):
        return {k: _unflatten(v, flat, path + (k,)) for k, v in like.items()}
    return flat[path]


def compressed_psum(
    grads: Tree,
    error_fb: Tree,
    group: Optional[dist.ProcessGroup] = None,
) -> Tuple[Tree, Tree]:
    """int8 all-reduce with error feedback over ``group``.

    Returns (mean-reduced grads f32, error feedback). ``error_fb`` is a
    float32 tree shaped like ``grads`` (zeros initially); it is updated in
    place, so a step holds one copy of it, and returned. On the wire: each
    leaf's int8 values as an int32 sum, and its scale as a max."""
    n = dist.get_world_size(group)
    flat_e = dict(_leaves(error_fb))
    means = {}
    for path, g in _leaves(grads):
        e = flat_e[path]
        gf = g.float() + e
        q, scale = quantize_int8(gf)
        torch.sub(gf, dequantize_int8(q, scale), out=e)
        del gf
        total = q.to(torch.int32)
        del q
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        scale_max = scale.reshape(1)
        dist.all_reduce(scale_max, op=dist.ReduceOp.MAX, group=group)
        means[path] = total.float() * scale_max[0] / n
    return _unflatten(grads, means), error_fb


def psum_mean(grads: Tree, group: Optional[dist.ProcessGroup] = None) -> Tree:
    """The float32 mean of every leaf over ``group`` (new tensors)."""
    n = dist.get_world_size(group)

    def one(g):
        total = g.to(torch.float32, copy=True)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return total / n

    return tree_map(one, grads)


def pmean(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """The mean of a tensor over ``group`` (a new tensor)."""
    total = x.detach().float().clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total / dist.get_world_size(group)
