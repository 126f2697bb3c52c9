"""Data-parallel train step with int8 error-feedback gradient compression
(counterpart of ``repro.train.dp_compressed``).

Every rank of a ``torch.distributed`` process group holds the whole
parameter tree, optimizer state and error feedback. The step takes the
**global** batch; each rank computes the loss and gradient of its
contiguous 1/world slice of the leading dim (the split that ``shard_map``'s
``P("data")`` makes), the gradients are reduced over the group — int8
compressed with error feedback, or as a plain float32 mean — the loss is
averaged over the group, and every rank runs the same ``adamw_update`` in
place.

The group's backend follows its device: NCCL for CUDA tensors, gloo for CPU
tensors (``init_group``).
"""
from __future__ import annotations

import datetime
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from .. import resolve_device
from ..distributed.collectives import compressed_psum, pmean, psum_mean
from ..models.layers import tree_map
from .optimizer import AdamWConfig, adamw_update
from .train_step import _value_and_grad

Tree = Any

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_group(device, init_method: str, rank: int, world_size: int,
               timeout_s: float = 600.0) -> None:
    """Open the default process group for ``device``'s type: NCCL for
    ``cuda`` (raises without a GPU), gloo for ``cpu``. ``init_method`` is a
    rendezvous URL (``file://...`` or ``tcp://host:port``)."""
    dev = resolve_device(device)
    if dev.type not in BACKENDS:
        raise ValueError(f"no process-group backend for device type {dev.type!r}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None else rank % torch.cuda.device_count())
    dist.init_process_group(BACKENDS[dev.type], init_method=init_method, rank=rank,
                            world_size=world_size, timeout=datetime.timedelta(seconds=timeout_s))


def local_batch(batch: Dict[str, torch.Tensor], group=None) -> Dict[str, torch.Tensor]:
    """This rank's contiguous 1/world slice of every input's leading dim."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    out = {}
    for k, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch dim {x.shape[0]} of {k!r} not divisible by {n} ranks")
        m = x.shape[0] // n
        out[k] = x[r * m: (r + 1) * m]
    return out


def reduce_gradients(grads: Tree, error_fb: Optional[Tree], group=None,
                     compress: bool = True) -> Tuple[Tree, Optional[Tree]]:
    """The step's reduction: (float32 mean gradients, error feedback), the
    int8 error-feedback all-reduce with ``compress``, else the plain float32
    mean (the error feedback passes through untouched)."""
    if compress:
        return compressed_psum(grads, error_fb, group)
    return psum_mean(grads, group), error_fb


def make_dp_train_step(
    model,
    group=None,
    opt_cfg: Optional[AdamWConfig] = None,
    compress: bool = True,
    remat: bool = False,
) -> Callable:
    """Returns ``step(params, opt_state, error_fb, batch) → (params,
    opt_state, error_fb, metrics)``; ``batch`` is the global batch, the
    trees are replicated on every rank of ``group`` (the default group when
    None) and updated in place. ``metrics``: the optimizer's plus the group's
    mean ``loss``."""
    opt_cfg = opt_cfg or AdamWConfig()

    def step(params, opt_state, error_fb, batch):
        grads = tree_map(torch.zeros_like, params)
        loss = _value_and_grad(model, params, local_batch(batch, group), remat, grads)
        reduced, error_fb = reduce_gradients(grads, error_fb, group, compress)
        del grads
        loss = pmean(loss, group)
        params, opt_state, metrics = adamw_update(reduced, opt_state, params, opt_cfg)
        return params, opt_state, error_fb, dict(metrics, loss=loss)

    return step


def init_error_feedback(params: Tree) -> Tree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
