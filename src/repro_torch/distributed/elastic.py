"""Elastic scaling & failure recovery (counterpart of
``repro.distributed.elastic``).

The recovery contract:

  1. every state tree is checkpointed unsharded + self-describing
     (``repro_torch.checkpoint``; ``save_unsharded`` gathers a sharded
     tree first), so restore is mesh-shape independent;
  2. on node failure, the controller rebuilds the largest healthy mesh that
     preserves the ``model`` axis width (DP width is the elastic
     dimension) as a *new* world of the surviving processes, re-derives the
     placements from the same logical rules, and restores;
  3. the data pipeline resumes from the checkpointed cursor; the scheduler
     re-enqueues in-flight requests.

``remesh_plan`` computes the new mesh, ``build_mesh`` makes it a
``DeviceMesh`` of the new world's default group, and ``reshard_restore``
restores onto it as DTensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..checkpoint import restore_checkpoint, save_checkpoint
from ..models.layers import tree_map
from .sharding import ShardingConfig, build_param_specs

Tree = Any


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    old_shape: Tuple[int, ...]
    new_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    lost_devices: int

    @property
    def healthy_fraction(self) -> float:
        return float(np.prod(self.new_shape)) / float(np.prod(self.old_shape))


def remesh_plan(
    old_shape: Tuple[int, ...],
    axis_names: Tuple[str, ...],
    n_healthy: int,
    model_axis: str = "model",
) -> RemeshPlan:
    """Largest mesh ≤ n_healthy devices that keeps the model-axis width.

    The DP axes shrink to the largest power-of-two product that fits; the
    TP axis is preserved (weights' shard layout and per-chip working set
    stay identical, so restart needs no retuning).
    """
    sizes = dict(zip(axis_names, old_shape))
    tp = sizes.get(model_axis, 1)
    if n_healthy < tp:
        raise ValueError(
            f"cannot preserve model axis {tp} with only {n_healthy} devices"
        )
    dp_budget = n_healthy // tp
    # distribute the dp budget over the non-model axes, largest-first
    dp_axes = [a for a in axis_names if a != model_axis]
    new_sizes = dict(sizes)
    # shrink to powers of two that fit
    total_dp = 1
    for a in dp_axes:
        total_dp *= sizes[a]
    scale = 1
    while total_dp // scale > dp_budget:
        scale *= 2
    remaining = scale
    for a in reversed(dp_axes):  # shrink innermost dp axis first
        while remaining > 1 and new_sizes[a] > 1:
            new_sizes[a] //= 2
            remaining //= 2
    new_shape = tuple(new_sizes[a] for a in axis_names)
    return RemeshPlan(
        old_shape=tuple(old_shape),
        new_shape=new_shape,
        axis_names=tuple(axis_names),
        lost_devices=int(np.prod(old_shape)) - n_healthy,
    )


def build_mesh(plan: RemeshPlan, device_type: str):
    """The plan's mesh as a ``DeviceMesh`` over the default group's ranks in
    order, dropping a leading ``pod`` axis that shrank to 1 (a 1-pod mesh
    is just (data, model)). The default group must hold exactly the mesh's
    ranks."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    shape, names = [], []
    for s, a in zip(plan.new_shape, plan.axis_names):
        if s == 1 and a == "pod":
            continue
        shape.append(s)
        names.append(a)
    ranks = torch.arange(int(np.prod(shape)), dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(names))


def reshard_restore(
    checkpoint_dir,
    abstract_tree: Tree,
    logical_axes: Tree,
    mesh,
    scfg: Optional[ShardingConfig] = None,
    step: Optional[int] = None,
) -> Tuple[Tree, Dict[str, Any]]:
    """Restore an unsharded checkpoint onto a (possibly different) mesh:
    every leaf a DTensor with ``build_param_specs``' placements, each rank
    holding its own shard. ``abstract_tree`` gives the leaves' dtypes
    (``layers.abstract_params``)."""
    scfg = scfg or ShardingConfig(
        dp_axes=tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
    )
    specs = build_param_specs(abstract_tree, logical_axes, mesh, scfg)
    placed = tree_map(lambda s: (mesh, s), specs)
    return restore_checkpoint(checkpoint_dir, step, abstract_tree, placed)


def save_unsharded(directory, step: int, tree: Tree, metadata: Optional[dict] = None,
                   keep: int = 3):
    """Checkpoint a tree of DTensors (and plain leaves) unsharded: every rank
    gathers each DTensor's whole tensor (a collective), rank 0 writes, and
    the group waits for the write."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    full = tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor) else t, tree)
    path = save_checkpoint(directory, step, full, metadata, keep) if dist.get_rank() == 0 else None
    dist.barrier()
    return path
