"""AdamW, implemented directly (counterpart of ``repro.train.optimizer``).

Moments are float32 whatever the parameter dtype; the update is computed in
float32 and cast back, as in the reference (bf16 params + float32 m/v, no
separate float32 master copy).

JAX's update returns new trees; this one updates ``params``, ``m``, ``v``
and ``count`` **in place** under ``torch.no_grad()`` and returns the same
objects, so a step holds no second copy of the parameters or moments. Each
leaf is updated in slices along its leading dim (a layer of a stacked leaf)
so the float32 temporaries stay one slice's size; the arithmetic is
elementwise, so the slices give the values a whole-leaf update would.
``abstract_opt_state`` (the dry-run's) is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Tuple

import torch

from ..models.layers import _leaves, tree_map

Tree = Any

#: elements of a leaf slice the update and the norm work on at a time
_SLICE = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    warmup_steps: int = 100


def adamw_init(params: Tree) -> Dict[str, Tree]:
    f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = next(leaf for _, leaf in _leaves(params)).device
    return {
        "m": tree_map(f32, params),
        "v": tree_map(f32, params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def _schedule(cfg: AdamWConfig, count: torch.Tensor) -> torch.Tensor:
    """Linear warmup to cfg.lr, then constant."""
    warm = torch.clamp(count.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def _slices(*tensors: torch.Tensor) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Matching slices along the leading dim of same-shape tensors, each at
    most ``_SLICE`` elements where the leading dim allows."""
    t = tensors[0]
    if t.dim() == 0 or t.numel() <= _SLICE:
        yield tensors
        return
    step = max(1, _SLICE // max(t[0].numel(), 1))
    for i in range(0, t.shape[0], step):
        yield tuple(x[i:i + step] for x in tensors)


@torch.no_grad()
def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    total = None
    for _, leaf in _leaves(tree):
        for (part,) in _slices(leaf):
            sq = torch.sum(torch.square(part.float()))
            total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(
    grads: Tree,
    opt_state: Dict[str, Tree],
    params: Tree,
    cfg: AdamWConfig,
) -> Tuple[Tree, Dict[str, Tree], Dict[str, torch.Tensor]]:
    """One AdamW step with global-norm clipping first, in place; returns
    ``(params, opt_state, {"grad_norm", "lr"})`` (the same tree objects)."""
    count = opt_state["count"]
    count.add_(1)
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = _schedule(cfg, count)
    b1, b2 = cfg.beta1, cfg.beta2
    cf = count.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=cf.device), cf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=cf.device), cf)

    flat_p = dict(_leaves(params))
    flat_m, flat_v = dict(_leaves(opt_state["m"])), dict(_leaves(opt_state["v"]))
    for path, g_leaf in _leaves(grads):
        for g, m, v, p in _slices(g_leaf, flat_m[path], flat_v[path], flat_p[path]):
            g = g.float() * clip
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(torch.square(g) * (1 - b2))
            step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            pf = p.float()
            p.copy_(pf - lr * (step + cfg.weight_decay * pf))
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
