"""Train / eval step factories with gradient accumulation (counterpart of
``repro.train.train_step``).

``make_train_step`` returns ``(params, opt_state, batch) -> (params,
opt_state, metrics)``. Microbatches are leading-dim splits of the batch, as
the reference's ``lax.scan`` takes them: each microbatch's gradient is
divided by the count and cast to ``accum_dtype`` before it is added to a
sum that starts from zeros in that dtype. The step then runs
``adamw_update``, in place.

The gradient is taken with respect to per-layer leaves: each stacked
``(L, ...)`` weight of the subtrees the model names in ``STACKS`` (the
transformer's ``blocks``, RecurrentGemma's ``rec_a`` / ``rec_b`` / ``attn``
/ ``rec_tail``, xLSTM's ``pairs``, Whisper's ``encoder`` / ``decoder``) is
seen as L tensors that share its storage, each accumulating its gradient in
place into its layer's slice of one gradient buffer shaped like the
parameters (differentiating the stacked leaf through L slices would build
and add L full-size zero-filled gradients). The model takes a list of
per-layer trees where it takes a stack (``layers.layer_slice``). The values
are the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from ..models.layers import _leaves, tree_map
from .optimizer import AdamWConfig, adamw_update

Tree = Any


def _split_batch(batch: Dict[str, torch.Tensor], n: int) -> List[Dict[str, torch.Tensor]]:
    out: List[Dict[str, torch.Tensor]] = [{} for _ in range(n)]
    for k, x in batch.items():
        b = x.shape[0]
        if b % n != 0:
            raise ValueError(f"batch dim {b} not divisible by {n} microbatches")
        for i, part in enumerate(torch.chunk(x, n, dim=0)):
            out[i][k] = part
    return out


def _map2(fn, a: Tree, b: Tree) -> Tree:
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _value_and_grad(model, params: Tree, batch, remat: bool, grads: Tree) -> torch.Tensor:
    """The loss of ``batch``; its gradient lands in ``grads`` (a zeroed tree
    shaped like ``params``, in the params' dtypes)."""
    def leaf(w, g):
        t = w.detach().requires_grad_(True)
        t.grad = g
        return t

    stacks = [k for k in model.STACKS if k in params]
    view = {k: _map2(leaf, v, grads[k]) for k, v in params.items() if k not in stacks}
    for k in stacks:
        n = next(w for _, w in _leaves(params[k])).shape[0]
        view[k] = [_map2(lambda w, g, l=l: leaf(w[l], g[l]), params[k], grads[k])
                   for l in range(n)]
    loss = model.loss(view, batch, remat=remat)
    loss.backward()
    return loss.detach()


def make_train_step(
    model,
    opt_cfg: Optional[AdamWConfig] = None,
    microbatches: int = 1,
    remat: bool = True,
    accum_dtype: torch.dtype = torch.bfloat16,
) -> Callable:
    """``accum_dtype``: gradient-accumulation dtype across microbatches
    (bf16 by default, as in the reference; float32 to opt out)."""
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(params, opt_state, batch):
        mb_grads = tree_map(torch.zeros_like, params)
        if microbatches <= 1:
            loss = _value_and_grad(model, params, batch, remat, mb_grads)
            grads = mb_grads
        else:
            zero = lambda p: torch.zeros_like(p, dtype=accum_dtype)   # a DTensor's: its shard
            grads = tree_map(zero, params)
            loss_sum = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            for i, mb in enumerate(_split_batch(batch, microbatches)):
                if i:
                    for _, g in _leaves(mb_grads):
                        g.zero_()
                loss_sum = loss_sum + _value_and_grad(model, params, mb, remat, mb_grads)
                with torch.no_grad():
                    for (_, a), (_, g) in zip(_leaves(grads), _leaves(mb_grads)):
                        a.add_((g / microbatches).to(accum_dtype))
            del mb_grads
            loss = loss_sum / microbatches
        params, opt_state, metrics = adamw_update(grads, opt_state, params, opt_cfg)
        return params, opt_state, dict(metrics, loss=loss)

    return train_step


def make_eval_step(model, remat: bool = False) -> Callable:
    def eval_step(params, batch):
        with torch.no_grad():
            return model.loss(params, batch, remat=remat)

    return eval_step
