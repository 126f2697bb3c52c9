"""Carry the reference package's parameters across to the port.

``params_from_numpy(tree, cfg, device)`` takes the reference's parameter
tree (``init_params`` output) with every leaf already a numpy array —
``jax.tree_util.tree_map(np.asarray, params)`` on the reference side — and
returns the port's tree: the same nesting, shapes and dtypes, as tensors on
``device``. Both packages then compute the same function. bfloat16 leaves
(numpy's ``bfloat16`` extension dtype) move bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import ArchConfig
from .layers import _leaves

Tree = Any


def _to_tensor(x: np.ndarray) -> torch.Tensor:
    x = np.array(x, copy=True, order="C")
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def params_from_numpy(tree: Tree, cfg: ArchConfig, device="cuda") -> Dict[str, Any]:
    from .transformer import TransformerLM

    defs = TransformerLM(cfg, device="cpu").param_defs()
    want = dict(_leaves(defs))
    got = dict(_leaves(tree))
    if set(want) != set(got):
        raise ValueError(
            f"parameter tree mismatch: missing {sorted(set(want) - set(got))}, "
            f"unexpected {sorted(set(got) - set(want))}"
        )
    out: Dict[str, Any] = {}
    for path, d in want.items():
        t = _to_tensor(np.asarray(got[path]))
        if tuple(t.shape) != d.shape:
            raise ValueError(f"{'/'.join(path)}: shape {tuple(t.shape)} != {d.shape}")
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t.to(device=device, dtype=d.dtype)
    return out

