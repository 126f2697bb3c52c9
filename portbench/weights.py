"""The benchmark's weights: drawn on the device from the run's seed, one
generator call a leaf, in the dtype they are served in.

A configuration file's ``tree`` maps each leaf path (dotted, as the program's
parameter tree nests it) to its shape, written with the ``arch`` block's key
names, and its draw:

* ``"std": x`` — normal with that standard deviation;
* ``"fan_in": key or [keys]`` — normal with std ``1/sqrt(product)``;
* ``"init": "one_plus"`` — ``1 + std * normal`` (norm scales);
* ``"dtype"`` — ``bfloat16`` (default) or ``float32``.

Biases and norm parameters are drawn away from zero and one on purpose, so
that a program that drops one of them disagrees with the reference.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def leaf_shape(spec: Dict, arch: Dict):
    return tuple(int(arch[d]) if isinstance(d, str) else int(d) for d in spec["shape"])


def leaf_std(spec: Dict, arch: Dict) -> float:
    if "fan_in" in spec:
        keys = spec["fan_in"] if isinstance(spec["fan_in"], list) else [spec["fan_in"]]
        return 1.0 / math.sqrt(math.prod(int(arch[k]) for k in keys))
    return float(spec["std"])


def make_weights(tree: Dict[str, Dict], arch: Dict, seed: int, device) -> Dict:
    """The nested weight tree for ``seed`` on ``device``."""
    out: Dict = {}
    for path in sorted(tree):
        spec = tree[path]
        node = out
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = torch.empty(leaf_shape(spec, arch), device=device,
                                 dtype=DTYPES[spec.get("dtype", "bfloat16")])
    return draw(out, tree, arch, seed)


def draw(weights: Dict, tree: Dict[str, Dict], arch: Dict, seed: int) -> Dict:
    """Fill ``weights`` in place with the seed's values: the leaves in
    sorted path order from one generator on their device, so a seed gives
    the same weights on every run (and a process can serve several seeds on
    one set of buffers)."""
    flat = dict(leaves(weights))
    gen = None
    for path in sorted(tree):
        spec, x = tree[path], flat[path]
        gen = gen or torch.Generator(device=x.device).manual_seed(seed)
        torch.randn(x.shape, generator=gen, device=x.device, dtype=x.dtype, out=x)
        x.mul_(leaf_std(spec, arch))
        if spec.get("init") == "one_plus":
            x.add_(1.0)
    return weights


def leaves(tree: Dict, prefix: str = ""):
    """(dotted path, tensor) pairs of a nested tree."""
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from leaves(v, path)
        else:
            yield path, v
