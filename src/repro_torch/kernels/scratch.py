"""The scratch a kernel's launch allocates for one call, as its fake
implementation allocates it: ``fake_scratch`` makes the tensor and shows it
to whoever watches (``launch.trace_analysis`` counts it in the device's
peak bytes; a dispatch mode does not see what a fake implementation
allocates itself)."""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch

#: callables that see every scratch tensor a fake implementation makes
watchers: List[Callable[[torch.Tensor], None]] = []


def fake_scratch(like: torch.Tensor, shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    t = like.new_empty(shape, dtype=dtype)
    for w in watchers:
        w(t)
    return t
