"""PyTorch/CUDA port of the hybrid offline-online LLM serving system.

The package mirrors ``src/repro`` module for module (``configs``, ``core``,
``data``, ``models``, ``kernels``, ``serving``, ``launch``) and imports
nothing from it. Entry points run on the CUDA device unless the caller
passes ``device="cpu"``; there they use the plain PyTorch versions of the
hand-written kernels.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. A CUDA device must exist: without
    one this raises instead of carrying on on the CPU (pass ``device="cpu"``
    to run the plain versions there)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev
