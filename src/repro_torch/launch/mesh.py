"""Production mesh builders and the H100's roofline constants (counterpart
of ``repro.launch.mesh``).

The meshes are ``DeviceMesh``\\ es over the process group that is running:
16 x 16 = 256 cards ``("data", "model")``, or 2 x 16 x 16 = 512 cards
``("pod", "data", "model")``, the reference's shapes and axis names. The
dry-run traces on a world of fake ranks (``fake_world``): its tensors are
fake, so its mesh is a ``"cpu"`` mesh and no card is touched; every other
caller's mesh is on ``cuda``.

The roofline's constants are the NVIDIA H100 80GB HBM3 (SXM, 700 W)
spec sheet's. Its collective term prices every byte at one 400 Gb/s NDR
port a GPU (50 GB/s): a model axis of 16 spans two 8-GPU nodes, and the
data and pod axes span nodes too, so every collective of the production
meshes crosses that link, its slowest. NVLink's 450 GB/s a direction
stays a named constant beside it.
"""
from __future__ import annotations

from typing import Tuple

#: NVIDIA H100 80GB HBM3 (SXM), 700 W: spec-sheet figures per card, the
#: roofline's denominators
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, dense bf16 tensor cores (spec sheet)
HBM_BW = 3.35e12                  # B/s, HBM3 (spec sheet)
HBM_BYTES = 80e9                  # B a card (spec sheet)
#: NVLink 4 within an 8-GPU node: 450 GB/s a direction a GPU (spec sheet)
NVLINK_BW = 450e9
#: one 400 Gb/s NDR InfiniBand port a GPU between nodes: 50 GB/s (spec
#: sheet). A model axis of 16 spans two 8-GPU nodes and the data and pod
#: axes span nodes too, so every collective of the production meshes crosses
#: this link, and it is the collective term's denominator.
INTER_NODE_BW = 50e9
ICI_BW_PER_LINK = INTER_NODE_BW   # the reference's name for that denominator


def fake_world(n: int) -> None:
    """Make this process rank 0 of a world of ``n`` fake ranks (torch's fake
    process group: collectives return at once, nothing is sent), unless a
    world of ``n`` is already up."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks is up, not {n}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    running process group (tests and elastic re-mesh use this)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """16 x 16 = 256 cards a pod; 2 pods = 512 cards multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def dp_axes_for(mesh) -> Tuple[str, ...]:
    """The data-parallel axes of a production mesh (pod folds into DP)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
