"""Layer primitives of the serving path (counterpart of ``repro.models.layers``).

Parameters are declared as ``ParamDef`` trees (shape + init rule) exactly as
the reference declares them — same shapes, same fan-in scales, same stacked
``(L, ...)`` layer layout — so a parameter tree converts one-to-one between
the two packages (``models.convert.params_from_numpy``). ``init_params``
draws them from a seeded ``torch.Generator`` directly on the target device.

Functions take and return tensors in the reference's layouts (``bshk`` for
per-head activations) and keep its dtype discipline: norms, RoPE and the
SwiGLU gate compute in float32 and cast back to the activation dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Tree = Any

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"       # normal | zeros | ones | embed
    scale: Optional[float] = None


def _fan_in(shape: Tuple[int, ...]) -> int:
    # For stacked layer weights the leading "layers" dim is not a fan-in.
    return shape[-2] if len(shape) >= 2 else shape[-1]


def _leaves(tree: Tree, prefix: Tuple[str, ...] = ()):
    """(path, leaf) pairs in sorted-key order (the reference's flatten order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tree_map(fn, tree: Tree) -> Tree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


@torch.no_grad()
def init_params(
    defs: Tree, generator: torch.Generator, device="cuda"
) -> Tree:
    """Materialize a ParamDef tree on ``device``: normal draws in float32
    scaled by 1/sqrt(fan_in) (1.0 for "embed" unless a scale is given), cast
    to the leaf dtype. ``generator`` must live on ``device``; the values
    differ from the reference's ``jax.random`` draws, so parity tests convert
    the reference's own parameters instead (``models.convert``)."""
    def make(d: ParamDef) -> torch.Tensor:
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=d.dtype, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=d.dtype, device=device)
        scale = d.scale
        if scale is None:
            scale = 1.0 if d.init == "embed" else 1.0 / math.sqrt(_fan_in(d.shape))
        out = torch.empty(d.shape, dtype=d.dtype, device=device)
        # draw stacked weights layer by layer so the float32 staging buffer
        # stays one layer's size
        flat = out.view(d.shape[0], -1) if len(d.shape) > 2 else out.view(1, -1)
        for i in range(flat.shape[0]):
            x = torch.randn(
                flat.shape[1], generator=generator, dtype=torch.float32,
                device=device,
            )
            flat[i].copy_(x.mul_(scale))
        return out

    out: Dict[str, Any] = {}
    for path, d in _leaves(defs):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = make(d)
    return out


# --------------------------------------------------------------------------- #
# Norms                                                                       #
# --------------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x²) + eps) * weight in float32, cast back to x's dtype."""
    return F.rms_norm(x.float(), (x.shape[-1],), weight.float(), eps).to(x.dtype)


def apply_norm(x, p: Dict[str, torch.Tensor], kind: str, eps: float) -> torch.Tensor:
    if kind != "rmsnorm":
        raise NotImplementedError(
            f"norm kind {kind!r} is not ported yet (see ROADMAP.md)"
        )
    return rms_norm(x, p["scale"], eps)


def norm_defs(d_model: int, dtype, layers: Optional[int] = None):
    lead = (layers,) if layers else ()
    return {"scale": ParamDef(lead + (d_model,), dtype, "ones")}


# --------------------------------------------------------------------------- #
# Rotary position embeddings                                                  #
# --------------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies (head_dim/2,), f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (float(theta) ** exps)


def rope_tables(
    positions: torch.Tensor, head_dim: int, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos / sin of the rotation angles, (..., seq, 1, head_dim) f32, each
    half repeated: computed once per step and shared by every layer (the
    reference recomputes them per layer inside its scan, where XLA hoists
    them)."""
    inv = rope_freqs(head_dim, theta, positions.device)       # (hd/2,)
    angles = positions[..., None].float() * inv               # (..., seq, hd/2)
    angles = torch.cat([angles, angles], dim=-1)[..., None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope_tables(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` (..., seq, heads, head_dim) by precomputed tables: the
    halves become x1·cos − x2·sin and x2·cos + x1·sin, as in the reference."""
    xf = x.float()
    x1, x2 = torch.chunk(xf, 2, dim=-1)
    return (xf * cos + torch.cat([-x2, x1], dim=-1) * sin).to(x.dtype)


def apply_rope(
    x: torch.Tensor,             # (..., seq, heads, head_dim)
    positions: torch.Tensor,     # (..., seq) int32
    theta: float = 10000.0,
) -> torch.Tensor:
    return apply_rope_tables(x, *rope_tables(positions, x.shape[-1], theta))


# --------------------------------------------------------------------------- #
# MLP                                                                         #
# --------------------------------------------------------------------------- #
def mlp_defs(d_model: int, d_ff: int, kind: str, dtype, layers: Optional[int] = None):
    if kind != "swiglu":
        raise NotImplementedError(
            f"mlp kind {kind!r} is not ported yet (see ROADMAP.md)"
        )
    lead = (layers,) if layers else ()
    return {
        "w_gate": ParamDef(lead + (d_model, d_ff), dtype),
        "w_up": ParamDef(lead + (d_model, d_ff), dtype),
        "w_down": ParamDef(lead + (d_ff, d_model), dtype),
    }


def mlp_apply(x: torch.Tensor, p: Dict[str, torch.Tensor], kind: str) -> torch.Tensor:
    if kind != "swiglu":
        raise NotImplementedError(
            f"mlp kind {kind!r} is not ported yet (see ROADMAP.md)"
        )
    gate = x @ p["w_gate"]
    up = x @ p["w_up"]
    h = F.silu(gate.float()).to(x.dtype) * up
    return h @ p["w_down"]


# --------------------------------------------------------------------------- #
# Embedding / unembedding                                                     #
# --------------------------------------------------------------------------- #
def embed_defs(vocab: int, d_model: int, dtype, tie: bool = False):
    defs = {"embedding": ParamDef((vocab, d_model), dtype, "embed", 0.02)}
    if not tie:
        defs["unembed"] = ParamDef((d_model, vocab), dtype, "embed", 0.02)
    return defs


def embed_tokens(tokens: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    return p["embedding"][tokens.long()]


def unembed(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    if "unembed" in p:
        return x @ p["unembed"]
    return x @ p["embedding"].T
