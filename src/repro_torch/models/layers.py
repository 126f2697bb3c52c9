"""Layer primitives of the serving and training paths (counterpart of
``repro.models.layers``).

Parameters are declared as ``ParamDef`` trees (shape + logical axes + init
rule) exactly as the reference declares them — same shapes, same axes, same
fan-in scales, same stacked ``(L, ...)`` layer layout — so a parameter tree
converts one-to-one between the two packages
(``models.convert.params_from_numpy``). The same declaration serves three
consumers:

  * ``init_params``     — real tensors, drawn from a seeded
                          ``torch.Generator`` directly on the target device
  * ``abstract_params`` — tensors on the ``meta`` device (shape and dtype,
                          nothing allocated)
  * ``logical_specs``   — the logical-axes tree that
                          ``repro_torch.distributed.sharding`` maps onto a
                          mesh

Logical axis vocabulary (mapped to mesh axes by the sharding rules):
"layers" (the stacked layer dim, never sharded), "batch", "seq", "vocab",
"embed", "heads", "kv_heads", "head_dim", "mlp", "experts", "rnn".

Functions take and return tensors in the reference's layouts (``bshk`` for
per-head activations) and keep its dtype discipline: norms, RoPE (and
M-RoPE) and the MLP activations compute in float32 and cast back to the
activation dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed import spmd
from ..distributed.sharding import constrain_batch_dim, constrain_logits, is_dtensor

Tree = Any

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"       # normal | zeros | ones | embed
    scale: Optional[float] = None
    axes: Tuple[Optional[str], ...] = dataclasses.field(kw_only=True)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank mismatch")


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


def layer_slice(stack: Tree, i: int) -> Tree:
    """Layer ``i`` of a stacked subtree (each leaf ``(L, ...)``), or of a
    list of per-layer trees (what ``train.train_step`` differentiates)."""
    if isinstance(stack, list):
        return stack[i]
    return tree_map(lambda w: w[i], stack)


def records_grad(*trees: Tree) -> bool:
    """Whether autograd records a computation on these trees: grad mode is
    on and a leaf (of a dict tree or a list of them) requires grad."""
    if not torch.is_grad_enabled():
        return False
    todo = list(trees)
    while todo:
        t = todo.pop()
        if isinstance(t, dict):
            todo.extend(t.values())
        elif isinstance(t, list):
            todo.extend(t)
        elif isinstance(t, torch.Tensor) and t.requires_grad:
            return True
    return False


def _refresh(old: Any, new: Any) -> None:
    if isinstance(old, dict):
        for k in old:
            _refresh(old[k], new[k])
    elif isinstance(old, list):
        for a, b in zip(old, new):
            _refresh(a, b)
    elif old.data_ptr() != new.data_ptr():
        old.copy_(new)


class ViewCache:
    """The serving paths' views of parameter subtrees (float32 copies of
    norm scales and gates, flattened projections), built by ``build(*trees)``
    once for the trees given and kept while the same tree objects come back.
    An optimizer step updates leaves in place, so each call also reads the
    leaves' version counters: where one moved, the views are built again
    and copied into the cached tensors where they lie (a view that aliases
    its leaf needs no copy). The cached tensors never move, so a CUDA graph
    captured over them replays the current parameters once a call has
    refreshed them: a graph's owner calls the model's ``refresh_views``
    before every replay (``serving.graphs.Dispatches``)."""

    def __init__(self, build):
        self._build = build
        self._src: Optional[Tuple[Tree, ...]] = None
        self._stamp: Optional[Tuple[int, ...]] = None
        self._views: Any = None

    def __call__(self, *trees: Tree) -> Any:
        stamp = tuple(leaf._version for tree in trees for _, leaf in _leaves(tree))
        same = self._src is not None and len(self._src) == len(trees) and all(
            a is b for a, b in zip(self._src, trees))
        if not same:
            self._views, self._src = self._build(*trees), trees
        elif stamp != self._stamp:
            with torch.no_grad():
                _refresh(self._views, self._build(*trees))
        self._stamp = stamp
        return self._views


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


def abstract_params(defs: Tree) -> Tree:
    """Tensors on the ``meta`` device with the leaves' shapes and dtypes:
    the stand-in of a parameter tree that allocates nothing."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"), defs)


def logical_specs(defs: Tree) -> Tree:
    """Logical-axes tree, same structure as the params."""
    return tree_map(lambda d: d.axes, defs)


# --------------------------------------------------------------------------- #
# Norms                                                                       #
# --------------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x²) + eps) * weight in float32, cast back to x's dtype;
    on a DTensor whose rows split over the DP axes by their last dim (a
    batch of one), each rank's columns (``spmd.split_rms_norm``)."""
    if is_dtensor(x) and not spmd.rowwise_ok(x):
        return spmd.split_rms_norm(x, weight, eps)
    return F.rms_norm(x.float(), (x.shape[-1],), weight.float(), eps).to(x.dtype)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], eps: float = 1e-5
) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) * weight (+ bias) in float32, cast back
    to x's dtype. On DTensors each rank normalises its own rows
    (``spmd.rowwise``)."""
    if is_dtensor(x) and spmd.rowwise_ok(x):
        return spmd.rowwise(lambda x, w, b: layer_norm(x, w, b, eps), x, weight, bias)
    b = None if bias is None else bias.float()
    return F.layer_norm(x.float(), (x.shape[-1],), weight.float(), b, eps).to(x.dtype)


def apply_norm(x, p: Dict[str, torch.Tensor], kind: str, eps: float) -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, p["scale"], eps)
    return layer_norm(x, p["scale"], p.get("bias"), eps)


def norm_defs(d_model: int, kind: str, dtype, layers: Optional[int] = None):
    lead = (layers,) if layers else ()
    lax = ("layers",) if layers else ()
    defs = {"scale": ParamDef(lead + (d_model,), dtype, "ones", axes=lax + ("embed",))}
    if kind == "layernorm":
        defs["bias"] = ParamDef(lead + (d_model,), dtype, "zeros", axes=lax + ("embed",))
    return defs


def sinusoidal_positions(seq_len: int, d_model: int, device=None) -> torch.Tensor:
    """Whisper's fixed sinusoid table (seq, d_model), float32: sin then cos
    of pos / 10000^(2i / d_model) for i < d_model / 2."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    return sinusoid_at(pos, d_model)


def sinusoid_at(pos: torch.Tensor, d_model: int) -> torch.Tensor:
    """The sinusoid rows at float32 positions ``pos`` (..., 1): the closed
    form a decode step evaluates at each slot's own position."""
    dim = torch.arange(d_model // 2, dtype=torch.float32, device=pos.device)
    angle = pos / torch.pow(10000.0, 2 * dim / d_model)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


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


def m_rope_tables(
    positions: torch.Tensor, head_dim: int, theta: float, sections: Tuple[int, int, int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE's (Qwen2-VL) counterpart of ``rope_tables``: ``positions`` is
    (b, s, 3) (t, h, w) triples, and the head_dim/2 frequency slots are split
    into (temporal, height, width) sections, each rotated by its own
    position. Returns cos / sin, (b, s, 1, head_dim) f32."""
    if sum(sections) != head_dim // 2:
        raise ValueError(f"M-RoPE sections {sections} must sum to head_dim/2={head_dim // 2}")
    inv = rope_freqs(head_dim, theta, positions.device)        # (hd/2,)
    sel = torch.cat([torch.full((n,), i, dtype=torch.long, device=positions.device)
                     for i, n in enumerate(sections)])
    pos = positions.float()[..., sel]                          # (b, s, hd/2)
    angles = pos * inv
    angles = torch.cat([angles, angles], dim=-1)[..., None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(
    x: torch.Tensor,             # (..., seq, heads, head_dim)
    positions: torch.Tensor,     # (..., seq) int32
    theta: float = 10000.0,
) -> torch.Tensor:
    return apply_rope_tables(x, *rope_tables(positions, x.shape[-1], theta))


def apply_m_rope(
    x: torch.Tensor,             # (batch, seq, heads, head_dim)
    positions: torch.Tensor,     # (batch, seq, 3) int32 — (t, h, w) triples
    sections: Tuple[int, int, int],
    theta: float = 1_000_000.0,
) -> torch.Tensor:
    return apply_rope_tables(x, *m_rope_tables(positions, x.shape[-1], theta, sections))


# --------------------------------------------------------------------------- #
# MLP                                                                         #
# --------------------------------------------------------------------------- #
def mlp_defs(
    d_model: int, d_ff: int, kind: str, dtype, layers: Optional[int] = None,
    use_bias: bool = False,
):
    lead = (layers,) if layers else ()
    lax = ("layers",) if layers else ()
    if kind == "swiglu":
        return {
            "w_gate": ParamDef(lead + (d_model, d_ff), dtype, axes=lax + ("embed", "mlp")),
            "w_up": ParamDef(lead + (d_model, d_ff), dtype, axes=lax + ("embed", "mlp")),
            "w_down": ParamDef(lead + (d_ff, d_model), dtype, axes=lax + ("mlp", "embed")),
        }
    # squared_relu | gelu
    defs = {
        "w_up": ParamDef(lead + (d_model, d_ff), dtype, axes=lax + ("embed", "mlp")),
        "w_down": ParamDef(lead + (d_ff, d_model), dtype, axes=lax + ("mlp", "embed")),
    }
    if use_bias:
        defs["b_up"] = ParamDef(lead + (d_ff,), dtype, "zeros", axes=lax + ("mlp",))
        defs["b_down"] = ParamDef(lead + (d_model,), dtype, "zeros", axes=lax + ("embed",))
    return defs


def mlp_activation(h: torch.Tensor, kind: str, dtype: torch.dtype) -> torch.Tensor:
    """The non-gated activations in float32, cast to ``dtype``: squared ReLU,
    or GELU in the tanh form (``jax.nn.gelu``'s default)."""
    if kind == "squared_relu":
        return torch.square(torch.relu(h.float())).to(dtype)
    if kind == "gelu":
        return F.gelu(h.float(), approximate="tanh").to(dtype)
    raise ValueError(f"unknown mlp kind {kind!r}")


def mlp_apply(x: torch.Tensor, p: Dict[str, torch.Tensor], kind: str) -> torch.Tensor:
    """The MLP block; on a DTensor sharded by sequence over the TP axis (a
    prefill's sequence shards) each rank's rows with the weights gathered
    (``spmd.rowwise``)."""
    if is_dtensor(x) and spmd.is_seq_sharded(x):
        keys = sorted(p)
        return spmd.rowwise(lambda x, *ws: mlp_apply(x, dict(zip(keys, ws)), kind), x,
                            *(p[k] for k in keys))
    if kind == "swiglu":
        gate = x @ p["w_gate"]
        up = x @ p["w_up"]
        h = F.silu(gate.float()).to(x.dtype) * up
    else:
        h = x @ p["w_up"]
        if "b_up" in p:
            h = h + p["b_up"]
        h = mlp_activation(h, kind, x.dtype)
    out = h @ p["w_down"]
    if "b_down" in p:
        out = out + p["b_down"]
    return out


# --------------------------------------------------------------------------- #
# Embedding / unembedding                                                     #
# --------------------------------------------------------------------------- #
def embed_defs(vocab: int, d_model: int, dtype, tie: bool = False):
    defs = {"embedding": ParamDef((vocab, d_model), dtype, "embed", 0.02,
                                  axes=("vocab", "embed"))}
    if not tie:
        defs["unembed"] = ParamDef((d_model, vocab), dtype, "embed", 0.02,
                                   axes=("embed", "vocab"))
    return defs


def embed_tokens(tokens: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The lookup, batch-sharded over the DP axes on a mesh (the reference's
    constraint: a vocab-sharded table leaves a partial sum otherwise)."""
    if is_dtensor(tokens):
        return spmd.embed(p["embedding"], tokens)
    return p["embedding"][tokens.long()]


def unembed(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    if "unembed" in p:
        return constrain_logits(x @ p["unembed"])
    return constrain_logits(x @ p["embedding"].T)


# --------------------------------------------------------------------------- #
# Training loss                                                               #
# --------------------------------------------------------------------------- #
def moe_aux_weight(cfg) -> float:
    """Load-balancing loss weight (standard 0.01 for Switch-style routers)."""
    return 0.01 if getattr(cfg, "n_experts", 0) > 0 else 0.0


def cross_entropy_loss(
    logits: torch.Tensor,                 # (batch, seq, vocab)
    labels: torch.Tensor,                 # (batch, seq) int
    mask: Optional[torch.Tensor] = None,  # (batch, seq), 1 = counted
) -> torch.Tensor:
    """Mean next-token negative log-likelihood in float32 (logsumexp minus
    the gold logit); with ``mask``, the masked mean over max(sum(mask), 1).
    On DTensors: ``distributed.spmd.cross_entropy`` (vocab-sharded logits
    are never gathered)."""
    if is_dtensor(logits):
        return spmd.cross_entropy(logits, labels, mask)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
