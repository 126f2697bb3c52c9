"""Logical-axis → mesh-axis sharding rules (counterpart of
``repro.distributed.sharding``).

Every parameter is declared with logical axes (``models.layers``); this
module maps them to a spec for a mesh and strategy:

  * TP ("model" axis): vocab, mlp, heads, experts, rnn widths
  * DP/FSDP ("data" [+ "pod"] axes): batch dim of activations; optionally the
    "embed" dim of ≥2-D weights (fully-sharded weights)
  * SP/CP: KV-cache sequence dim shards over "model" when the arch's KV-head
    count cannot (GQA with few KV heads)

Every rule is *shape-checked*: an axis whose dim is not divisible by the
mesh axes it maps to degrades to replication (e.g. batch=1 in
``long_500k``), and no mesh axis is used twice in one spec.

The rules work on the mesh's axis sizes, ``{axis name: size}`` in mesh
order (a ``DeviceMesh`` with ``mesh_dim_names`` gives them too), so a spec
is computed without a process group. A spec is a tuple with one entry a
tensor dim, as a ``PartitionSpec`` holds them: ``None`` (replicated), a mesh
axis name, or a tuple of names (the dim sharded over their product, the
first outermost); trailing ``None``\\ s are dropped. ``placements`` turns a
spec into DTensor placements on a ``DeviceMesh``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch

Tree = Any
AxisName = Union[str, Tuple[str, ...], None]
Spec = Tuple[AxisName, ...]
Mesh = Any          # a ``DeviceMesh`` with named dims, or ``{axis name: size}``


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """Strategy knobs."""

    dp_axes: Tuple[str, ...] = ("data",)       # ("pod","data") when multi-pod
    tp_axis: str = "model"
    fsdp_weights: bool = True                  # shard "embed" of ≥2D weights over dp
    shard_cache_seq: bool = True               # CP the KV seq when kv_heads can't TP
    logical_rules: Tuple[Tuple[str, AxisName], ...] = ()  # extra overrides

    def rules(self) -> Dict[str, AxisName]:
        base: Dict[str, AxisName] = {
            "layers": None,
            "batch": self.dp_axes,
            "seq": None,
            "cache_seq": None,           # upgraded per-arch (see build_cache_specs)
            "vocab": self.tp_axis,
            "embed": None,               # upgraded to dp for ≥2D weights if fsdp
            "mlp": self.tp_axis,
            "heads": self.tp_axis,
            "kv_heads": self.tp_axis,
            "head_dim": None,
            "experts": self.tp_axis,
            "rnn": self.tp_axis,
        }
        base.update(dict(self.logical_rules))
        return base


def _axis_sizes(mesh: Mesh) -> Dict[str, int]:
    if isinstance(mesh, Mapping):
        return dict(mesh)
    if mesh.mesh_dim_names is None:
        raise ValueError("the DeviceMesh needs mesh_dim_names")
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _mesh_size(mesh: Mesh, name: AxisName) -> int:
    if name is None:
        return 1
    sizes = _axis_sizes(mesh)
    if isinstance(name, str):
        return sizes[name]
    return math.prod(sizes[n] for n in name)


def _spec_for(
    shape: Tuple[int, ...],
    axes: Tuple[Optional[str], ...],
    rules: Dict[str, AxisName],
    mesh: Mesh,
    fsdp_weights: bool,
    dp_axes: Tuple[str, ...],
) -> Spec:
    """Shape-checked spec: drop any mapping whose dim is not divisible or
    whose mesh axis is already used by an earlier dim."""
    used: set = set()
    entries = []
    axes = tuple(axes)
    is_weight = len([a for a in axes if a not in (None, "layers")]) >= 2
    # Vocab-dim weights (embedding / unembedding tables) stay out of FSDP:
    # vocab-sharding alone suffices for them.
    fsdp_ok = is_weight and "vocab" not in axes
    for dim, ax in zip(shape, axes):
        target: AxisName = rules.get(ax) if ax is not None else None
        if ax == "embed" and fsdp_weights and fsdp_ok and target is None:
            target = dp_axes
        if target is None:
            entries.append(None)
            continue
        names = (target,) if isinstance(target, str) else tuple(target)
        names = tuple(n for n in names if n not in used)
        if not names:
            entries.append(None)
            continue
        size = _mesh_size(mesh, names)
        if size <= 1 or dim % size != 0:
            entries.append(None)
            continue
        used.update(names)
        entries.append(names[0] if len(names) == 1 else names)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def _shape(leaf) -> Tuple[int, ...]:
    """A leaf's shape: a tensor's (``meta`` tensors included), or a shape
    tuple as the models' ``cache_shape`` gives it."""
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def build_param_specs(
    abstract_params: Tree,
    logical_axes: Tree,
    mesh: Mesh,
    scfg: ShardingConfig,
) -> Tree:
    """A spec for every leaf of ``abstract_params`` (tensors or anything with
    a ``shape``), from the matching leaf of ``logical_axes``."""
    rules = scfg.rules()

    def walk(aval, axes):
        if isinstance(aval, dict):
            return {k: walk(v, axes[k]) for k, v in aval.items()}
        return _spec_for(_shape(aval), axes, rules, mesh, scfg.fsdp_weights, scfg.dp_axes)

    return walk(abstract_params, logical_axes)


# --------------------------------------------------------------------------- #
# Cache sharding (serve steps)                                                #
# --------------------------------------------------------------------------- #
def _cache_axes_for_key(path: Tuple[str, ...], shape: Tuple[int, ...], kv_shardable: bool):
    """Logical axes for cache arrays, keyed by their dict path/rank."""
    key = path[-1]
    if key in ("k", "v", "cross_k", "cross_v"):
        # (L, B, S, KV, HD): TP the KV heads when possible, else CP the seq.
        return (
            "layers", "batch",
            "cache_seq" if kv_shardable else "cache_seq_tp",
            "kv_heads", "head_dim",
        )
    if key == "pos":
        return ("batch", None)
    if key == "length":
        return ("batch",)
    if key == "rnn_h":
        return ("layers", "batch", "rnn")
    if key == "conv_buf":
        return ("layers", "batch", None, "rnn")
    if key in ("m_C",):
        return ("layers", "batch", "heads", "head_dim", None)
    if key in ("m_n", "s_c", "s_n", "s_h"):
        return ("layers", "batch", "heads", "head_dim")
    if key in ("m_m", "s_m"):
        return ("layers", "batch", "heads")
    # fallback: batch-shard dim 1 if rank >= 2
    return tuple(
        "batch" if i == 1 else ("layers" if i == 0 else None) for i in range(len(shape))
    )


def build_cache_specs(
    cache_shape_tree: Tree,
    mesh: Mesh,
    scfg: ShardingConfig,
    n_kv_heads: int,
) -> Tree:
    """Specs for a serve cache (a model's ``cache_shape``: a dict tree of
    shape tuples or tensors). If the KV-head count divides the TP axis the
    KV heads shard (TP); otherwise the cache *sequence* dim shards over the
    TP axis (context parallelism) when ``shard_cache_seq``."""
    tp = _mesh_size(mesh, scfg.tp_axis)
    kv_shardable = n_kv_heads % tp == 0 if tp > 1 else False
    rules = dict(scfg.rules())
    rules["cache_seq"] = None
    rules["cache_seq_tp"] = scfg.tp_axis if scfg.shard_cache_seq else None
    if not kv_shardable:
        rules["kv_heads"] = None

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        shape = _shape(tree)
        axes = _cache_axes_for_key(path, shape, kv_shardable)
        return _spec_for(shape, axes, rules, mesh, False, scfg.dp_axes)

    return walk(cache_shape_tree, ())


# --------------------------------------------------------------------------- #
# Model-input stand-ins + specs per shape cell                                #
# --------------------------------------------------------------------------- #
def input_specs_for(
    cfg,
    cell,
    mesh: Mesh,
    scfg: ShardingConfig,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Spec]]:
    """``meta`` stand-ins and specs for every model input of a shape cell
    (``configs.shapes.ShapeCell``): tokens/labels for train; tokens for
    serve; stub modality embeddings for vlm/audio. Nothing is allocated."""
    b, s = cell.global_batch, cell.seq_len
    f = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    rules = scfg.rules()

    def sh(shape, axes):
        return _spec_for(shape, axes, rules, mesh, False, scfg.dp_axes)

    specs: Dict[str, torch.Tensor] = {}
    shards: Dict[str, Spec] = {}
    if cell.kind in ("train", "prefill"):
        specs["tokens"] = f((b, s), torch.int32)
        shards["tokens"] = sh((b, s), ("batch", "seq"))
        if cell.kind == "train":
            specs["labels"] = f((b, s), torch.int32)
            shards["labels"] = sh((b, s), ("batch", "seq"))
        if cfg.family == "vlm":
            p = cfg.num_patch_tokens
            specs["patch_embeds"] = f((b, p, cfg.d_model), torch.bfloat16)
            shards["patch_embeds"] = sh((b, p, cfg.d_model), ("batch", None, "embed"))
        if cfg.family == "audio":
            specs["frames"] = f((b, s, cfg.d_model), torch.bfloat16)
            shards["frames"] = sh((b, s, cfg.d_model), ("batch", "seq", "embed"))
    elif cell.kind == "decode":
        specs["tokens"] = f((b,), torch.int32)
        shards["tokens"] = sh((b,), ("batch",))
    else:
        raise ValueError(cell.kind)
    return specs, shards


# --------------------------------------------------------------------------- #
# Specs as DTensor placements                                                 #
# --------------------------------------------------------------------------- #
def placements(spec: Spec, mesh) -> Tuple[Any, ...]:
    """The DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh`` with
    named dims): ``Shard(dim)`` on each mesh dim that the spec names for
    tensor dim ``dim``, ``Replicate()`` on every other. A dim sharded over
    several mesh dims gets ``Shard`` on each; DTensor splits it over them in
    mesh order, so the spec must name them in that order, as the rules do."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(_axis_sizes(mesh))
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(n) for n in group]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def local_slices(shape: Tuple[int, ...], spec: Spec, mesh, coordinate) -> Tuple[slice, ...]:
    """The slice of a tensor of ``shape`` that the mesh position
    ``coordinate`` (one index a mesh dim) holds under ``spec``: each sharded
    dim split evenly over its mesh dims, the first outermost."""
    sizes = _axis_sizes(mesh)
    names = list(sizes)
    out = [slice(None)] * len(shape)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        start, length = 0, shape[dim]
        for n in (entry,) if isinstance(entry, str) else entry:
            length //= sizes[n]
            start += coordinate[names.index(n)] * length
        out[dim] = slice(start, start + length)
    return tuple(out)


def distribute(t: torch.Tensor, mesh, spec: Spec):
    """``t``, the whole tensor (every rank holds it), as a DTensor on ``mesh``
    under ``spec``: this rank's block moves to the mesh's device, and no
    collective runs."""
    from torch.distributed.tensor import DTensor

    local = t[local_slices(tuple(t.shape), spec, mesh, mesh.get_coordinate())]
    device = mesh.device_type
    if device == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    return DTensor.from_local(local.contiguous().to(device), mesh, placements(spec, mesh),
                              run_check=False, shape=t.shape, stride=t.stride())


# --------------------------------------------------------------------------- #
# Sharding hints (the reference's GSPMD constraints, as DTensor redistributes) #
# --------------------------------------------------------------------------- #
# Each hint is the identity on a plain tensor. On a DTensor it redistributes
# to the spec the reference's ``with_sharding_constraint`` names, on the
# tensor's own mesh, with the reference's shape checks: a mesh axis whose
# dim is not divisible is left out of the spec. Dims a spec leaves ``None``
# are replicated, as in a ``PartitionSpec``.
_SEQUENCE_PARALLEL = {"on": False}


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor where nothing
    has: a plain serving or training process never pays for it)."""
    import sys

    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _mesh_axes(x) -> Tuple[Dict[str, int], Tuple[str, ...], Optional[str]]:
    """The sizes of ``x``'s mesh by axis name, its DP axes and its TP axis."""
    sizes = _axis_sizes(x.device_mesh)
    dp = tuple(a for a in sizes if a in ("pod", "data"))
    return sizes, dp, ("model" if "model" in sizes else None)


def _dp_entry(dp: Tuple[str, ...]) -> AxisName:
    return dp if len(dp) > 1 else dp[0]


def constrain(x, spec: Spec):
    """``x`` redistributed to ``spec`` on its own mesh, and, where autograd
    records, its gradient too (a sharding constraint binds a value and its
    cotangent, as ``with_sharding_constraint`` does under ``jax.grad``).
    The identity on a plain tensor."""
    if not is_dtensor(x):
        return x
    want = placements(spec, x.device_mesh)
    if tuple(x.placements) != want:
        x = x.redistribute(x.device_mesh, want)
    if torch.is_grad_enabled() and x.requires_grad:
        x = _GradLayout.apply(x, want)
    return x


class _GradLayout(torch.autograd.Function):
    """The identity forward; the backward redistributes the gradient to the
    forward value's placements (a partial sum is reduced there, not where a
    later product would rather gather a weight)."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.want:
            g = g.redistribute(g.device_mesh, ctx.want)
        return g, None


def constrain_batch_dim(x, batch_dim: int = 1):
    """Batch dim → the DP axes, every other dim replicated, where the batch
    divides the DP grid (the reference's constraint on state a model
    creates inside itself and on its embeddings)."""
    if not is_dtensor(x):
        return x
    sizes, dp, _ = _mesh_axes(x)
    if not dp or x.ndim <= batch_dim or x.shape[batch_dim] % math.prod(sizes[a] for a in dp):
        return x
    spec = [None] * x.ndim
    spec[batch_dim] = _dp_entry(dp)
    return constrain(x, tuple(spec))


def set_sequence_parallel(on: bool) -> None:
    """Sequence parallelism of the residual stream (``constrain_residual``):
    off by default, as in the reference."""
    _SEQUENCE_PARALLEL["on"] = bool(on)


def sequence_parallel_enabled() -> bool:
    return _SEQUENCE_PARALLEL["on"]


def constrain_kv_for_cache(k, n_kv_heads: int, seq_dim: int = 1):
    """A prefill's fresh K/V ``(B, S, KV, D)`` on the cache's layout before
    the cache write: where the KV heads do not divide the TP axis the cache
    shards its sequence over it (``build_cache_specs``), so the write's
    source does too (batch → DP where it divides)."""
    if not is_dtensor(k):
        return k
    sizes, dp, tp = _mesh_axes(k)
    if tp is None or n_kv_heads % sizes[tp] == 0 or k.shape[seq_dim] % sizes[tp]:
        return k
    spec = [None] * k.ndim
    if dp and k.shape[0] % math.prod(sizes[a] for a in dp) == 0:
        spec[0] = _dp_entry(dp)
    spec[seq_dim] = tp
    return constrain(k, tuple(spec))


def constrain_logits(x):
    """Logits ``(..., V)``: batch → DP and vocab → TP where each divides."""
    if not is_dtensor(x):
        return x
    sizes, dp, tp = _mesh_axes(x)
    spec = [None] * x.ndim
    if dp and x.shape[0] % math.prod(sizes[a] for a in dp) == 0:
        spec[0] = _dp_entry(dp)
    if tp and x.shape[-1] % sizes[tp] == 0:
        spec[-1] = tp
    return constrain(x, tuple(spec))


def constrain_residual(h):
    """The residual stream ``(B, S, D)`` between blocks: batch → DP and
    sequence → TP when sequence parallelism is on (the Korthikanti layout);
    the identity otherwise."""
    if not _SEQUENCE_PARALLEL["on"] or not is_dtensor(h) or h.ndim != 3:
        return h
    sizes, dp, tp = _mesh_axes(h)
    b_ok = dp and h.shape[0] % math.prod(sizes[a] for a in dp) == 0
    s_ok = tp and h.shape[1] % sizes[tp] == 0
    return constrain(h, (_dp_entry(dp) if b_ok else None, tp if s_ok else None))


def constrain_rnn(x):
    """A recurrent block's activations ``(B, S, R)``: batch → DP and the
    recurrent width → TP where each divides (the layout the reference's
    logical rules give them), the sequence replicated."""
    if not is_dtensor(x):
        return x
    sizes, dp, tp = _mesh_axes(x)
    spec = [None] * x.ndim
    if dp and x.shape[0] % math.prod(sizes[a] for a in dp) == 0:
        spec[0] = _dp_entry(dp)
    if tp and x.shape[-1] % sizes[tp] == 0:
        spec[-1] = tp
    return constrain(x, tuple(spec))


def gather_fsdp(w):
    """A weight's FSDP all-gather: its DP-axis shards replicated, its TP
    sharding kept (what GSPMD inserts before a weight's first use, and a
    reduce-scatter of its gradient after the backward). The identity on a
    plain tensor."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    names = list(_axis_sizes(w.device_mesh))
    want = tuple(Replicate() if names[i] in ("pod", "data") else p
                 for i, p in enumerate(w.placements))
    if tuple(w.placements) == want:
        return w
    return w.redistribute(w.device_mesh, want)


def batch_zeros(like, shape: Tuple[int, ...], dtype: torch.dtype, batch_dim: int = 0):
    """Zeros of ``shape`` for state a model creates inside itself: on
    ``like``'s device, or, where ``like`` is a DTensor, a DTensor on its
    mesh with the batch dim over the DP axes (the reference's
    ``constrain_batch_dim`` of such state under ``ambient_dp_axes``)."""
    if not is_dtensor(like):
        return torch.zeros(shape, dtype=dtype, device=like.device)
    import torch.distributed.tensor as dt

    sizes, dp, _ = _mesh_axes(like)
    spec = [None] * len(shape)
    if dp and shape[batch_dim] % math.prod(sizes[a] for a in dp) == 0:
        spec[batch_dim] = _dp_entry(dp)
    return dt.zeros(shape, dtype=dtype, device_mesh=like.device_mesh,
                    placements=placements(tuple(spec), like.device_mesh))
