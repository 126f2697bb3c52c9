"""Per-device cost and memory of a traced step (the port's counterpart of
``repro.launch.hlo_analysis``, which parses XLA's partitioned HLO).

The port has no compiled program to parse: the dry-run runs the step once
on fake tensors, as DTensors over a world of fake ranks, under
``TraceAnalysis``, a ``TorchDispatchMode`` that sees every operation on the
local shards of rank 0 (one device's program: what the SPMD-partitioned HLO
is in the reference) and counts

  * FLOPs — dots as 2·M·N·K through ``torch.utils.flop_counter``'s formulas
    (mm, bmm, addmm, baddbmm and what einsum lowers to) and the kernels'
    custom ops through the formulas their modules register
    (``registered_flops``, equal to ``FlopCounterMode``'s total over the
    same step but for products over a contraction of size 1 — an outer
    product, such as the gradient of a matrix-vector product — which XLA
    rewrites to a multiply and the trace counts so); elementwise, transcendental and reduction ops with the
    classes and weights of ``hlo_analysis`` (one FLOP an output element, a
    transcendental also counted as such, a reduction one FLOP an input
    element), composites by what XLA lowers them to;
  * collectives by kind, with their result buffers' bytes and elements
    (the elements compare across dtypes: the reference's CPU compile
    carries many bf16 values as float32): the functional
    collectives DTensor issues (``all_gather_into_tensor``, ``all_reduce``,
    ``reduce_scatter_tensor``, ``all_to_all_single``) are the reference's
    all-gather, all-reduce, reduce-scatter and all-to-all
    (``COLLECTIVE_KINDS``);
  * memory — the live bytes of the device's tensors (each storage once) and
    their peak, from the arguments registered with ``add_arguments`` on.

Python loops unroll in a trace, so no loop trip counts are needed
(``extrapolate`` builds the record of a loop too long to unroll from its
traces at one and at two iterations). DTensor's sharding propagation runs each operation
once more at global shapes to learn its output's metadata; those runs are
not the device's work and are not counted.
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVE_KINDS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

_ELEMENTWISE_1FLOP = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "neg", "abs",
    "logical_and", "logical_or", "logical_xor", "logical_not", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not", "eq", "ne", "lt", "le", "gt",
    "ge", "where", "clamp", "clamp_min", "clamp_max", "sign", "floor", "ceil",
    "round", "remainder", "fmod", "reciprocal", "square", "relu", "addcmul",
    "addcdiv", "lerp", "masked_fill", "fill", "copy",
}
_TRANSCENDENTAL = {
    "exp", "expm1", "exp2", "log", "log1p", "log2", "rsqrt", "sqrt", "tanh",
    "sin", "cos", "tan", "atan2", "pow", "sigmoid", "erf",
}
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "any", "all",
    "argmax", "argmin", "cumsum", "cumprod", "cummax", "topk", "var_mean",
}
# composites, by what XLA lowers them to: (FLOPs, transcendentals) an
# element of their first input
_COMPOSITES = {
    "silu": (2, 1), "gelu": (8, 1), "softmax": (5, 1), "_softmax": (5, 1),
    "log_softmax": (5, 1), "_log_softmax": (5, 1), "logsumexp": (4, 1),
    "rms_norm": (4, 0), "_fused_rms_norm": (4, 0), "native_layer_norm": (7, 0),
    "layer_norm": (7, 0), "softplus": (3, 2),
}


@dataclass
class CostTotals:
    flops: float = 0.0
    transcendentals: float = 0.0
    #: what ``torch.utils.flop_counter``'s formulas count (dots and the
    #: kernels' ops): the part of ``flops`` ``FlopCounterMode`` sees
    registered_flops: float = 0.0
    collective_bytes: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS}
    )
    collective_counts: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS}
    )
    collective_elements: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS}
    )
    #: ``registered_flops`` by operation (``aten.mm``, ``repro_torch.flash_attention``)
    registered_by_op: Dict[str, float] = field(default_factory=dict)
    #: calls of each ``repro_torch`` custom op (the kernels' launches)
    op_calls: Dict[str, float] = field(default_factory=dict)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "transcendentals": self.transcendentals,
            "collectives": {
                k: {"bytes": self.collective_bytes[k], "count": self.collective_counts[k],
                    "elements": self.collective_elements[k]}
                for k in COLLECTIVE_KINDS
            },
            "total_collective_bytes": self.total_collective_bytes,
        }


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else 0


#: the products whose first matrix operand is at this argument index
_PRODUCTS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1}


def _outer_product(name: str, args) -> bool:
    """Whether ``name`` is a matrix product whose contraction has size 1."""
    i = _PRODUCTS.get(name)
    return i is not None and len(args) > i and isinstance(args[i], torch.Tensor) \
        and args[i].shape[-1] == 1




class TraceAnalysis(TorchDispatchMode):
    """Counts what the operations it sees cost one device (``totals``) and
    tracks the device's live and peak bytes (``live_bytes``,
    ``peak_bytes``). Enter it inside the ``FakeTensorMode`` the step's
    tensors belong to."""

    def __init__(self):
        super().__init__()
        self.totals = CostTotals()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._suppress = 0
        self._seen: Dict[int, Any] = {}

    # -------------------------------------------------------------- memory
    def _track(self, t: torch.Tensor) -> None:
        if t.device.type == "meta":
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen and self._seen[key]() is st:
            return
        n = st.nbytes()
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        self._seen[key] = weakref.ref(st, self._freed(key, n))

    def _freed(self, key: int, n: int):
        def cb(_):
            self.live_bytes -= n
            self._seen.pop(key, None)
        return cb

    def add_arguments(self, tree) -> int:
        """Count the local shards of ``tree``'s tensors (the step's
        arguments) as live; returns their bytes."""
        before = self.live_bytes
        for t in local_tensors(tree):
            self._track(t)
        return self.live_bytes - before

    # ---------------------------------------------------------------- cost
    @contextlib.contextmanager
    def suppressed(self):
        """Count nothing and track nothing inside (global-shape runs)."""
        self._suppress += 1
        try:
            yield
        finally:
            self._suppress -= 1

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        t = self.totals
        packet = func._overloadpacket
        ns = func.namespace
        name = packet.__name__
        if ns == "repro_torch":
            t.op_calls[name] = t.op_calls.get(name, 0.0) + 1
        if packet in flop_registry and _outer_product(name, args):
            # a product over a contraction of size 1 is the multiply XLA
            # rewrites such a dot to (the reference counts no dot for it)
            t.flops += _numel(out)
            return
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            t.flops += f
            t.registered_flops += f
            key = f"{ns}.{name}"
            t.registered_by_op[key] = t.registered_by_op.get(key, 0.0) + f
            return
        if ns == "_dtensor" and name == "shard_dim_alltoall":
            name, ns = "all_to_all_single", "_c10d_functional"
        if ns in ("_c10d_functional", "_c10d_functional_autograd") and name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            outs = [x for x in tree_flatten(out)[0] if isinstance(x, torch.Tensor)]
            t.collective_bytes[kind] += sum(x.numel() * x.element_size() for x in outs)
            t.collective_elements[kind] += sum(x.numel() for x in outs)
            t.collective_counts[kind] += 1
            return
        if ns != "aten":
            return
        base = name.rstrip("_")
        first = next((a for a in tree_flatten(args)[0] if isinstance(a, torch.Tensor)), None)
        out_n = sum(_numel(x) for x in tree_flatten(out)[0][:1])
        if base in _ELEMENTWISE_1FLOP:
            t.flops += out_n
        elif base in _TRANSCENDENTAL:
            t.flops += out_n
            t.transcendentals += out_n
        elif base in _REDUCTIONS:
            t.flops += _numel(first)
        elif base in _COMPOSITES:
            f, tr = _COMPOSITES[base]
            t.flops += f * _numel(first)
            t.transcendentals += tr * _numel(first)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(getattr(ty, "__name__", "") == "DTensor" for ty in types):
            return NotImplemented     # DTensor runs it as local operations, seen here
        out = func(*args, **kwargs)
        if self._suppress or func is torch.ops.prim.device.default:
            return out
        self._count(func, args, kwargs, out)
        for x in tree_flatten(out)[0]:
            if isinstance(x, torch.Tensor):
                self._track(x)
        return out


def local_tensors(tree) -> Iterable[torch.Tensor]:
    """The tensors of a tree of dicts, lists and tuples; a DTensor's local
    shard in its place."""
    for x in tree_flatten(tree)[0]:
        if isinstance(x, torch.Tensor):
            yield getattr(x, "_local_tensor", x)


def _alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's shard-to-shard redistribute as the all-to-all it sends on a
    card's mesh (on a ``"cpu"`` mesh DTensor sends an all-gather and keeps a
    chunk, which is not what the card would move)."""
    from torch.distributed import _functional_collectives as funcol

    group = funcol._resolve_group((mesh, mesh_dim))
    return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim,
                                                 funcol._group_or_group_name(group))


@contextlib.contextmanager
def analysing():
    """A ``TraceAnalysis`` with DTensor's sharding propagation kept out of
    its counts (its global-shape runs go through
    ``ShardingPropagator._propagate_tensor_meta_non_cached``), the kernels'
    fake scratch in its peak (``kernels.scratch``) and DTensor's
    shard-to-shard redistributes sent as all-to-alls."""
    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    from ..distributed import op_rules
    from ..kernels import scratch

    op_rules.register()
    mode = TraceAnalysis()
    orig_meta = ShardingPropagator._propagate_tensor_meta_non_cached
    orig_a2a = placement_types.shard_dim_alltoall

    def quiet(self, *a, **k):
        with mode.suppressed():
            return orig_meta(self, *a, **k)

    ShardingPropagator._propagate_tensor_meta_non_cached = quiet
    placement_types.shard_dim_alltoall = _alltoall
    scratch.watchers.append(mode._track)
    try:
        with mode:
            yield mode
    finally:
        scratch.watchers.remove(mode._track)
        ShardingPropagator._propagate_tensor_meta_non_cached = orig_meta
        placement_types.shard_dim_alltoall = orig_a2a


def extrapolate(one: dict, two: dict, n: int) -> dict:
    """A record of a loop of ``n`` identical iterations from the records of
    its traces at one and at two: each count ``one + (n - 1) (two - one)``
    (exact where a count is affine in the iterations: a loop body's work
    and memory a step, the rest once), trace seconds summed. The port's form
    of ``hlo_analysis``'s trip counts, for a loop too long to unroll."""
    def walk(a, b):
        if isinstance(a, dict):
            return {k: walk(a[k], b[k]) for k in a}
        if isinstance(a, bool) or not isinstance(a, (int, float)):
            return a
        v = a + (n - 1) * (b - a)
        return int(v) if isinstance(a, int) and isinstance(b, int) else v
    out = walk(one, two)
    out["trace_s"] = round(one["trace_s"] + two["trace_s"], 2)
    return out
