"""Local forms of the model operations that DTensor has no strategy for, or
only a costly one (the port's counterpart of what GSPMD's partitioner does
for the reference's einsums, scatters and cache updates).

Each function takes DTensors, brings them to the layout the operation needs
(batch over the DP axes, heads or the cache's sequence over the TP axis),
runs the plain-tensor operation on this rank's shards, and wraps the result
back, declaring the layout of each input's gradient (a weight a batch shard
uses whole: partial over the DP axes; an input of which a rank computes a
part: partial over the TP axis); the collectives it adds are the ones GSPMD
adds for the reference:

  * ``embed`` — the lookup in a vocab-sharded table (an all-reduce of the
    rows each rank holds);
  * ``attention`` — a dense prefill's attention (kernel 2) with the batch
    and the query heads sharded; where the KV heads do not divide the TP
    axis each rank takes the KV heads of its own query heads, which
    ``gqa_kv`` computes alone in a training forward (its weight gradient
    by row slices over the TP axis) or a prefill into a ring
    (``gqa_kv_heads`` then gathers every KV head for the ring's slots), and
    ``seq_sharded_proj`` for its sequence shard in a prefill into a
    sequence-sharded cache;
  * where the query heads do not divide the TP axis: a prefill's attention
    block on sequence shards (``sequence_parallel``, ``seq_shard``,
    ``seq_attention``: each rank's queries over the gathered keys), a
    training forward's attention weight gradients in FSDP blocks over the
    TP ranks (``grad_split_proj``), and a decode step's K/V from FSDP
    weights over TP shards of the contraction (``contraction_split_proj``);
  * ``decode_attention`` — one token against a dense cache (kernel 3): a
    cache sharded by KV heads decodes locally; one sharded by sequence (the
    reference's context parallelism) decodes each shard's keys into a
    partial output and log-sum-exp, merged across the TP axis by all-reduces
    of ``(B, H)`` statistics and ``(B, H, D)`` partials (kernel 3's split
    merge, across devices) — the cache is never gathered;
  * ``write_token``, ``write_prefill``, ``write_ring_prefill`` — the cache
    writes, each rank writing the rows its shard holds;
  * ``cross_entropy`` — the loss over vocab-sharded logits (all-reduces of
    ``(B, S)`` statistics, as GSPMD reduces the reference's logsumexp);
  * ``moe`` — the MoE's router logits on each rank's experts, its routing,
    scatter and gather on the batch-sharded groups, the expert products on
    each rank's experts or FFN slice;
  * ``on_model_shards`` — a recurrent loop (xLSTM's token steps) on each
    rank's batch shard, its heads split over the TP axis or, where they do
    not divide it, its projections' contraction (``ModelAxis``).

Only the dry-run (and the tests) run models on DTensors; every serving and
training path runs plain tensors, which never reach this module.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .sharding import _axis_sizes, is_dtensor


def _mesh(x):
    """``x``'s mesh, its axis names in order and their sizes."""
    sizes = _axis_sizes(x.device_mesh)
    return x.device_mesh, list(sizes), sizes


def _placements(mesh_names: List[str], sizes: Dict[str, int], *, batch_dim: Optional[int],
                batch: int, tp_dim: Optional[int]):
    """Shard(batch_dim) on the DP axes where the batch divides their grid,
    Shard(tp_dim) on "model" (None: replicated), Replicate elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    dp = [n for n in mesh_names if n in ("pod", "data")]
    dp_ok = batch_dim is not None and dp and batch % math.prod(sizes[n] for n in dp) == 0
    out = []
    for n in mesh_names:
        if n in dp and dp_ok:
            out.append(Shard(batch_dim))
        elif n == "model" and tp_dim is not None:
            out.append(Shard(tp_dim))
        else:
            out.append(Replicate())
    return tuple(out)


def _to(x, pl, mesh=None):
    """``x`` on placements ``pl``. A plain tensor (a step's own constant,
    whole on every rank) stands for itself: its ``to_local`` is this rank's
    block under ``pl`` on ``mesh``."""
    if not hasattr(x, "placements"):
        return _Plain(x, pl, mesh)
    return x if tuple(x.placements) == tuple(pl) else x.redistribute(x.device_mesh, pl)


class _Plain:
    """A plain tensor where a DTensor is expected: ``to_local`` slices this
    rank's block."""

    def __init__(self, t, pl, mesh):
        self.t, self.pl, self.mesh = t, pl, mesh

    def to_local(self, **_):
        from torch.distributed.tensor import Shard

        t = self.t
        if self.mesh is None:
            return t
        coord = self.mesh.get_coordinate() or [0] * self.mesh.ndim
        for i, p in enumerate(self.pl):
            if isinstance(p, Shard):
                n = t.shape[p.dim] // self.mesh.size(i)
                t = t.narrow(p.dim, coord[i] * n, n)
        return t


def _wrap(local: torch.Tensor, like_mesh, pl, shape) -> "torch.Tensor":
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, like_mesh, pl, run_check=False, shape=torch.Size(shape),
                              stride=contiguous_strides(shape))


def contiguous_strides(shape) -> Tuple[int, ...]:
    out, n = [], 1
    for dim in reversed(tuple(shape)):
        out.append(n)
        n *= dim
    return tuple(reversed(out))


def _partial_over_batch(pl, batch_pl):
    """``pl`` with ``Partial`` on each mesh axis ``batch_pl`` shards the batch
    over: the gradient placements of a weight used whole by a batch shard."""
    from torch.distributed.tensor import Partial, Shard

    return tuple(Partial() if isinstance(b, Shard) else p for p, b in zip(pl, batch_pl))


def _gathered(w, batch_pl, sliced: bool = False):
    """This rank's block of weight ``w`` with its DP-axis (FSDP) shards
    gathered and its TP sharding kept; its gradient partial over the DP
    axes ``batch_pl`` shards the batch over, and over TP where ``sliced``
    (a weight every TP rank holds whole but multiplies a slice of)."""
    from torch.distributed.tensor import Partial, Replicate

    names = list(_mesh(w)[1])
    pl = tuple(Replicate() if n in ("pod", "data") else p for n, p in zip(names, w.placements))
    grad = _partial_over_batch(pl, batch_pl)
    if sliced:
        grad = tuple(Partial() if n == "model" else p for n, p in zip(names, grad))
    return _to(w, pl).to_local(grad_placements=grad)


def _coordinate(mesh, names: List[str], axis: str) -> int:
    coord = mesh.get_coordinate()
    return 0 if coord is None else coord[names.index(axis)]


def _tp(sizes: Dict[str, int]) -> int:
    return sizes.get("model", 1)


def tp_size(x) -> int:
    """The size of DTensor ``x``'s TP axis (1 without one)."""
    return _tp(_mesh(x)[2])


# --------------------------------------------------------------------------- #
# Attention                                                                   #
# --------------------------------------------------------------------------- #
def attention(run: Callable, q, k, v):
    """``run(q, k, v)`` (plain ``bshk`` tensors → ``bshk``) on DTensors
    ``q`` (B, S, H, D) and ``k`` / ``v`` (B, Sk, KV, D)."""
    from torch.distributed.tensor import Partial

    mesh, names, sizes = _mesh(q)
    b, _, h, _ = q.shape
    kv = k.shape[2]
    tp = _tp(sizes)
    heads = tp > 1 and h % tp == 0
    kv_heads = heads and kv % tp == 0
    qp = _placements(names, sizes, batch_dim=0, batch=b, tp_dim=2 if heads else None)
    kp = _placements(names, sizes, batch_dim=0, batch=b, tp_dim=2 if kv_heads else None)
    q, k, v = _to(q, qp), _to(k, kp), _to(v, kp)
    # K/V replicated over the TP axis while the query heads are not: each
    # rank reads its heads' KV heads, and its K/V gradient is its share
    grad_kp = tuple(Partial() if n == "model" and heads and not kv_heads else p
                    for n, p in zip(names, kp))
    ql = q.to_local()
    kl, vl = (t.to_local(grad_placements=grad_kp) for t in (k, v))
    if heads and not kv_heads:
        hl, g = h // tp, h // kv
        first = _coordinate(mesh, names, "model") * hl // g
        n = max(1, hl // g)
        kl, vl = kl[:, :, first:first + n], vl[:, :, first:first + n]
    return _wrap(run(ql, kl, vl), mesh, qp, q.shape)


def sequence_parallel(x, n_heads: int, cache_layer) -> bool:
    """Whether a prefill's attention block runs on sequence shards over the
    TP axis, as GSPMD partitions the reference's: ``x`` (B, S, D) is a
    DTensor whose sequence divides the TP axis, the query heads do not
    divide it, and ``cache_layer`` (B, S', KV, D), the cache the block's K/V
    go to, shards its sequence over it (``build_cache_specs``' context
    parallelism) — the layout GSPMD carries back from the cache write
    through the K/V projections to the whole block."""
    from torch.distributed.tensor import Shard

    if not is_dtensor(x) or not is_dtensor(cache_layer):
        return False
    mesh, names, sizes = _mesh(cache_layer)
    tp = _tp(sizes)
    if tp <= 1 or n_heads % tp == 0 or x.shape[1] % tp:
        return False
    pl = cache_layer.placements[names.index("model")]
    return isinstance(pl, Shard) and pl.dim == 1


def seq_shard(x):
    """``x`` (B, S, ...) with its sequence sharded over the TP axis (a local
    slice of a tensor replicated over it), every other placement kept."""
    from torch.distributed.tensor import Shard

    names = list(_mesh(x)[1])
    return _to(x, tuple(Shard(1) if n == "model" else p for n, p in zip(names, x.placements)))


def is_seq_sharded(x) -> bool:
    """Whether DTensor ``x`` (B, S, ...) shards its sequence over the TP axis."""
    from torch.distributed.tensor import Shard

    names = list(_mesh(x)[1])
    pl = x.placements[names.index("model")] if "model" in names else None
    return isinstance(pl, Shard) and pl.dim == 1


def seq_attention(run: Callable, q, k, v):
    """Attention of a sequence shard of queries over every key: ``q`` (B,
    S, H, D) sharded by sequence over the TP axis, ``k`` / ``v`` (B, Sk, KV,
    D) gathered over it (all-gathers of the sequence); ``run(q, k, v, lo)``
    is the plain-tensor attention of queries at positions ``lo ..`` over
    keys at ``0 ..``. Returns the output on ``q``'s layout."""
    from torch.distributed.tensor import Replicate

    mesh, names, _ = _mesh(q)
    qp = tuple(q.placements)
    kp = tuple(Replicate() if n == "model" else p for n, p in zip(names, qp))
    ql = q.to_local()
    kl, vl = _to(k, kp).to_local(), _to(v, kp).to_local()
    lo = _coordinate(mesh, names, "model") * ql.shape[1]
    return _wrap(run(ql, kl, vl, lo), mesh, qp, q.shape)


def gqa_split(h: int, kv: int, tp: int) -> Optional[Tuple[int, int]]:
    """Where the query heads shard over a TP axis of ``tp`` and the KV heads
    do not: ``(heads a rank, KV heads a rank)``, each rank's query heads
    lying in whole groups or one group holding them (None otherwise, or
    where the KV heads shard too)."""
    if tp <= 1 or h % tp or kv % tp == 0:
        return None
    hl, g = h // tp, h // kv
    if g % hl and hl % g:
        return None
    return hl, max(1, hl // g)


def _gqa_owners(n_heads: int, n_kv: int, tp: int) -> List[int]:
    """The KV head of each of ``gqa_kv``'s virtual heads: rank c's ``n``
    virtual heads are the KV heads its query heads read."""
    hl, n = gqa_split(n_heads, n_kv, tp)
    g = n_heads // n_kv
    return [(v // n) * hl // g + v % n for v in range(tp * n)]


def gqa_kv(x, w, bias, n_kv: int, n_heads: int, hd: int):
    """The K or V projection of a GQA layer whose KV heads do not divide the
    TP axis, as GSPMD partitions the reference's: each rank computes only
    the KV heads of its own query heads from its replicated weight, and the
    weight's gradient a slice of its rows for every KV head (the KV
    gradients all-gathered over the TP axis), then all-gathers the rows.
    Returns a DTensor ``(B, S, tp x n, hd)`` of virtual heads sharded over
    the TP axis (rank c's ``n`` heads are the KV heads its query heads
    read), so ``attention`` pairs them locally.

    ``x`` (B, S, D) batch-sharded and replicated over TP; ``w`` (D, KV hd)
    and ``bias`` (KV, hd) or None, replicated (FSDP gathered)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, names, sizes = _mesh(x)
    b, s, d = x.shape
    tp = _tp(sizes)
    hl, n = gqa_split(n_heads, n_kv, tp)
    g = n_heads // n_kv
    c = _coordinate(mesh, names, "model")
    first = c * hl // g
    xp = _placements(names, sizes, batch_dim=0, batch=b, tp_dim=None)
    vp = tuple(Shard(2) if n_ == "model" else p for n_, p in zip(names, xp))
    rep = tuple(Replicate() for _ in names)
    # gradients: x's is partial over TP (this rank's heads' share); the
    # weight's partial over the DP axes its batch shard covers
    xl = _to(x, xp).to_local(grad_placements=tuple(Partial() if n_ == "model" else p
                                                   for n_, p in zip(names, xp)))
    w_grad = tuple(Partial() if p != Replicate() else Replicate() for p in xp)
    wl = _to(w, rep).to_local(grad_placements=w_grad)
    owner = torch.tensor(_gqa_owners(n_heads, n_kv, tp), device=xl.device)

    def rows_grad(dout, xl):
        full = _wrap(dout, mesh, vp, (b, s, tp * n, hd)).redistribute(mesh, xp).to_local()
        dk = full.new_zeros(full.shape[:2] + (n_kv, hd)).index_add_(2, owner, full)
        rows = d // tp
        dw = xl[..., c * rows:(c + 1) * rows].reshape(-1, rows).transpose(0, 1) @ \
            dk.reshape(-1, n_kv * hd)
        pl = tuple(Shard(0) if n_ == "model" else Replicate() for n_ in names)
        return _wrap(dw, mesh, pl, (d, n_kv * hd)).redistribute(mesh, rep).to_local()

    out = _GqaProj.apply(xl, wl, first, n, hd, rows_grad)
    if bias is not None:
        out = out + _to(bias, rep).to_local(grad_placements=w_grad)[first:first + n]
    return _wrap(out, mesh, vp, (b, s, tp * n, hd))


def gqa_kv_heads(k, n_kv: int, n_heads: int):
    """Every KV head ``(B, S, KV, hd)``, replicated over the TP axis, of a
    ``gqa_kv`` output (each rank's own KV heads as virtual heads sharded
    over it): the virtual heads all-gathered, each KV head taken from its
    first owner — what a ring's prefill write reads (the ring shards its
    slots over the TP axis, each slot holding every KV head)."""
    mesh, names, sizes = _mesh(k)
    b, s, _, hd = k.shape
    owner = _gqa_owners(n_heads, n_kv, _tp(sizes))
    first = [owner.index(j) for j in range(n_kv)]
    pl = _placements(names, sizes, batch_dim=0, batch=b, tp_dim=None)
    return _wrap(_to(k, pl).to_local()[:, :, first], mesh, pl, (b, s, n_kv, hd))


def contraction_split_proj(x, w):
    """``x @ w`` for K/V whose heads do not divide the TP axis, from an
    FSDP-sharded weight, as GSPMD partitions the reference's decode step:
    each TP rank multiplies its slice of the contraction (``x``'s last dim,
    ``w``'s rows), and an all-reduce over the TP axis sums the partial
    products — every KV head on every rank. ``x`` (..., K) batch-sharded,
    ``w`` (K, N) replicated; the output is batch-sharded and replicated
    over TP."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, names, sizes = _mesh(x)
    b = x.shape[0]
    xp = _placements(names, sizes, batch_dim=0, batch=b, tp_dim=x.ndim - 1)
    wp = tuple(Shard(0) if n == "model" else Replicate() for n in names)
    out = _to(x, xp).to_local() @ _to(w, wp).to_local()
    pl = tuple(Partial() if n == "model" else p for n, p in zip(names, xp))
    bp = _placements(names, sizes, batch_dim=0, batch=b, tp_dim=None)
    return _wrap(out, mesh, pl, tuple(x.shape[:-1]) + (w.shape[1],)).redistribute(mesh, bp)


class _GqaProj(torch.autograd.Function):
    """``x @ w[:, first hd:(first + n) hd]`` as (B, S, n, hd); the weight's
    gradient from ``rows_grad(dout, x)`` (the whole weight's, by row slices
    over the TP axis) in place of this rank's columns. ``x`` and ``w`` are
    saved as tensors, so a checkpoint's hooks see them (a closure over them
    would keep every layer's input alive under remat)."""

    @staticmethod
    def forward(ctx, xl, wl, first, n, hd, rows_grad):
        ctx.save_for_backward(xl, wl)
        ctx.cols = (first * hd, (first + n) * hd)
        ctx.rows_grad = rows_grad
        return (xl @ wl[:, first * hd:(first + n) * hd]).view(xl.shape[:2] + (n, hd))

    @staticmethod
    def backward(ctx, dout):
        xl, wl = ctx.saved_tensors
        lo, hi = ctx.cols
        dout = dout.contiguous()
        dx = dout.reshape(dout.shape[:2] + (-1,)) @ wl[:, lo:hi].transpose(0, 1)
        return dx, ctx.rows_grad(dout, xl), None, None, None, None


def fsdp_blocks(w, dim: int) -> int:
    """How many blocks the FSDP sharding cuts dim ``dim`` of DTensor ``w``
    into over the DP axes (1 where it does not shard it)."""
    from torch.distributed.tensor import Shard

    mesh, names, sizes = _mesh(w)
    return math.prod(sizes[n] for n, p in zip(names, w.placements)
                     if n in ("pod", "data") and isinstance(p, Shard) and p.dim == dim)


def grad_split(w, n_heads: int) -> int:
    """The blocks ``grad_split_proj`` splits the gradient of an attention
    weight ``w`` (rows its input dim) into: where the ``n_heads`` query
    heads do not divide the TP axis, the FSDP blocks of its rows if the TP
    axis is a multiple of them; else 1 (no split)."""
    tp = tp_size(w)
    if tp <= 1 or n_heads % tp == 0:
        return 1
    blocks = fsdp_blocks(w, 0)
    return blocks if blocks > 1 and tp % blocks == 0 else 1


def grad_split_proj(x, w, dim: int, blocks: int):
    """``x @ w`` for a weight every TP rank uses whole (a projection whose
    heads do not divide the TP axis), with its gradient partitioned as GSPMD
    partitions the reference's: ``w`` (K, N) is FSDP-sharded over the DP
    axes along ``dim`` (0 rows, 1 columns) in ``blocks`` blocks, and each TP
    rank computes the weight gradient of block (its coordinate mod
    ``blocks``) over its batch shard's tokens — the blocks' FLOPs a device,
    not the whole weight's — which an all-gather over the TP axis
    assembles (the first ``blocks`` ranks' copies; GSPMD moves each block
    to its FSDP owner instead). ``x`` (..., K) batch-sharded and replicated
    over TP, ``w`` replicated (FSDP-gathered); the output is ``x``'s layout."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, names, sizes = _mesh(x)
    b = x.shape[0]
    k, n = w.shape
    c = _coordinate(mesh, names, "model")
    copies = _tp(sizes) // blocks
    xp = _placements(names, sizes, batch_dim=0, batch=b, tp_dim=None)
    rep = tuple(Replicate() for _ in names)
    w_grad = tuple(Partial() if isinstance(p, Shard) else Replicate() for p in xp)
    xl = _to(x, xp).to_local(grad_placements=xp)
    wl = _to(w, rep).to_local(grad_placements=w_grad)
    j = c % blocks

    def block_grad(dout, xl):
        x2, d2 = xl.reshape(-1, k), dout.reshape(-1, n)
        if dim == 0:
            part, shape = x2[:, j * k // blocks:(j + 1) * k // blocks].transpose(0, 1) @ d2, \
                (copies * k, n)
        else:
            part, shape = x2.transpose(0, 1) @ d2[:, j * n // blocks:(j + 1) * n // blocks], \
                (k, copies * n)
        pl = tuple(Shard(dim) if n_ == "model" else Replicate() for n_ in names)
        whole = _wrap(part.contiguous(), mesh, pl, shape).redistribute(mesh, rep).to_local()
        return whole.narrow(dim, 0, (k, n)[dim])

    out = _SplitGradProj.apply(xl, wl, block_grad)
    return _wrap(out, mesh, xp, tuple(x.shape[:-1]) + (n,))


class _SplitGradProj(torch.autograd.Function):
    """``x @ w`` whose weight gradient is ``block_grad(dout, x)``."""

    @staticmethod
    def forward(ctx, xl, wl, block_grad):
        ctx.save_for_backward(xl, wl)
        ctx.block_grad = block_grad
        return xl @ wl

    @staticmethod
    def backward(ctx, dout):
        xl, wl = ctx.saved_tensors
        dout = dout.contiguous()
        return dout @ wl.transpose(0, 1), ctx.block_grad(dout, xl), None


def seq_sharded_proj(x, w):
    """``x @ w`` for a prefill's K or V where the cache shards its sequence
    over the TP axis: ``x`` (B, S, D) taken sequence-sharded over it (a
    local slice), times the replicated ``w`` (D, N), on each rank's rows —
    the cache's layout, every KV head of a sequence shard, as GSPMD computes
    the reference's under ``constrain_kv_for_cache``."""
    from torch.distributed.tensor import Replicate

    mesh, names, sizes = _mesh(x)
    b, s, _ = x.shape
    pl = _placements(names, sizes, batch_dim=0, batch=b, tp_dim=1)
    rep = tuple(Replicate() for _ in names)
    out = _to(x, pl).to_local() @ _to(w, rep).to_local()
    return _wrap(out, mesh, pl, (b, s, w.shape[1]))


def decode_attention(run: Callable, q, k_cache, v_cache, lengths):
    """One token a slot on DTensors: ``q`` (B, H, D), the layer's caches
    (B, S, KV, D), ``lengths`` (B,); ``run(q, k, v, lengths, return_lse)``
    is the plain-tensor decode over ``(B, KV, S, D)`` views. Returns the
    ``(B, H, D)`` output as a DTensor."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, names, sizes = _mesh(k_cache)
    b, h, d = q.shape
    cache_pl = tuple(k_cache.placements)
    model_pl = cache_pl[names.index("model")] if "model" in names else Replicate()
    by_seq = isinstance(model_pl, Shard) and model_pl.dim == 1
    by_heads = isinstance(model_pl, Shard) and model_pl.dim == 2
    batch_pl = _placements(names, sizes, batch_dim=0, batch=b, tp_dim=None)
    batch_sharded = any(isinstance(p, Shard) for n, p in zip(names, cache_pl) if n != "model")
    if not batch_sharded:
        batch_pl = _placements(names, sizes, batch_dim=None, batch=b, tp_dim=None)
    qp = tuple(Shard(1) if n == "model" and by_heads else p for n, p in zip(names, batch_pl))
    q = _to(q, qp)
    lengths = _to(lengths, batch_pl, mesh)
    ql, kl, vl, ll = q.to_local(), k_cache.to_local(), v_cache.to_local(), lengths.to_local()
    if not by_seq:
        out = run(ql, kl.transpose(1, 2), vl.transpose(1, 2), ll, False)[0]
        return _wrap(out, mesh, qp, q.shape)
    # context parallelism: this rank's keys are [lo, lo + s_l)
    s_l = kl.shape[1]
    lo = _coordinate(mesh, names, "model") * s_l
    local_len = torch.clamp(ll - lo, min=0, max=s_l).to(torch.int32)
    out, lse = run(ql, kl.transpose(1, 2), vl.transpose(1, 2), local_len, True)
    stat_pl = lambda op: tuple(Partial(op) if n == "model" else p for n, p in zip(names, batch_pl))
    lse_max = _wrap(lse, mesh, stat_pl("max"), (b, h)).redistribute(mesh, batch_pl).to_local()
    w = torch.exp(lse - lse_max)
    w = torch.where(torch.isfinite(lse), w, 0.0)
    den = _wrap(w, mesh, stat_pl("sum"), (b, h)).redistribute(mesh, batch_pl).to_local()
    num = _wrap(out.float() * w[..., None], mesh, stat_pl("sum"), (b, h, d))
    num = num.redistribute(mesh, batch_pl).to_local()
    merged = (num / den.clamp_min(1e-30)[..., None]).to(q.dtype)
    return _wrap(merged, mesh, batch_pl, (b, h, d))


def embed(table, tokens):
    """The embedding lookup of DTensor ``tokens`` (B, ...) in a ``table`` (V,
    D) sharded by vocab over the TP axis: each rank looks up the tokens its
    rows hold, zeros elsewhere, and an all-reduce over the TP axis sums
    them; batch-sharded over the DP axes."""
    from torch.distributed.tensor import Partial

    mesh, names, sizes = _mesh(table)
    lead = tuple(tokens.shape)
    b = lead[0]
    v, d = table.shape
    tp = _tp(sizes)
    by_vocab = tp > 1 and v % tp == 0
    tp_pl = _placements(names, sizes, batch_dim=None, batch=b, tp_dim=0 if by_vocab else None)
    bp = _placements(names, sizes, batch_dim=0, batch=b, tp_dim=None)
    tl = _to(tokens, bp).to_local().long()
    # the table's gradient: this batch shard's rows, partial over the DP axes
    wl = _to(table, tp_pl).to_local(grad_placements=_partial_over_batch(tp_pl, bp))
    lo = _coordinate(mesh, names, "model") * wl.shape[0] if by_vocab else 0
    mine = (tl >= lo) & (tl < lo + wl.shape[0])
    out = torch.where(mine[..., None], wl[torch.where(mine, tl - lo, 0)], 0)
    if not by_vocab:
        return _wrap(out, mesh, bp, lead + (d,))
    pl = tuple(Partial() if n == "model" else p for n, p in zip(names, bp))
    return _wrap(out, mesh, pl, lead + (d,)).redistribute(mesh, bp)


# --------------------------------------------------------------------------- #
# Cache writes                                                                #
# --------------------------------------------------------------------------- #
def _source_like(new, layer, seq_dim: int = 1):
    """``new`` (B, S', KV, D) on ``layer``'s batch and KV-head layout, its
    sequence replicated."""
    from torch.distributed.tensor import Replicate, Shard

    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == seq_dim else p
               for p in layer.placements)
    return _to(new, pl)


def _seq_offset(layer, seq_dim: int = 1) -> int:
    from torch.distributed.tensor import Shard

    mesh, names, _ = _mesh(layer)
    for n, p in zip(names, layer.placements):
        if isinstance(p, Shard) and p.dim == seq_dim:
            return _coordinate(mesh, names, n) * layer.to_local().shape[seq_dim]
    return 0


def write_token(k_layer, v_layer, k_new, v_new, index, valid) -> None:
    """``layer[b, index[b]] = new[b, 0]`` where ``valid``, each rank on the
    rows of its shard (the layer (B, S, KV, D) in place)."""
    lo = _seq_offset(k_layer)
    s_l = k_layer.to_local().shape[1]
    mesh = k_layer.device_mesh
    idx = _to(index, _batch_like(k_layer), mesh).to_local() - lo
    ok = _to(valid, _batch_like(k_layer), mesh).to_local() & (idx >= 0) & (idx < s_l)
    idx = torch.where(ok, idx, 0)
    rows = torch.arange(idx.shape[0], device=idx.device)
    keep = ok[:, None, None]
    for layer, new in ((k_layer, k_new), (v_layer, v_new)):
        ll, nl = layer.to_local(), _source_like(new, layer).to_local()
        old = ll[rows, idx]
        ll[rows, idx] = torch.where(keep, nl[:, 0].to(ll.dtype), old)


def _batch_like(layer):
    """The placements of a (B, ...) tensor that match ``layer``'s batch dim."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in layer.placements)


def write_prefill(k_layer, v_layer, k_new, v_new) -> None:
    """Rows ``[0, S')`` of the layer (B, S, KV, D) from ``new`` (B, S', KV,
    D), each rank writing its shard's rows."""
    lo = _seq_offset(k_layer)
    for layer, new in ((k_layer, k_new), (v_layer, v_new)):
        ll = layer.to_local()
        if tuple(new.placements) == tuple(layer.placements) and new.shape == layer.shape:
            ll.copy_(new.to_local())
            continue
        nl = _source_like(new, layer).to_local()
        n = max(0, min(ll.shape[1], nl.shape[1] - lo))
        ll[:, :n].copy_(nl[:, lo:lo + n])


def write_ring_prefill(k_layer, v_layer, k_new, v_new, pos_map) -> None:
    """A prefill into a ring (B, W, KV, D): slot z takes the token
    ``pos_map[b, z]`` names (zeros where -1), each rank on its shard's
    slots."""
    lo = _seq_offset(k_layer)
    w_l = k_layer.to_local().shape[1]
    pm = _to(pos_map, _batch_like(k_layer), k_layer.device_mesh).to_local()[:, lo:lo + w_l]
    for layer, new in ((k_layer, k_new), (v_layer, v_new)):
        ll, nl = layer.to_local(), _source_like(new, layer).to_local()
        rows = torch.arange(ll.shape[0], device=ll.device)[:, None]
        idx = pm.long().clamp(0, nl.shape[1] - 1)
        valid = (pm >= 0)[..., None, None]
        ll.copy_(torch.where(valid, nl[rows, idx], 0).to(ll.dtype))


# --------------------------------------------------------------------------- #
# Loss                                                                        #
# --------------------------------------------------------------------------- #
def cross_entropy(logits, labels, mask):
    """Mean next-token NLL in float32 over DTensor ``logits`` (B, S, V)
    whose vocab may be sharded over the TP axis: each rank's rows and vocab
    shard locally, with all-reduces over the TP axis of each row's max, sum
    of exponentials and gold logit, and over the DP axes of the mean."""
    from torch.distributed.tensor import Partial, Replicate

    mesh, names, sizes = _mesh(logits)
    b, s, vocab = logits.shape
    tp = _tp(sizes)
    by_vocab = tp > 1 and vocab % tp == 0
    lp = _placements(names, sizes, batch_dim=0, batch=b, tp_dim=2 if by_vocab else None)
    bp = _placements(names, sizes, batch_dim=0, batch=b, tp_dim=None)
    rep = tuple(Replicate() for _ in names)
    x = _to(logits, lp).to_local().float()
    lab = _to(labels, bp, mesh).to_local().long()
    rows = (b, s)

    def over_vocab(t, op):
        if not by_vocab:
            return t
        pl = tuple(Partial(op) if n == "model" else p for n, p in zip(names, bp))
        return _wrap(t, mesh, pl, rows).redistribute(mesh, bp).to_local()

    def over_rows(t):
        pl = tuple(Partial("sum") if p.is_shard() else Replicate() for p in bp)
        return _wrap(t, mesh, pl, ()).redistribute(mesh, rep)

    v_l = x.shape[-1]
    lo = _coordinate(mesh, names, "model") * v_l if by_vocab else 0
    m = over_vocab(x.detach().amax(-1), "max")
    logz = m + torch.log(over_vocab(torch.exp(x - m[..., None]).sum(-1), "sum"))
    mine = (lab >= lo) & (lab < lo + v_l)
    gold = torch.gather(x, -1, torch.where(mine, lab - lo, 0)[..., None])[..., 0]
    nll = logz - over_vocab(torch.where(mine, gold, 0.0), "sum")
    if mask is not None:
        ml = _to(mask, bp, mesh).to_local().float()
        return over_rows(torch.sum(nll * ml)) / torch.clamp(over_rows(torch.sum(ml)), min=1.0)
    return over_rows(torch.sum(nll)) / (b * s)


# --------------------------------------------------------------------------- #
# MoE                                                                         #
# --------------------------------------------------------------------------- #
def moe(x, p, *, route: Callable, experts: Callable, combine: Callable, group: int):
    """The MoE block on a DTensor ``x`` (B, S, D), each rank on its groups
    (a group is ``group`` tokens of one row, so the batch-sharded groups
    partition as GSPMD partitions the reference's ``(G, g, D)``): the
    router's logits on the rank's experts (all-gathered over the TP axis
    where they shard over it), routing, the capacity scatter and the gather
    run locally; the expert products
    run on the rank's expert weights (FSDP gathered) — its experts, then an
    all-gather of their outputs over the TP axis where the experts shard
    over it; its slice of the FFN width, then an all-reduce of the partial
    outputs, where that shards instead. ``route(xg, router) -> (routing,
    expert_in (G, E*C, D))``, ``experts(expert_in, weights) -> expert_out``
    and ``combine(routing, expert_out) -> out (G, g, D)`` are the plain
    block's steps (``route`` takes the logits as its third argument).
    Returns ``(out (B, S, D), aux loss)``."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, names, sizes = _mesh(x)
    b, s, d = x.shape
    xp = _placements(names, sizes, batch_dim=0, batch=b, tp_dim=None)
    x = _to(x, xp)
    rep = tuple(Replicate() for _ in names)
    model_pl = p["w_up"].placements[names.index("model")] if "model" in names else Replicate()
    router_pl = p["router"].placements[names.index("model")] if "model" in names else Replicate()
    # the input's gradient: partial over the TP axis along each path that
    # runs on the rank's experts, FFN slice or router columns alone
    on_tp = lambda sharded: tuple(Partial() if n == "model" and sharded else q
                                  for n, q in zip(names, xp))
    xl = x.to_local(grad_placements=on_tp(isinstance(model_pl, Shard)))
    xl_router = x.to_local(grad_placements=on_tp(isinstance(router_pl, Shard)))
    g_loc = xl.shape[0] * (s // group)
    g_all = b * (s // group)
    xg = xl.reshape(g_loc, group, d)
    # the router's logits on this rank's experts, all-gathered over the TP
    # axis where the experts shard over it
    router = _gathered(p["router"], xp)
    logits = xl_router.reshape(g_loc, group, d).float() @ router
    n_e = p["router"].shape[1]
    if router.shape[1] != n_e:
        pl = tuple(Shard(2) if n == "model" else q for n, q in zip(names, xp))
        logits = _wrap(logits, mesh, pl, (g_all, group, n_e)).redistribute(mesh, xp).to_local()
    r, expert_in = route(xg, None, logits)
    w = {k: _gathered(p[k], xp) for k in ("w_gate", "w_up", "w_down") if k in p}
    slots = expert_in.shape[1]
    if isinstance(model_pl, Shard) and model_pl.dim == 0:
        # this rank's experts; their outputs all-gathered over the TP axis
        e_l, n_e = w["w_up"].shape[0], p["w_up"].shape[0]
        cap = slots // n_e
        e0 = _coordinate(mesh, names, "model") * e_l
        mine = expert_in.view(g_loc, n_e, cap, d)[:, e0:e0 + e_l].reshape(g_loc, e_l * cap, d)
        pl = tuple(Shard(1) if n == "model" else q for n, q in zip(names, xp))
        eout = _wrap(experts(mine, w), mesh, pl, (g_all, slots, d)).redistribute(mesh, xp).to_local()
    elif isinstance(model_pl, Shard):
        # this rank's slice of every expert's FFN width: partial outputs
        pl = tuple(Partial() if n == "model" else q for n, q in zip(names, xp))
        eout = _wrap(experts(expert_in, w), mesh, pl, (g_all, slots, d)).redistribute(mesh, xp).to_local()
    else:
        eout = experts(expert_in, w)
    out = combine(r, eout).reshape(xl.shape)
    # the load-balancing statistics are means over every group: this rank's
    # groups' share, all-reduced over the DP axes
    share = tuple(Partial() if n in ("pod", "data") and q.is_shard() else Replicate()
                  for n, q in zip(names, xp))
    mean = lambda t: _wrap(t * (g_loc / g_all), mesh, share, t.shape).redistribute(mesh, rep).to_local()
    me, fe = mean(r.probs_mean), mean(r.first_choice_mean)
    aux = _wrap(me.shape[0] * torch.sum(me * fe), mesh, rep, ())
    return _wrap(out, mesh, xp, (b, s, d)), aux


# --------------------------------------------------------------------------- #
# Recurrent loops                                                             #
# --------------------------------------------------------------------------- #
class ModelAxis:
    """The TP axis inside a local form's loop (``on_model_shards``): this
    rank's coordinate on it, its size, the partition (``mode``) and the
    projections a step runs on plain tensors, whose collectives are
    functional collectives over the axis' group (a trace counts them):

    * ``"heads"``: each rank holds its heads' columns of the input
      projections and its heads' rows of the output projection — the input
      projection is column-parallel (its input's gradient all-reduced), the
      output row-parallel (its partial products all-reduced);
    * ``"contraction"``: the heads do not divide the axis, every rank runs
      every head, and each rank multiplies its slice of the contraction
      (``rows``) of the input projections (all-reduced) and its slice of the
      output projection's columns (``cols``, all-gathered).

    A side projection sharded by its output columns (a gate whose width
    divides the axis) runs column-parallel in both."""

    def __init__(self, mesh, names, mode: str):
        self.mode = mode
        self.size = mesh.size(names.index("model"))
        self.rank = _coordinate(mesh, names, "model")
        self.group = (mesh, names.index("model"))

    def block(self, n: int) -> slice:
        """This rank's block of ``n`` (a contraction's rows or an output's
        columns)."""
        m = n // self.size
        return slice(self.rank * m, (self.rank + 1) * m)

    def project_in(self, x, w, w_side=None):
        """``x`` (B, K), every rank's, times the input projection ``w``
        (this rank's columns, or under ``"contraction"`` its rows of the
        contraction), and ``x`` times ``w_side`` (this rank's columns) where
        given: ``(x @ w, x @ w_side)``, the first whole over this rank's
        heads, the second this rank's columns."""
        xc = _CopyToAxis.apply(x, self.group)
        if self.mode == "contraction":
            out = _ReduceOverAxis.apply(xc[:, self.block(x.shape[1])] @ w, self.group)
        else:
            out = xc @ w
        return out, (None if w_side is None else xc @ w_side)

    def project_out(self, h, w):
        """The output projection of ``h`` (B, heads x hd): this rank's heads'
        rows of ``w`` with the partial products all-reduced, or under
        ``"contraction"`` every head times this rank's columns, all-gathered."""
        if self.mode == "contraction":
            return self.gather(_CopyToAxis.apply(h, self.group) @ w)
        return _ReduceOverAxis.apply(h @ w, self.group)

    def gather(self, x):
        """Each rank's columns (the last dim) of ``x`` joined."""
        return _GatherOverAxis.apply(x, self.group, self.rank, self.size)


def _wait(t):
    from torch.distributed import _functional_collectives as funcol

    return funcol.wait_tensor(t) if isinstance(t, funcol.AsyncCollectiveTensor) else t


class _ReduceOverAxis(torch.autograd.Function):
    """The sum of every rank's partial ``x`` (an all-reduce); the gradient,
    which every rank holds whole, passes through."""

    @staticmethod
    def forward(ctx, x, group):
        from torch.distributed import _functional_collectives as funcol

        return _wait(funcol.all_reduce(x.contiguous(), "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToAxis(torch.autograd.Function):
    """``x``, which every rank holds, handed to a computation each rank does
    a part of: the identity; the partial gradients all-reduced."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as funcol

        return _wait(funcol.all_reduce(g.contiguous(), "sum", ctx.group)), None


class _GatherOverAxis(torch.autograd.Function):
    """Every rank's columns of ``x`` joined along the last dim (an
    all-gather); the gradient's own columns back."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        from torch.distributed import _functional_collectives as funcol

        ctx.rank, ctx.n = rank, x.shape[-1]
        # torch 2.13 renamed all_gather_tensor (deprecated there, the only
        # one before it): the same all_gather_into_tensor either way
        gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
        return _wait(gather(x.contiguous(), x.dim() - 1, group))

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.rank * ctx.n, ctx.n), None, None, None


def on_model_shards(fn: Callable, weights, states, *batched, mode: Optional[str],
                    sliced: Callable[[Tuple[str, ...]], bool] = lambda path: False):
    """``fn(local_weights, local_states, *local_batched, axis)`` on each
    rank's shards of plain tensors, for a recurrent loop whose steps are too
    small and too many to run as DTensor operations (xLSTM's token step, a
    few hundred operations a token): every tensor of the ``batched`` trees
    (batch leading) brought to batch over the DP axes and replicated over
    TP; ``states``, a list of tuples of (B, heads, ...) tensors, batch over
    the DP axes and, under ``mode="heads"``, heads over TP; every weight
    gathered over the DP axes with its TP sharding kept (its gradient
    partial over the DP axes the batch shards over, and over TP where
    ``sliced(path)``: a weight every rank holds whole but multiplies a slice
    of). ``axis`` is the ``ModelAxis`` of ``mode`` (None: every rank runs
    the whole step). ``fn`` returns ``(states, *outputs)``, the outputs
    batch-leading tensors replicated over TP, wrapped back on those
    layouts."""
    from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

    leaves = [t for t in tree_flatten(batched)[0] if hasattr(t, "placements")]
    mesh, names, sizes = _mesh(leaves[0])
    b = leaves[0].shape[0]
    bp = _placements(names, sizes, batch_dim=0, batch=b, tp_dim=None)
    sp = _placements(names, sizes, batch_dim=0, batch=b, tp_dim=1 if mode == "heads" else None)

    local_w = _map_with_path(lambda path, t: _gathered(t, bp, sliced(path)), weights)
    local_s = tree_map(lambda t: _to(t, sp, mesh).to_local(), states)
    local_b = tree_map(lambda t: _to(t, bp, mesh).to_local() if isinstance(t, torch.Tensor) else t,
                       batched)
    axis = ModelAxis(mesh, names, mode) if mode else None
    new_states, *outs = fn(local_w, local_s, *local_b, axis)
    wrap = lambda pl: lambda t: _wrap(t, mesh, pl, (b,) + tuple(t.shape[1:]))
    flat, spec = tree_flatten(new_states)
    head_shape = lambda t: (b, t.shape[1] * (_tp(sizes) if mode == "heads" else 1)) + tuple(t.shape[2:])
    new_states = tree_unflatten([_wrap(t, mesh, sp, head_shape(t)) for t in flat], spec)
    return (new_states, *tree_map(wrap(bp), outs))


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists (a list index is a
    path entry too)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)
