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
  * where the query heads do not divide the TP axis: a prefill's layers
    on sequence shards (``sequence_parallel``, ``seq_shard``,
    ``seq_attention``: each rank's queries over the gathered keys, the MLP
    on its rows with its weights gathered), a training forward's attention
    weight gradients in FSDP blocks over the TP ranks, each moved to its
    owner's row (``grad_split_proj``), and a decode step's K/V from FSDP
    weights over TP shards of the contraction (``contraction_split_proj``);
  * ``rowwise`` — an operation on each rank's rows (a layer norm, whose
    gradient it all-reduces once; a sequence shard's MLP);
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
    each rank's experts or FFN slice (a decode step's few tokens moved to
    FSDP-sharded expert weights, ``_stationary_experts``), each choice's
    output reduced over the TP axis;
  * ``on_model_shards`` — a recurrent loop (xLSTM's token steps) on each
    rank's batch shard, its heads split over the TP axis or, where they do
    not divide it, its stream's columns and its projections' contraction
    (``ModelAxis``).

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


def idle_dp(x) -> bool:
    """Whether DTensor ``x``'s batch (dim 0) is too small to shard over its
    DP axes (a batch of one): every DP rank then holds the same tokens, and
    GSPMD uses the DP axes to split the reference's products over their
    FSDP-sharded weights instead (its full-size long_500k cells)."""
    names = list(_mesh(x)[1])
    return not any(p.is_shard() and p.dim == 0
                   for n, p in zip(names, x.placements) if n in ("pod", "data"))


def tp_size(x) -> int:
    """The size of DTensor ``x``'s TP axis (1 without one)."""
    return _tp(_mesh(x)[2])


def rowwise_ok(x) -> bool:
    """Whether ``rowwise`` applies to DTensor ``x``: no placement partial,
    its last dim whole."""
    return not any(p.is_partial() or (p.is_shard() and p.dim in (-1, x.ndim - 1))
                   for p in x.placements)


def split_rms_norm(x, weight, eps: float):
    """RMS norm of DTensor ``x``'s rows split by their last dim over the DP
    axes (a batch of one's residual stream, ``constrain_batch_dim``): each
    rank's columns, the rows' sums of squares all-reduced over those axes,
    times ``weight``'s same columns (its FSDP shard). The output keeps
    ``x``'s placements."""
    from torch.distributed.tensor import Partial, Replicate

    mesh, names, _ = _mesh(x)
    pl = tuple(x.placements)
    split = tuple(Partial() if p.is_shard() and p.dim in (-1, x.ndim - 1) else Replicate()
                  for p in pl)
    xl = x.to_local().float()
    ss = _wrap(torch.sum(xl * xl, dim=-1, keepdim=True), mesh, split, tuple(x.shape[:-1]) + (1,))
    ss = ss.redistribute(mesh, tuple(Replicate() for _ in pl)).to_local()
    y = xl * torch.rsqrt(ss / x.shape[-1] + eps) * _shard_like_last(weight, x).float()
    return _wrap(y.to(x.dtype), mesh, pl, x.shape)


def _shard_like_last(w, x):
    """This rank's block of the 1-D ``w`` along ``x``'s last dim's split."""
    from torch.distributed.tensor import Replicate, Shard

    pl = tuple(Shard(0) if p.is_shard() and p.dim in (-1, x.ndim - 1) else Replicate()
               for p in x.placements)
    return _to(w, pl).to_local()


def rowwise(fn: Callable, x, *params):
    """``fn(x, *params)`` on each rank's rows of DTensor ``x`` (its last
    dim whole, ``rowwise_ok``), the output on ``x``'s placements; each param
    (or None) gathered whole (its gradient partial over the axes ``x``'s
    rows shard over). For a norm, its backward takes the output's gradient
    on those placements — a gradient partial over the TP axis (the
    column-parallel products' input gradients) is all-reduced once, as
    GSPMD reduces the reference's — where DTensor's own layer-norm backward
    reduce-scatters it over the batch and all-gathers the input's gradient
    back. For an MLP on a prefill's sequence shards (``sequence_parallel``)
    its weights are all-gathered over the TP axis and each rank runs its
    rows, as GSPMD partitions the reference's at every size (the smoke
    (1, 8) cells' and the full-size 16 x 16 cells' HLO gather the MLP
    weights, and reduce the activations once, at the last token)."""
    from torch.distributed.tensor import Replicate

    mesh = x.device_mesh
    pl = tuple(x.placements)
    rep = tuple(Replicate() for _ in pl)
    grad = _partial_over_batch(rep, pl)
    local = fn(x.to_local(grad_placements=pl),
               *(None if w is None else _to(w, rep).to_local(grad_placements=grad) for w in params))
    return _wrap(local, mesh, pl, x.shape)


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


def sequence_parallel(x, n_heads: int, cache_layer, *, in_loop: bool = True) -> bool:
    """Whether a prefill's layers run on sequence shards over the TP axis,
    as GSPMD partitions the reference's: ``x`` (B, S, D) is a DTensor whose
    sequence divides the TP axis, the query heads do not divide it, and
    ``cache_layer`` (B, S', KV, D), the cache the block's K/V go to, shards
    its sequence over it (``build_cache_specs``' context parallelism) — the
    layout GSPMD carries back from the cache write through the K/V
    projections to the whole block, and on to the MLP, whose weights it
    gathers (``rowwise``).

    ``in_loop``: the cache write sits in the layers' own loop (a decoder's
    prefill), which pins the layout at every size. Where it does not
    (Whisper's encoder, whose output the decoder's cross caches take), the
    layers run on sequence shards only while ``x``'s ``S`` tokens attend in
    one dense product (``S <= DENSE_MAX_SEQ``): past it the reference's
    attention loops over query chunks, whose dynamic slices GSPMD does not
    partition, and the encoder's compiled layers replicate over the TP axis.
    The HLO reads so on both sides of the bound: Whisper's smoke (1, 8)
    prefill (32 frames) gathers its cross K/V by sequence, its full-size
    16 x 16 prefill (32,768 frames) all-reduces each encoder layer's
    ``(2, 32768, 768)`` output and runs every head on every model rank.

    The decoders' attention itself stays on the rank's query rows over the
    gathered keys (``seq_attention``) at every size: past ``DENSE_MAX_SEQ``
    the reference's all-gathers the queries as well and runs every query on
    every model rank (StarCoder2's, Qwen2-VL's full-size HLO), more FLOPs
    and more elements than the rows (``tests/test_torch_dryrun_full.py``'s
    gaps)."""
    from torch.distributed.tensor import Shard

    from ..kernels.flash_attention import DENSE_MAX_SEQ

    if not is_dtensor(x) or not is_dtensor(cache_layer):
        return False
    mesh, names, sizes = _mesh(cache_layer)
    tp = _tp(sizes)
    if tp <= 1 or n_heads % tp == 0 or x.shape[1] % tp:
        return False
    if not in_loop and x.shape[1] > DENSE_MAX_SEQ:
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


#: the attention projections a layer's view leaves FSDP-sharded where their
#: gradients split (``grad_split_proj`` gathers them) and in a batch of
#: one's decode step (each product runs over the rank's FSDP rows)
ATTN_WEIGHTS = ("wq", "wk", "wv", "wo")


def grad_split(w, n_heads: int) -> int:
    """The blocks ``grad_split_proj`` splits the gradient of an attention
    weight ``w`` (rows its input dim) into: where the ``n_heads`` query
    heads do not divide the TP axis, the FSDP blocks of its rows if the TP
    axis is a multiple of them; else 1 (no split)."""
    tp = tp_size(w)
    if tp <= 1 or n_heads % tp == 0 or _mesh(w)[1] != ["data", "model"]:
        return 1
    blocks = fsdp_blocks(w, 0)
    return blocks if blocks > 1 and tp % blocks == 0 else 1


def grad_split_proj(x, w, dim: int, blocks: int):
    """``x @ w`` for a weight every TP rank uses whole (a projection whose
    heads do not divide the TP axis), with its gradient partitioned as GSPMD
    partitions the reference's: ``w`` (K, N) is FSDP-sharded over the data
    axis along ``dim`` (0 rows, 1 columns) in ``blocks`` blocks (its local
    block all-gathered over the data axis), and each TP rank computes the
    weight gradient of block (its coordinate mod ``blocks``) over its batch
    shard's tokens — the blocks' FLOPs a device, not the whole weight's.
    Each block goes to a rank of its FSDP owner's row (a permute over the
    mesh: rank (d, j + blocks c) sends to (j, d + blocks c)) and an
    all-reduce over the TP axis sums the batch shards (each ``tp / blocks``
    times), as GSPMD moves each block to its owner by a collective-permute:
    one block moved and reduced a rank, not the whole weight gathered. ``x``
    (..., K) batch-sharded and replicated over TP; the output is ``x``'s
    layout."""
    from torch.distributed import _functional_collectives as funcol

    mesh, names, sizes = _mesh(x)
    b = x.shape[0]
    k, n = w.shape
    tp = _tp(sizes)
    copies = tp // blocks
    c = _coordinate(mesh, names, "model")
    j = c % blocks
    xp = _placements(names, sizes, batch_dim=0, batch=b, tp_dim=None)
    xl = _to(x, xp).to_local(grad_placements=xp)
    wl = w.to_local(grad_placements=tuple(w.placements))
    data_axis, model_axis = (mesh, names.index("data")), (mesh, names.index("model"))
    group = _mesh_group(mesh)
    # group index i = (d, m) row-major; block m % blocks of batch shard d
    # goes to (m % blocks, d + blocks (m // blocks))
    dest = [(m % blocks) * tp + i // tp + blocks * (m // blocks)
            for i, m in ((i, i % tp) for i in range(mesh.size()))]

    def gather(wl):
        return _all_gather(wl, dim, data_axis)

    def block_grad(dout, xl):
        x2, d2 = xl.reshape(-1, k), dout.reshape(-1, n)
        if dim == 0:
            part = x2[:, j * k // blocks:(j + 1) * k // blocks].transpose(0, 1) @ d2
        else:
            part = x2.transpose(0, 1) @ d2[:, j * n // blocks:(j + 1) * n // blocks]
        moved = _permute(part, group, dest)
        total = _wait(funcol.all_reduce(moved, "sum", model_axis))
        return total if copies == 1 else total / copies

    out = _SplitGradProj.apply(xl, wl, gather, block_grad)
    return _wrap(out, mesh, xp, tuple(x.shape[:-1]) + (n,))


def _swap_data_model(mesh):
    """``(group, dest)`` of a permute that sends rank (…, d, m) of ``mesh``
    to rank (…, m, d): the data and model coordinates swapped (their sizes
    equal), every other axis kept; its own inverse."""
    names = list(mesh.mesh_dim_names)
    shape = tuple(mesh.shape)
    i, j = names.index("data"), names.index("model")
    dest = []
    for flat in range(math.prod(shape)):
        coord, rest = [], flat
        for n in reversed(shape):
            coord.append(rest % n)
            rest //= n
        coord.reverse()
        coord[i], coord[j] = coord[j], coord[i]
        dest.append(sum(c * math.prod(shape[k + 1:]) for k, c in enumerate(coord)))
    return _mesh_group(mesh), dest


class _Permute(torch.autograd.Function):
    """``x`` sent along a permute that is its own inverse (``dest``); the
    gradient sent back along it."""

    @staticmethod
    def forward(ctx, x, group, dest):
        ctx.group, ctx.dest = group, dest
        return _permute(x, group, dest)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.group, ctx.dest), None, None


def _permute(x, group, dest):
    from torch.distributed import _functional_collectives as funcol

    return _wait(funcol.permute_tensor(x.contiguous().reshape(-1), dest, group)).view(x.shape)


def swappable(x) -> bool:
    """Whether DTensor ``x``'s mesh has data and model axes of one size
    and its batch is too small to shard over the DP axes (``idle_dp``): the
    DP ranks can then split a product's columns among the TP ranks'
    blocks (``idle_dp_columns``, ``ModelAxis``)."""
    sizes = _mesh(x)[2]
    return "data" in sizes and sizes["data"] == sizes.get("model") and idle_dp(x)


def idle_dp_columns(x, w):
    """``x @ w`` for ``x`` (..., K) split by its last dim over the TP axis
    and replicated over the DP axes (a batch too small to shard over them,
    ``swappable``), ``w`` (K, N) split by its rows over the TP axis: each
    rank (d, m) multiplies its rows' block by the columns' block d — the
    DP axis splits the columns, as GSPMD partitions the reference's
    RG-LRU gates in a batch-of-one decode step — an all-reduce over the TP
    axis sums the row blocks, and a permute swapping the data and model
    coordinates brings each rank its own columns' block. The output is split
    by its last dim over the TP axis like ``x``."""
    from torch.distributed.tensor import Replicate

    mesh, names, sizes = _mesh(x)
    n = w.shape[1]
    d0 = _coordinate(mesh, names, "data")
    cols = n // sizes["data"]
    xl = x.to_local(grad_placements=tuple(x.placements))
    wl = _to(w, tuple(p if n_ == "model" else Replicate() for n_, p in zip(names, w.placements)))
    wl = wl.to_local(grad_placements=_partial_over_batch(tuple(wl.placements), tuple(x.placements)))
    part = xl @ wl[:, d0 * cols:(d0 + 1) * cols]
    summed = _ReduceOverAxis.apply(part, (mesh, names.index("model")), True)
    group, dest = _swap_data_model(mesh)
    return _wrap(_Permute.apply(summed, group, dest), mesh, tuple(x.placements),
                 tuple(x.shape[:-1]) + (n,))


def _mesh_group(mesh):
    """A group of every rank of ``mesh`` in its row-major order: the world's
    where the mesh spans it in rank order, else the list of its ranks (read
    outside any fake mode: the mesh's rank table is a real tensor)."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily():
        ranks = mesh.mesh.flatten().tolist()
    return dist.group.WORLD if ranks == list(range(dist.get_world_size())) else ranks


class _SplitGradProj(torch.autograd.Function):
    """``x @ gather(w)`` whose weight gradient is ``block_grad(dout, x)``
    (the gradient of ``w``, this rank's block)."""

    @staticmethod
    def forward(ctx, xl, wl, gather, block_grad):
        whole = gather(wl)
        ctx.save_for_backward(xl, whole)
        ctx.block_grad = block_grad
        return xl @ whole

    @staticmethod
    def backward(ctx, dout):
        xl, whole = ctx.saved_tensors
        dout = dout.contiguous()
        return dout @ whole.transpose(0, 1), ctx.block_grad(dout, xl), None, None


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
    heads_pl = q.placements[names.index("model")] if "model" in names else Replicate()
    hl, g = h // _tp(sizes), h // k_cache.shape[2]
    if by_seq and isinstance(heads_pl, Shard) and heads_pl.dim == 1 and swappable(q) \
            and (g % hl == 0 or hl % g == 0):
        return _decode_heads_over_dp(run, q, k_cache, v_cache, lengths)
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


def _decode_heads_over_dp(run: Callable, q, k_cache, v_cache, lengths):
    """``decode_attention`` for a cache sharded by sequence over the TP axis
    and a batch the DP axes do not shard (``swappable``), ``q``'s heads
    split over the TP axis: as GSPMD partitions the reference's batch-of-one
    decode step, rank (d, m) takes the query heads' block d (a permute
    swapping the data and model coordinates), decodes them over its keys,
    merges them over the TP axis by their log-sum-exp and sends block m
    back — each rank reduces its block's statistics and partial output,
    not every head's."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate

    mesh, names, sizes = _mesh(k_cache)
    b, h, d = q.shape
    group, dest = _swap_data_model(mesh)
    model = (mesh, names.index("model"))
    ql = _permute(q.to_local(), group, dest)                      # heads' block d
    hl, n_kv = ql.shape[1], k_cache.shape[2]
    g = h // n_kv
    first = _coordinate(mesh, names, "data") * hl // g
    n = max(1, hl // g)
    kl, vl = (t.to_local()[:, :, first:first + n].transpose(1, 2) for t in (k_cache, v_cache))
    s_l = kl.shape[2]
    lo = _coordinate(mesh, names, "model") * s_l
    ll = _to(lengths, tuple(Replicate() for _ in names), mesh).to_local()
    local_len = torch.clamp(ll - lo, min=0, max=s_l).to(torch.int32)
    out, lse = run(ql, kl, vl, local_len, True)
    lse_max = _wait(funcol.all_reduce(lse, "max", model))
    w = torch.where(torch.isfinite(lse), torch.exp(lse - lse_max), 0.0)
    den = _wait(funcol.all_reduce(w, "sum", model))
    num = _wait(funcol.all_reduce(out.float() * w[..., None], "sum", model))
    merged = _permute((num / den.clamp_min(1e-30)[..., None]).to(q.dtype), group, dest)
    return _wrap(merged, mesh, tuple(q.placements), (b, h, d))


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
    run on the rank's expert weights (FSDP gathered) — its experts where the
    experts shard over the TP axis, its slice of the FFN width where that
    shards instead — and each choice's output, partial over the TP axis, is
    all-reduced before the gates weigh it. ``route(xg, router) -> (routing,
    expert_in (G, E*C, D))``, ``experts(expert_in, weights) -> expert_out``
    and ``combine(routing, expert_out, reduce) -> out (G, g, D)`` are the
    plain block's steps (``route`` takes the logits as its third argument,
    ``combine`` applies ``reduce`` to the gathered choices).
    Returns ``(out (B, S, D), aux loss)``."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, names, sizes = _mesh(x)
    b, s, d = x.shape
    # a batch of one's rows split by their model dim over the DP axes
    # (``sharding.constrain_batch_dim``) stay split: each rank routes and
    # runs its slice of the model dim against its FSDP-sharded weights
    keys = [k for k in ("w_gate", "w_up", "w_down") if k in p]
    split = [n for n, q in zip(names, x.placements)
             if n in ("pod", "data") and q.is_shard() and q.dim == 2] if _ffn_fsdp(p, keys) else []
    xp = _placements(names, sizes, batch_dim=0, batch=b, tp_dim=None)
    if split:
        xp = tuple(Shard(2) if n in split else q for n, q in zip(names, xp))
    x = _to(x, xp)
    d_l = d // math.prod(sizes[n] for n in split)
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
    xg = xl.reshape(g_loc, group, d_l)
    # the router's logits on this rank's experts, all-gathered over the TP
    # axis where the experts shard over it (on split rows: its FSDP rows'
    # partial logits, all-reduced over the DP axes)
    router = p["router"].to_local() if split else _gathered(p["router"], xp)
    logits = xl_router.reshape(g_loc, group, d_l).float() @ router
    n_e = p["router"].shape[1]
    if split or router.shape[1] != n_e:
        pl = tuple(Shard(2) if n == "model" and router.shape[1] != n_e
                   else Partial() if n in split else q for n, q in zip(names, xp))
        whole = tuple(Replicate() if n in split else q for n, q in zip(names, xp))
        logits = _wrap(logits, mesh, pl, (g_all, group, n_e)).redistribute(mesh, whole).to_local()
    r, expert_in = route(xg, None, logits)
    slots = expert_in.shape[1]
    stationary = _stationary_experts(p, keys, xp, expert_in.shape[0] * slots, d, bool(split))
    w = {k: p[k].to_local() if stationary else _gathered(p[k], xp) for k in keys}
    # each choice's expert output, partial over the TP axis where the rank
    # computes a part of the expert outputs (zeros in other experts' slots,
    # or its slice of the FFN width): all-reduced after the gather, on the
    # (groups, choices, D) the combine weighs, as GSPMD reduces the
    # reference's
    partial = tuple(Partial() if n == "model" else q for n, q in zip(names, xp))
    reduce = lambda t: _wrap(t, mesh, partial, (g_all, t.shape[1], d if split else t.shape[2])
                             ).redistribute(mesh, xp).to_local()
    if isinstance(model_pl, Shard) and model_pl.dim == 0:
        # this rank's experts
        e_l, n_e = w["w_up"].shape[0], p["w_up"].shape[0]
        cap = slots // n_e
        e0 = _coordinate(mesh, names, "model") * e_l
        mine = expert_in.view(g_loc, n_e, cap, d)[:, e0:e0 + e_l].reshape(g_loc, e_l * cap, d)
        eout = torch.nn.functional.pad(experts(mine, w), (0, 0, e0 * cap, (n_e - e0 - e_l) * cap))
        out = combine(r, eout, reduce)
    elif isinstance(model_pl, Shard):
        # this rank's slice of every expert's FFN width
        out = combine(r, experts(expert_in, w, stationary), reduce)
    else:
        out = combine(r, experts(expert_in, w))
    out = out.reshape(xl.shape)
    # the load-balancing statistics are means over every group: this rank's
    # groups' share, all-reduced over the DP axes
    share = tuple(Partial() if n in ("pod", "data") and q.is_shard() else Replicate()
                  for n, q in zip(names, xp))
    mean = lambda t: _wrap(t * (g_loc / g_all), mesh, share, t.shape).redistribute(mesh, rep).to_local()
    me, fe = mean(r.probs_mean), mean(r.first_choice_mean)
    aux = _wrap(me.shape[0] * torch.sum(me * fe), mesh, rep, ())
    return _wrap(out, mesh, xp, (b, s, d)), aux


def _ffn_fsdp(p, keys) -> bool:
    """Whether the experts' FFN width shards over the TP axis and their model
    dim over the DP axes (FSDP)."""
    from torch.distributed.tensor import Shard

    mesh, names, _ = _mesh(p["w_up"])
    dp = [n for n in names if n in ("pod", "data")]
    for k in keys:
        pl, dim = dict(zip(names, p[k].placements)), 2 if k == "w_down" else 1
        if pl.get("model") != Shard(3 - dim) or any(pl[n] != Shard(dim) for n in dp):
            return False
    return bool(dp)


def _stationary_experts(p, keys, xp, tokens: int, d: int, split: bool = False) -> Optional[Callable]:
    """Where the experts' FFN width shards over the TP axis, their model
    dim over the DP axes (FSDP), and moving a batch shard's ``tokens``
    expert slots (every DP rank's, where the batch does not shard over the
    DP axes) moves fewer elements than gathering the weights: a
    ``bmm(x, name)`` that leaves each weight's block where it lies, as GSPMD
    partitions the reference's decode step (the full-size 16 x 16 HLO moves
    the hidden activations, not the down projection): the input and gate
    projections take ``x`` (E, T, D) split by its model dim over the DP
    axes (an all-to-all) and reduce-scatter their partial products back to
    the tokens; the down projection all-gathers the hidden ``x`` (E, T, F)
    over the DP axes and all-to-alls its model-dim blocks back to the
    tokens, partial over the TP axis like the gathered route's; tokens whose
    model dim is already split over the DP axes (``split``) multiply their
    slice and keep the down projection's output split. Else None (the
    weights all-gathered, ``_gathered``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, names, sizes = _mesh(p["w_up"])
    dp = [n for n in names if n in ("pod", "data")]
    batch = {xp[names.index(n)].is_shard() and xp[names.index(n)].dim == 0 for n in dp}
    if not _ffn_fsdp(p, keys) or len(batch) != 1:
        return None
    # the tokens: split over the DP axes with the batch, or on every DP rank
    tok = Shard(1) if batch == {True} else Replicate()
    n_dp = math.prod(sizes[n] for n in dp)
    n_tok = n_dp if tok.is_shard() else 1
    e, _, f = p["w_up"].shape
    f_l = f // sizes["model"]
    if tok.is_shard():
        moved = (len(keys) - 1) * (tokens * d + tokens * f_l) + tokens * n_dp * f_l + tokens * d
    else:
        moved = (len(keys) - 1) * tokens * f_l + (0 if split else tokens * d)
    gathered = len(keys) * e * d * f_l
    if moved >= gathered:
        return None

    def on(dp_pl, model_pl):
        return tuple(dp_pl if n in dp else model_pl if n == "model" else Replicate() for n in names)

    def bmm(x, k):
        ne, t, _ = x.shape
        wl = p[k].to_local()
        if k == "w_down":
            xs = _wrap(x, mesh, on(tok, Shard(2)), (ne, t * n_tok, f))
            xs = xs.redistribute(mesh, on(Replicate(), Shard(2))).to_local()
            if split:
                return torch.bmm(xs, wl)
            y = _wrap(torch.bmm(xs, wl), mesh, on(Shard(2), Partial()), (ne, t * n_tok, d))
            return y.redistribute(mesh, on(tok, Partial())).to_local()
        if split:
            xs = x
        else:
            xs = _wrap(x, mesh, on(tok, Replicate()), (ne, t * n_tok, d))
            xs = xs.redistribute(mesh, on(Shard(2), Replicate())).to_local()
        y = _wrap(torch.bmm(xs, wl), mesh, on(Partial(), Shard(2)), (ne, t * n_tok, f))
        return y.redistribute(mesh, on(tok, Shard(2))).to_local()

    return bmm


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
      every head, and the residual stream stays split by its columns over
      the axis (``columns`` on entry, ``gather`` on exit), as GSPMD
      partitions the reference's step: the norms reduce their row
      statistics over the axis (``rms_norm``), each rank multiplies its
      columns (its slice of the contraction, ``rows``) by its rows of the
      input projections (all-reduced), and its output projections' columns
      add to its columns of the stream — no gather but the one of the
      normed input a side projection reads.

    A side projection sharded by its output columns (a gate whose width
    divides the axis) runs column-parallel in both."""

    def __init__(self, mesh, names, mode: str, swap: bool = False):
        self.mode = mode
        self.size = mesh.size(names.index("model"))
        self.rank = _coordinate(mesh, names, "model")
        self.group = (mesh, names.index("model"))
        # a batch the DP axes do not shard, on data and model axes of one
        # size (``swappable``): a side projection splits its contraction
        # over the data axis instead of gathering its input
        self.swap = _swap_data_model(mesh) + ((mesh, names.index("data")),) if swap else None

    def block(self, n: int) -> slice:
        """This rank's block of ``n`` (a contraction's rows or an output's
        columns)."""
        m = n // self.size
        return slice(self.rank * m, (self.rank + 1) * m)

    def columns(self, x):
        """This rank's columns (the last dim) of ``x``, which every rank
        holds whole (its gradient's columns all-gathered)."""
        return _ColumnsOfAxis.apply(x, self.group, self.rank, self.size)

    def rms_norm(self, x, scale, eps: float):
        """RMS norm of the rows of which ``x`` holds this rank's columns,
        times ``scale``'s same columns: the row's sum of squares all-reduced
        over the axis."""
        ss = _ReduceOverAxis.apply(torch.sum(x.float() ** 2, dim=-1, keepdim=True), self.group,
                                   True)
        y = x.float() * torch.rsqrt(ss / (x.shape[-1] * self.size) + eps) * scale.float()
        return y.to(x.dtype)

    def project_in(self, x, w, w_side=None):
        """``x`` (B, K) times the input projection ``w`` and, where given,
        the side projection ``w_side`` (this rank's columns): ``(x @ w, x @
        w_side)``, the first whole over this rank's heads, the second this
        rank's columns. Under ``"contraction"`` ``x`` is this rank's
        columns and ``w`` its rows (the products all-reduced), ``x``
        all-gathered for the side projection."""
        if self.mode == "contraction":
            out = _ReduceOverAxis.apply(x @ w, self.group)
            if w_side is None:
                return out, None
            if self.swap:
                # rank (d, m) takes the columns' block d (from rank (m, d))
                # and its rows of the side projection; summed over the data axis
                group, dest, data = self.swap
                xd = _Permute.apply(x, group, dest)
                rows = w_side.shape[0] // self.size
                d0 = _coordinate(data[0], list(data[0].mesh_dim_names), "data")
                return out, _ReduceOverAxis.apply(xd @ w_side[d0 * rows:(d0 + 1) * rows], data, True)
            return out, _GatherOverAxis.apply(x, self.group, self.rank, self.size, True) @ w_side
        xc = _CopyToAxis.apply(x, self.group)
        return xc @ w, (None if w_side is None else xc @ w_side)

    def project_out(self, h, w):
        """The output projection of ``h`` (B, heads x hd): this rank's heads'
        rows of ``w`` with the partial products all-reduced, or under
        ``"contraction"`` every head times this rank's columns (the
        stream's columns)."""
        if self.mode == "contraction":
            return _CopyToAxis.apply(h, self.group) @ w
        return _ReduceOverAxis.apply(h @ w, self.group)

    def gather(self, x):
        """Each rank's columns (the last dim) of ``x`` joined."""
        return _GatherOverAxis.apply(x, self.group, self.rank, self.size)


def _wait(t):
    from torch.distributed import _functional_collectives as funcol

    return funcol.wait_tensor(t) if isinstance(t, funcol.AsyncCollectiveTensor) else t


class _ReduceOverAxis(torch.autograd.Function):
    """The sum of every rank's partial ``x`` (an all-reduce); the gradient,
    which every rank holds whole, passes through, or where each rank uses
    the sum for a part of its work (``partial_grad``), is all-reduced."""

    @staticmethod
    def forward(ctx, x, group, partial_grad=False):
        from torch.distributed import _functional_collectives as funcol

        ctx.group, ctx.partial_grad = group, partial_grad
        return _wait(funcol.all_reduce(x.contiguous(), "sum", group))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as funcol

        if ctx.partial_grad:
            g = _wait(funcol.all_reduce(g.contiguous(), "sum", ctx.group))
        return g, None, None


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


def _all_gather(x, dim: int, group):
    from torch.distributed import _functional_collectives as funcol

    # torch 2.13 renamed all_gather_tensor (deprecated there, the only one
    # before it): the same all_gather_into_tensor either way
    gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
    return _wait(gather(x.contiguous(), dim, group))


class _GatherOverAxis(torch.autograd.Function):
    """Every rank's columns of ``x`` joined along the last dim (an
    all-gather); the gradient's own columns back, summed over the ranks
    first where each uses the whole for a part of its work
    (``partial_grad``: a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group, rank, size, partial_grad=False):
        ctx.rank, ctx.n, ctx.group, ctx.partial_grad = rank, x.shape[-1], group, partial_grad
        return _all_gather(x, x.dim() - 1, group)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as funcol

        if ctx.partial_grad:
            # reduce_scatter_single: torch 2.13's name of reduce_scatter_tensor
            scatter = getattr(funcol, "reduce_scatter_single", None) or funcol.reduce_scatter_tensor
            g = _wait(scatter(g.contiguous(), "sum", g.dim() - 1, ctx.group))
            return g, None, None, None, None
        return g.narrow(-1, ctx.rank * ctx.n, ctx.n), None, None, None, None


class _ColumnsOfAxis(torch.autograd.Function):
    """This rank's columns of ``x``, which every rank holds whole; the
    gradient's columns all-gathered."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.group = group
        n = x.shape[-1] // size
        return x.narrow(-1, rank * n, n)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, g.dim() - 1, ctx.group), None, None, None


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
    axis = ModelAxis(mesh, names, mode, mode == "contraction" and swappable(leaves[0])) if mode else None
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
