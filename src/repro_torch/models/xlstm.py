"""xLSTM (arXiv:2405.04517): alternating mLSTM / sLSTM blocks, serving and
training paths (counterpart of ``repro.models.xlstm``).

The recurrent state replaces the KV cache: per pair of blocks, the mLSTM's
matrix memory C (B, H, hd, hd), normaliser n and stabiliser m, and the
sLSTM's c, n, h (B, H, hd) and m (B, H). Both cells gate exponentially with
the paper's max-stabiliser, in float32 and in the reference's order; the
width-4 convs of the paper's blocks are omitted as in the reference.

* Parameters keep the reference's tree: ``pairs`` holds the stacked
  ``mlstm`` and ``slstm`` weights of every pair, ``embed`` (tied or not)
  and ``norm_final``. The reference's ``lax.scan`` over pairs is a loop
  over per-pair views, and its ``lax.scan`` over time a loop over tokens.
* A pair's view holds its weights in float32, as the reference casts them
  at every step, with the projections that read the same normed input
  joined into one matrix: q | k | v | i,f-gates | output gate for the
  mLSTM, z | i | f | o for the sLSTM, whose four head-wise recurrent
  matrices are joined along their output axis. A column of a joined
  product is the product of its own matrix, so the values are the
  reference's up to summation order. Serving keeps the views
  (``layers.ViewCache``, refreshed in place after an optimizer step);
  training builds them on every call.
* ``forward`` / ``loss``: the training forward runs the token step over
  time chunks of ``time_chunk`` (64) tokens and, with ``remat``,
  checkpoints each chunk (``torch.utils.checkpoint``), as the reference
  rematerialises each chunk: the backward keeps one carry a chunk and
  recomputes the chunk's steps.
* ``prefill`` (ragged prompts: a slot's state freezes past its length) and
  ``decode_step`` run under ``no_grad`` and update the cache in place,
  returning it as the reference returns a new one. No kernel of the TPU
  package computes these cells: they are plain PyTorch, and the wave
  server replays each decode step as one CUDA graph.
* On a mesh (the dry-run's DTensors) the training forward's zero state is
  batch-sharded (``sharding.batch_zeros``, the reference's
  ``constrain_batch_dim``), and the token loops (a training chunk, a
  prefill, a decode step) run as local forms on each rank's batch shard,
  partitioned over the TP axis as GSPMD partitions the reference's steps:
  by heads where they divide it, else by the projections' contraction and
  columns (``_on_shards``, ``spmd.on_model_shards``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..configs.base import ArchConfig
from ..distributed import spmd
from ..distributed.sharding import batch_zeros, is_dtensor
from .layers import (
    DTYPES,
    ParamDef,
    ViewCache,
    apply_norm,
    cross_entropy_loss,
    embed_defs,
    embed_tokens,
    init_params,
    layer_slice,
    norm_defs,
    records_grad,
    unembed,
)

Params = Dict[str, Any]
State = Tuple[torch.Tensor, ...]   # (mC, mn, mm, sc, sn, sh, sm) of one pair
STATE_KEYS = ("m_C", "m_n", "m_m", "s_c", "s_n", "s_h", "s_m")


def mlstm_cell(state, q, k, v, i_pre, f_pre):
    """state: (C (B,H,hd,hd), n (B,H,hd), m (B,H)); q, k, v (B,H,hd)."""
    C, n, m = state
    m_new = torch.maximum(f_pre + m, i_pre)                     # (B,H)
    i_g = torch.exp(i_pre - m_new)[..., None]                   # (B,H,1)
    f_g = torch.exp(f_pre + m - m_new)[..., None]
    outer = v[..., :, None] * k[..., None, :]                   # (B,H,hd,hd)
    C = f_g[..., None] * C + i_g[..., None] * outer
    n = f_g * n + i_g * k
    num = (C @ q[..., None])[..., 0]
    den = torch.clamp(torch.abs((n * q).sum(-1)), min=1.0)[..., None]
    return (C, n, m_new), num / den


def slstm_cell(state, z_pre, i_pre, f_pre, o_pre):
    """state: (c, n, h (B,H,hd), m (B,H)); gate preactivations (B,H,hd)."""
    c, n, h, m = state
    m_new = torch.maximum(f_pre.amax(-1) + m, i_pre.amax(-1))
    i_g = torch.exp(i_pre - m_new[..., None])
    f_g = torch.exp(f_pre + m[..., None] - m_new[..., None])
    z = torch.tanh(z_pre)
    c = f_g * c + i_g * z
    n = f_g * n + i_g
    h = torch.sigmoid(o_pre) * c / torch.clamp(n, min=1.0)
    return (c, n, h, m_new), h


class XLSTM:
    """xLSTM on ``device`` (default the CUDA device; raises if there is
    none — pass ``device="cpu"`` for the plain path)."""

    #: the stacked subtrees, one entry a pair (``train.train_step``)
    STACKS = ("pairs",)

    def __init__(self, cfg: ArchConfig, device="cuda"):
        if cfg.n_layers % 2 != 0:
            raise ValueError("XLSTM expects an even layer count (mLSTM/sLSTM pairs)")
        self.cfg = cfg
        self.n_pairs = cfg.n_layers // 2
        self.hd = cfg.resolved_head_dim or cfg.d_model // cfg.n_heads
        self.dtype = DTYPES[cfg.dtype]
        self.device = resolve_device(device)
        self._cached = ViewCache(self._build_views)

    # ------------------------------------------------------------------ #
    # Parameters                                                          #
    # ------------------------------------------------------------------ #
    def param_defs(self) -> Params:
        cfg, hd, dt = self.cfg, self.hd, self.dtype
        P, H, d = self.n_pairs, cfg.n_heads, cfg.d_model
        def proj(*shape_axes):
            shape, axes = zip(*shape_axes)
            return ParamDef((P,) + shape, dt, axes=("layers",) + axes)

        e, h, k = (d, "embed"), (H, "heads"), (hd, "head_dim")
        mlstm = {
            "norm": norm_defs(d, cfg.norm_kind, dt, layers=P),
            "wq": proj(e, h, k),
            "wk": proj(e, h, k),
            "wv": proj(e, h, k),
            "wif": proj(e, h, (2, None)),          # i / f gate preactivations
            "wgate": proj(e, (d, "rnn")),
            "wout": proj(h, k, e),
        }
        slstm = {
            "norm": norm_defs(d, cfg.norm_kind, dt, layers=P),
            **{w: proj(e, h, k) for w in ("wz", "wi", "wf", "wo")},
            **{r: proj(h, k, (hd, None)) for r in ("rz", "ri", "rf", "ro")},
            "wout": proj(h, k, e),
        }
        return {
            "embed": embed_defs(cfg.vocab_size, d, dt, tie=cfg.tie_embeddings),
            "pairs": {"mlstm": mlstm, "slstm": slstm},
            "norm_final": norm_defs(d, cfg.norm_kind, dt),
        }

    def init_params(self, seed: int = 0) -> Params:
        """Random parameters drawn on the model's device from a seeded
        ``torch.Generator``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return init_params(self.param_defs(), gen, self.device)

    def _pair_view(self, pairs: Params, i: int) -> Params:
        """Pair ``i``'s float32 weights with the joined projections."""
        return self._join(layer_slice(pairs, i))

    def _join(self, p: Params, axis=None) -> Params:
        """A pair's float32 weights ``p`` with the joined projections; with a
        ``spmd.ModelAxis``, this rank's shards (its heads, or under
        ``"contraction"`` its rows of the input projections and columns of
        the output projections) and the output gate apart (``m_gate``, its
        columns)."""
        mp, sp = p["mlstm"], p["slstm"]
        d = self.cfg.d_model
        flat = lambda w: w.float().reshape(d, -1)
        m_in = ("wq", "wk", "wv", "wif") + (() if axis else ("wgate",))
        view = {
            "m_norm": mp["norm"],
            "m_in": torch.cat([flat(mp[w]) for w in m_in], dim=1),
            "m_out": mp["wout"].float().reshape(-1, d),
            "s_norm": sp["norm"],
            "s_in": torch.cat([flat(sp[w]) for w in ("wz", "wi", "wf", "wo")], dim=1),
            "s_rec": torch.cat([sp[r].float() for r in ("rz", "ri", "rf", "ro")], dim=-1),
            "s_out": sp["wout"].float().reshape(-1, d),
        }
        if axis is not None:
            view["m_gate"] = flat(mp["wgate"])
            if axis.mode == "contraction":
                rows, cols = axis.block(d), axis.block(d)
                view.update(m_in=view["m_in"][rows], s_in=view["s_in"][rows],
                            m_out=view["m_out"][:, cols], s_out=view["s_out"][:, cols],
                            m_norm={k: w[cols] for k, w in mp["norm"].items()},
                            s_norm={k: w[cols] for k, w in sp["norm"].items()})
        return view

    def _build_views(self, pairs: Params) -> List[Params]:
        return [self._pair_view(pairs, i) for i in range(self.n_pairs)]

    def _views(self, params: Params) -> List[Params]:
        """The pairs' views: built on every call where autograd records,
        else the serving cache; on DTensors each pair's own weights, which
        ``_on_shards`` joins on each rank."""
        if is_dtensor(params["norm_final"]["scale"]):
            return [layer_slice(params["pairs"], i) for i in range(self.n_pairs)]
        if records_grad(params):
            return self._build_views(params["pairs"])
        return self._cached(params["pairs"])

    def refresh_views(self, params: Params) -> None:
        """Bring the serving views up to date with ``params`` (after an
        in-place update): a captured decode step reads them without
        rebuilding them (``serving.graphs``)."""
        self._cached(params["pairs"])

    # ------------------------------------------------------------------ #
    # State                                                               #
    # ------------------------------------------------------------------ #
    def cache_shape(self, batch: int, max_len: int = 0):
        P, H, hd = self.n_pairs, self.cfg.n_heads, self.hd
        return {
            "m_C": (P, batch, H, hd, hd),
            "m_n": (P, batch, H, hd),
            "m_m": (P, batch, H),
            "s_c": (P, batch, H, hd),
            "s_n": (P, batch, H, hd),
            "s_h": (P, batch, H, hd),
            "s_m": (P, batch, H),
            "length": (batch,),
        }

    def cache_init(self, batch: int, max_len: int = 0) -> Dict[str, torch.Tensor]:
        return {
            k: torch.zeros(shape, dtype=torch.int32 if k == "length" else torch.float32,
                           device=self.device)
            for k, shape in self.cache_shape(batch, max_len).items()
        }

    def decode_attention_caches(self, batch: int, max_len: int) -> List[Tuple[int, ...]]:
        """The (L, B, S, KV, D) caches a decode step's attention kernel
        reads: none, the state is the cache."""
        return []

    def _states(self, cache: Dict[str, torch.Tensor]) -> List[State]:
        return [tuple(cache[k][p] for k in STATE_KEYS) for p in range(self.n_pairs)]

    def _store(self, cache: Dict[str, torch.Tensor], states: List[State]) -> None:
        for p, st in enumerate(states):
            for k, x in zip(STATE_KEYS, st):
                cache[k][p].copy_(x)

    # ------------------------------------------------------------------ #
    # One full-depth step for one token                                   #
    # ------------------------------------------------------------------ #
    def _token_step(self, views: List[Params], states: List[State],
                    x: torch.Tensor, axis=None) -> Tuple[List[State], torch.Tensor]:
        """x: (B, D) one token's hidden; returns (new states, y (B, D)).
        With a ``spmd.ModelAxis`` (``_on_shards``) the views and states are
        a rank's, and the projections run through the axis."""
        cfg, hd = self.cfg, self.hd
        b, H = x.shape[0], states[0][2].shape[1]     # the heads the states hold
        nq = H * hd
        # under a "contraction" axis the stream is this rank's columns
        cols = axis is not None and axis.mode == "contraction"
        h, out_states = (axis.columns(x) if cols else x), []

        def norm(h, p):
            if cols:
                return axis.rms_norm(h, p["scale"], cfg.norm_eps).float()
            return apply_norm(h, p, cfg.norm_kind, cfg.norm_eps).float()

        for v, (mC, mn, mm, sc, sn, sh, sm) in zip(views, states):
            # --- mLSTM block ------------------------------------------ #
            xn = norm(h, v["m_norm"])
            if axis is None:
                proj = xn @ v["m_in"]
            else:
                proj, gate = axis.project_in(xn, v["m_in"], v["m_gate"])
            q = proj[:, :nq].reshape(b, H, hd)
            k = proj[:, nq:2 * nq].reshape(b, H, hd) / (hd ** 0.5)
            val = proj[:, 2 * nq:3 * nq].reshape(b, H, hd)
            gates = proj[:, 3 * nq:3 * nq + 2 * H].reshape(b, H, 2)
            (mC, mn, mm), hm = mlstm_cell((mC, mn, mm), q, k, val, gates[..., 0], gates[..., 1])
            if axis is None:
                gate = F.silu(proj[:, 3 * nq + 2 * H:])
                out = (hm.reshape(b, nq) @ v["m_out"]) * gate
            else:
                gate = F.silu(gate) if cols else axis.gather(F.silu(gate))
                out = axis.project_out(hm.reshape(b, nq), v["m_out"]) * gate
            h = h + out.to(h.dtype)
            # --- sLSTM block ------------------------------------------ #
            xn = norm(h, v["s_norm"])
            rec = torch.einsum("bhk,hkj->bhj", sh, v["s_rec"])            # (B, H, 4 hd)
            pre = xn @ v["s_in"] if axis is None else axis.project_in(xn, v["s_in"])[0]
            gate_pre = [pre[:, j * nq:(j + 1) * nq].reshape(b, H, hd) + rec[..., j * hd:(j + 1) * hd]
                        for j in range(4)]
            (sc, sn, sh, sm), hs = slstm_cell((sc, sn, sh, sm), *gate_pre)
            if axis is None:
                out = hs.reshape(b, nq) @ v["s_out"]
            else:
                out = axis.project_out(hs.reshape(b, nq), v["s_out"])
            h = h + out.to(h.dtype)
            out_states.append((mC, mn, mm, sc, sn, sh, sm))
        return out_states, (axis.gather(h) if cols else h)

    #: the weights every rank holds whole but multiplies a slice of when the
    #: heads do not divide the TP axis (their gradients partial over it)
    SLICED = frozenset(("wq", "wk", "wv", "wif", "wz", "wi", "wf", "wo", "wout", "scale"))

    def _on_shards(self, fn, views, states, *batched):
        """``fn(views, states, *batched, axis)`` on each rank's shards of
        DTensors (``spmd.on_model_shards``), as GSPMD partitions the
        reference's steps: each rank its batch shard's heads where the heads
        divide the TP axis (its shards of every head-wise weight, the
        output gate by its columns, the output projections row-parallel);
        else every head on every rank, the input projections split over the
        contraction and the output projections and gate over their
        columns."""
        cfg = self.cfg
        tp = spmd.tp_size(batched[0])
        mode = None
        if tp > 1:
            mode = "heads" if cfg.n_heads % tp == 0 else "contraction" if cfg.d_model % tp == 0 else None

        def local(views, states, *rest):
            *batched, axis = rest
            return fn([self._join(p, axis) for p in views], states, *batched, axis)

        return spmd.on_model_shards(
            local, views, states, *batched, mode=mode,
            sliced=lambda path: mode == "contraction" and path[-1] in self.SLICED)

    def _chunk(self, views, states, x, axis=None):
        """The token step over x (B, T, D): (final states, y (B, T, D)). On
        DTensors each rank runs its shards (``_on_shards``)."""
        if is_dtensor(x):
            return self._on_shards(self._chunk, views, states, x)
        ys = []
        for t in range(x.shape[1]):
            states, y = self._token_step(views, states, x[:, t], axis)
            ys.append(y)
        return states, torch.stack(ys, dim=1)

    # ------------------------------------------------------------------ #
    # Public API (mirrors TransformerLM)                                  #
    # ------------------------------------------------------------------ #
    def forward(
        self, params: Params, tokens: torch.Tensor,
        patch_embeds: Optional[torch.Tensor] = None, remat: bool = True,
        time_chunk: int = 64,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Training forward → (logits (B, S, V) f32, aux loss 0 f32), every
        state from zero, over time chunks of ``time_chunk`` tokens (one
        chunk where S is not a multiple of it); with ``remat`` where
        autograd records, each chunk is checkpointed."""
        cfg = self.cfg
        b, s = tokens.shape
        views = self._views(params)
        emb = embed_tokens(tokens, params["embed"]).to(self.dtype)
        # every state from zero: on a mesh batch-sharded (the reference's
        # constrain_batch_dim of its zero state), like the embeddings
        states = self._states({
            k: batch_zeros(emb, shape, torch.int32 if k == "length" else torch.float32,
                           batch_dim=0 if k == "length" else 1)
            for k, shape in self.cache_shape(b).items()})
        chunk = min(time_chunk, s)
        if s % chunk != 0:
            chunk = s
        grad = records_grad(params)
        ys = []
        for c0 in range(0, s, chunk):
            x = emb[:, c0:c0 + chunk]
            if remat and grad:
                states, y = checkpoint(self._chunk, views, states, x, use_reentrant=False)
            else:
                states, y = self._chunk(views, states, x)
            ys.append(y)
        h = apply_norm(torch.cat(ys, dim=1), params["norm_final"], cfg.norm_kind, cfg.norm_eps)
        logits = unembed(h, params["embed"]).float()
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)

    def loss(self, params: Params, batch: Dict[str, torch.Tensor], remat: bool = True) -> torch.Tensor:
        logits, _ = self.forward(params, batch["tokens"], remat=remat)
        return cross_entropy_loss(logits, batch["labels"], batch.get("mask"))

    @torch.no_grad()
    def prefill(
        self, params: Params, tokens: torch.Tensor, cache: Dict[str, torch.Tensor],
        patch_embeds: Optional[torch.Tensor] = None,
        lengths: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Right-padded prompts (B, S) from the cache's states: each slot's
        state freezes once t >= lengths[b] (padding never touches it), the
        cache is updated in place and the logits are those of each slot's
        last real token."""
        cfg = self.cfg
        b, s = tokens.shape
        views = self._views(params)
        emb = embed_tokens(tokens, params["embed"]).to(self.dtype)
        len_vec = (torch.full((b,), s, dtype=torch.int32, device=tokens.device)
                   if lengths is None else lengths.to(torch.int32))
        states, h_last = self._prefill_loop(views, self._states(cache), emb, len_vec)
        self._store(cache, states)
        cache["length"].copy_(len_vec)
        h_last = apply_norm(h_last, params["norm_final"], cfg.norm_kind, cfg.norm_eps)
        return unembed(h_last, params["embed"]).float(), cache

    def _prefill_loop(self, views, states, emb, len_vec, axis=None):
        """The token step over the prompts ``emb`` (B, S, D), each slot's
        state frozen once t >= its length: (final states, the hidden of
        each slot's last real token). On DTensors each rank runs its batch
        shard."""
        if is_dtensor(emb):
            return self._on_shards(self._prefill_loop, views, states, emb, len_vec)
        b, s = emb.shape[:2]
        h_last = torch.zeros((b, self.cfg.d_model), dtype=self.dtype, device=emb.device)
        for t in range(s):
            new, y = self._token_step(views, states, emb[:, t], axis)
            live = t < len_vec                                         # (B,)
            states = [tuple(torch.where(live.view((b,) + (1,) * (x.dim() - 1)), x, old)
                            for x, old in zip(st_new, st_old))
                      for st_new, st_old in zip(new, states)]
            h_last = torch.where((t == len_vec - 1)[:, None], y, h_last)
        return states, h_last

    @torch.no_grad()
    def decode_step(
        self, params: Params, tokens: torch.Tensor, cache: Dict[str, torch.Tensor],
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One token per slot (B,) → (logits (B, V) f32, cache updated in
        place)."""
        cfg = self.cfg
        x = embed_tokens(tokens, params["embed"]).to(self.dtype)
        views, states = self._views(params), self._states(cache)
        if is_dtensor(x):
            states, h = self._on_shards(self._token_step, views, states, x)
        else:
            states, h = self._token_step(views, states, x)
        self._store(cache, states)
        cache["length"].add_(1)
        h = apply_norm(h, params["norm_final"], cfg.norm_kind, cfg.norm_eps)
        return unembed(h, params["embed"]).float(), cache
