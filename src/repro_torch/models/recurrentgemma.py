"""RecurrentGemma / Griffin (arXiv:2402.19427): RG-LRU + local attention,
serving and training paths (counterpart of ``repro.models.recurrentgemma``).

The layer pattern is (recurrent, recurrent, local attention) repeated, each
temporal block followed by a gated-MLP block, both residual; 38 layers are
12 full periods and a 2-recurrent tail. The RG-LRU recurrence per channel:

    r_t = σ(W_r x_t);  i_t = σ(W_i x_t)
    a_t = exp(-c · softplus(Λ) · r_t)          (c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

after a width-4 causal temporal conv whose last 3 inputs are carried in the
decode state. The decode state per slot is the recurrent state and conv
buffer of each recurrent layer and a ring cache of W = min(window, max_len)
per attention layer.

* Parameters keep the reference's tree: stacked ``rec_a`` / ``rec_b`` /
  ``attn`` of the periods, ``rec_tail``, ``embed``, ``norm_final``, with the
  float32 ``lam`` of each recurrent layer in a bf16 model. The reference's
  ``lax.scan`` over periods becomes a loop over per-period layer views.
* The kernels: the recurrence runs ``kernels.rglru.rglru_scan`` in every
  recurrent layer, over the prompt in a prefill (B, S, R) and over one token
  in a decode step (B, 1, R); prefill attention runs the dense entry of
  ``kernels.flash_attention`` (``attention_any``, causal, window 2048);
  decode attention runs ``kernels.decode_attention`` on the ring with a
  length mask. On CPU tensors those wrappers run their plain versions.
* Ragged prompts: the reference freezes a slot's state past its length with
  a ``where`` inside its scan; here the pad positions get a = 1 and x = 0
  before the scan, and 1·h + 0 is h exactly. The reference also masks pad
  keys with position -1; the causal mask already hides them from every real
  query, so the dense flash entry serves the prefill as it is (pad query
  rows differ and are never read).
* Caches are updated in place (the reference returns new ones); every
  method still returns the cache.
* What XLA hoists out of the reference's scan is hoisted by hand, once per
  parameter tree, for the serving paths: float32 norm scales, conv kernels
  and recurrence gates, and -c·softplus(Λ) (``layers.ViewCache``, which
  rewrites them in place after an optimizer step has updated the leaves in
  place). In a bf16 model the float32 gates cost 2 x R² x 4 bytes a
  recurrent layer (3.5 GB at full size) where the reference casts them on
  every call.
* Training: ``forward(params, tokens, patch_embeds, remat)`` / ``loss`` as
  in the reference (every state from zero, float32 logits and a zero aux
  loss). Where autograd records they build each layer's views inside the
  layer (no cache: every call has its own graph, and a rematerialised
  layer rebuilds them from the leaves), ``remat`` checkpoints each layer
  (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of each
  period), the recurrence runs ``RGLRUScanFn`` (the reverse-scan kernel
  ``csrc/rglru_bwd.cu`` in its backward) and attention ``FlashAttentionFn``
  (the flash backward at head_dim 256). Without autograd ``forward`` runs
  the serving path's layers. ``prefill`` and ``decode_step`` stay under
  ``no_grad`` with their in-place caches.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..configs.base import ArchConfig
from ..distributed import spmd
from ..distributed.sharding import (
    batch_zeros,
    constrain_batch_dim,
    constrain_rnn,
    gather_fsdp,
    is_dtensor,
)
from ..kernels.rglru import rglru_scan
from .attention import attention_any, decode_any
from .cache import (
    ring_cache_init,
    ring_cache_shape,
    ring_cache_write_prefill,
    ring_positions_prefill,
    ring_positions_write_token,
    ring_token_plan,
    write_token,
)
from .layers import (
    DTYPES,
    ParamDef,
    ViewCache,
    apply_norm,
    apply_rope_tables,
    cross_entropy_loss,
    embed_defs,
    embed_tokens,
    init_params,
    layer_slice,
    mlp_apply,
    mlp_defs,
    norm_defs,
    records_grad,
    rope_tables,
    tree_map,
    unembed,
)

Params = Dict[str, Any]
_C_RGLRU = 8.0


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + eˣ) as ``jax.nn.softplus`` computes it (``logaddexp(x, 0)``)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _norm_view(p: Params) -> Params:
    """A norm's leaves (``scale``, and ``bias`` for layernorm) in float32."""
    return {k: w.float() for k, w in p.items()}


class RecurrentGemma:
    """RecurrentGemma on ``device`` (default the CUDA device; raises if there
    is none — pass ``device="cpu"`` for the plain path)."""

    #: the stacked subtrees, one entry a layer (``train.train_step``)
    STACKS = ("rec_a", "rec_b", "attn", "rec_tail")

    def __init__(self, cfg: ArchConfig, device="cuda"):
        pattern = cfg.block_pattern or ("rec", "rec", "attn")
        if pattern != ("rec", "rec", "attn"):
            raise ValueError("RecurrentGemma expects the ('rec','rec','attn') pattern")
        if cfg.family != "hybrid":
            raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not RecurrentGemma's")
        # ``use_bias`` is accepted and ignored, as in the reference: no block
        # of this model has a bias.
        self.cfg = cfg
        self.n_periods = cfg.n_layers // 3                    # full (rec, rec, attn) groups
        self.n_tail_rec = cfg.n_layers - 3 * self.n_periods   # leftover rec layers
        self.n_rec = 2 * self.n_periods + self.n_tail_rec
        self.rnn = cfg.rnn_width or cfg.d_model
        self.hd = cfg.resolved_head_dim
        self.window = cfg.sliding_window or 2048
        self.dtype = DTYPES[cfg.dtype]
        self.device = resolve_device(device)
        self._views = ViewCache(self._build_views)

    # ------------------------------------------------------------------ #
    # Parameters                                                          #
    # ------------------------------------------------------------------ #
    def _rec_defs(self, n: int) -> Params:
        cfg, dt, r = self.cfg, self.dtype, self.rnn
        d = cfg.d_model
        return {
            "norm": norm_defs(d, cfg.norm_kind, dt, layers=n),
            "w_x": ParamDef((n, d, r), dt, axes=("layers", "embed", "rnn")),
            "w_gate": ParamDef((n, d, r), dt, axes=("layers", "embed", "rnn")),
            "conv_k": ParamDef((n, cfg.conv1d_width, r), dt, axes=("layers", None, "rnn")),
            "w_rgate": ParamDef((n, r, r), dt, axes=("layers", "rnn", None)),
            "w_igate": ParamDef((n, r, r), dt, axes=("layers", "rnn", None)),
            "lam": ParamDef((n, r), torch.float32, "normal", 0.5, axes=("layers", "rnn")),
            "w_out": ParamDef((n, r, d), dt, axes=("layers", "rnn", "embed")),
            "norm_mlp": norm_defs(d, cfg.norm_kind, dt, layers=n),
            "mlp": mlp_defs(d, cfg.d_ff, cfg.mlp_kind, dt, layers=n),
        }

    def _attn_defs(self, n: int) -> Params:
        cfg, dt, hd = self.cfg, self.dtype, self.hd
        d = cfg.d_model
        return {
            "norm": norm_defs(d, cfg.norm_kind, dt, layers=n),
            "wq": ParamDef((n, d, cfg.n_heads, hd), dt,
                           axes=("layers", "embed", "heads", "head_dim")),
            "wk": ParamDef((n, d, cfg.n_kv_heads, hd), dt,
                           axes=("layers", "embed", "kv_heads", "head_dim")),
            "wv": ParamDef((n, d, cfg.n_kv_heads, hd), dt,
                           axes=("layers", "embed", "kv_heads", "head_dim")),
            "wo": ParamDef((n, cfg.n_heads, hd, d), dt,
                           axes=("layers", "heads", "head_dim", "embed")),
            "norm_mlp": norm_defs(d, cfg.norm_kind, dt, layers=n),
            "mlp": mlp_defs(d, cfg.d_ff, cfg.mlp_kind, dt, layers=n),
        }

    def param_defs(self) -> Params:
        cfg = self.cfg
        defs = {
            "embed": embed_defs(cfg.vocab_size, cfg.d_model, self.dtype, tie=cfg.tie_embeddings),
            # the (rec, rec) of each period as two stacks, as in the reference
            "rec_a": self._rec_defs(self.n_periods),
            "rec_b": self._rec_defs(self.n_periods),
            "attn": self._attn_defs(self.n_periods),
            "norm_final": norm_defs(cfg.d_model, cfg.norm_kind, self.dtype),
        }
        if self.n_tail_rec:
            defs["rec_tail"] = self._rec_defs(self.n_tail_rec)
        return defs

    def init_params(self, seed: int = 0) -> Params:
        """Random parameters drawn on the model's device from a seeded
        ``torch.Generator``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return init_params(self.param_defs(), gen, self.device)

    def _rec_view(self, p: Params, i: int) -> Params:
        """Layer ``i`` of a recurrent stack (stacked, or a list of layers)
        with float32 norm scales, conv kernel, gates and -c·softplus(Λ)
        (on a mesh, its FSDP shards gathered)."""
        p = tree_map(gather_fsdp, layer_slice(p, i))
        f32 = lambda x: x.float()
        return {
            "norm": _norm_view(p["norm"]),
            "w_x": p["w_x"],
            "w_gate": p["w_gate"],
            "conv_k": f32(p["conv_k"]),                           # (c, R)
            "w_rgate": f32(p["w_rgate"]),
            "w_igate": f32(p["w_igate"]),
            "neg_c_lam": -_C_RGLRU * _softplus(f32(p["lam"])),   # (R,)
            "w_out": p["w_out"],
            "norm_mlp": _norm_view(p["norm_mlp"]),
            "mlp": dict(p["mlp"]),
        }

    def _attn_view(self, p: Params, i: int) -> Params:
        cfg, hd = self.cfg, self.hd
        d = cfg.d_model
        p = tree_map(gather_fsdp, layer_slice(p, i))
        return {
            "norm": _norm_view(p["norm"]),
            "wq": p["wq"].reshape(d, cfg.n_heads * hd),
            "wk": p["wk"].reshape(d, cfg.n_kv_heads * hd),
            "wv": p["wv"].reshape(d, cfg.n_kv_heads * hd),
            "wo": p["wo"].reshape(cfg.n_heads * hd, d),
            "norm_mlp": _norm_view(p["norm_mlp"]),
            "mlp": dict(p["mlp"]),
        }

    def _stacks(self, params: Params) -> Tuple[Params, ...]:
        return tuple(params[k] for k in self.STACKS if k in params)

    def _build_views(self, *stacks: Params) -> Dict[str, List[Params]]:
        n = {"rec_a": self.n_periods, "rec_b": self.n_periods, "attn": self.n_periods,
             "rec_tail": self.n_tail_rec}
        view = {"rec_a": self._rec_view, "rec_b": self._rec_view, "attn": self._attn_view,
                "rec_tail": self._rec_view}
        return {k: [view[k](p, i) for i in range(n[k])] for k, p in zip(self.STACKS, stacks)}

    def _layer_views(self, params: Params) -> Dict[str, List[Params]]:
        """The serving paths' per-layer views of the stacked weights:
        ``rec_a`` / ``rec_b`` / ``attn`` per period and ``rec_tail``, cached
        for the last parameter tree and refreshed in place after an in-place
        update (``ViewCache``). Recurrent states are ordered A's, B's,
        tail."""
        views = self._views(*self._stacks(params))
        return {k: views.get(k, []) for k in self.STACKS}

    def refresh_views(self, params: Params) -> None:
        """Bring the serving views up to date with ``params`` (after an
        in-place update): a captured decode step reads them without
        rebuilding them (``serving.graphs``)."""
        self._views(*self._stacks(params))

    # ------------------------------------------------------------------ #
    # State                                                               #
    # ------------------------------------------------------------------ #
    def _ring_len(self, max_len: int) -> int:
        return min(self.window, max_len) if max_len else self.window

    def cache_shape(self, batch: int, max_len: int):
        cfg = self.cfg
        return {
            "rnn_h": (self.n_rec, batch, self.rnn),
            "conv_buf": (self.n_rec, batch, cfg.conv1d_width - 1, self.rnn),
            "attn": ring_cache_shape(self.n_periods, batch, self._ring_len(max_len),
                                     cfg.n_kv_heads, self.hd),
            "length": (batch,),
        }

    def decode_attention_caches(self, batch: int, max_len: int) -> List[Tuple[int, ...]]:
        """The (L, B, S, KV, D) caches a decode step's attention kernel
        reads: the rings."""
        return [self.cache_shape(batch, max_len)["attn"]["k"]]

    def cache_init(self, batch: int, max_len: int) -> Dict[str, Any]:
        cfg, dev = self.cfg, self.device
        shape = self.cache_shape(batch, max_len)
        return {
            "rnn_h": torch.zeros(shape["rnn_h"], dtype=torch.float32, device=dev),
            "conv_buf": torch.zeros(shape["conv_buf"], dtype=torch.float32, device=dev),
            "attn": ring_cache_init(self.n_periods, batch, self._ring_len(max_len),
                                    cfg.n_kv_heads, self.hd, self.dtype, dev),
            "length": torch.zeros(shape["length"], dtype=torch.int32, device=dev),
        }

    # ------------------------------------------------------------------ #
    # Blocks                                                              #
    # ------------------------------------------------------------------ #
    def _rec_block_seq(
        self, h: torch.Tensor, lp: Params, h0: torch.Tensor, conv_buf0: torch.Tensor,
        len_vec: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """h: (B, S, D); h0: (B, R) initial recurrent state; conv_buf0
        (B, c-1, R). Returns (block output (B, S, D), final state, final conv
        buffer). ``len_vec`` (B,) freezes each slot's state past its length
        and takes the conv buffer from its last real inputs."""
        cfg = self.cfg
        b, s, _ = h.shape
        x = apply_norm(h, lp["norm"], cfg.norm_kind, cfg.norm_eps)
        u = (x @ lp["w_x"]).float()                                     # (B, S, R)
        gate = F.gelu((x @ lp["w_gate"]).float(), approximate="tanh")
        # causal temporal conv (width c): pad with the carried buffer
        cw = cfg.conv1d_width
        u_pad = torch.cat([conv_buf0.float(), u], dim=1)                # (B, S+c-1, R)
        kern = lp["conv_k"]
        conv = sum(u_pad[:, i : i + s] * kern[i] for i in range(cw))     # (B, S, R)
        # on a mesh: batch over the DP axes, the RG-LRU width over TP, and so
        # its gradient (the conv's shifted slices would leave it sequence-sharded)
        conv = constrain_rnn(conv)
        r_g = torch.sigmoid(constrain_rnn(conv @ lp["w_rgate"]))
        i_g = torch.sigmoid(constrain_rnn(conv @ lp["w_igate"]))
        a = torch.exp(lp["neg_c_lam"] * r_g)
        gated_x = torch.sqrt(torch.clamp(1.0 - torch.square(a), min=1e-9)) * (i_g * conv)
        if len_vec is not None:
            live = (torch.arange(s, device=h.device)[None, :] < len_vec[:, None])[..., None]
            a = torch.where(live, a, 1.0)
            gated_x = torch.where(live, gated_x, 0.0)
        rec, h_fin = rglru_scan(a, gated_x, h0)                         # (B, S, R), (B, R)
        out = constrain_batch_dim((rec * gate).to(self.dtype) @ lp["w_out"], 0)
        if len_vec is None:
            new_buf = u_pad[:, s:]
        else:
            # u_pad[p + c - 1] is u[p]: each slot's last c-1 real inputs sit
            # at len_b + i for i in [0, c-1)
            idx = len_vec.long()[:, None] + torch.arange(cw - 1, device=h.device)[None, :]
            new_buf = u_pad[torch.arange(b, device=h.device)[:, None], idx]
        return constrain_batch_dim(h + out, 0), h_fin, new_buf

    def _rec_block_tok(
        self, h: torch.Tensor, lp: Params, h0: torch.Tensor, conv_buf: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """h: (B, D) one token. Returns (out, new state, new conv buffer):
        the sequence block on S = 1, so one recurrence serves both."""
        out, h_new, buf = self._rec_block_seq(h[:, None], lp, h0, conv_buf)
        return out[:, 0], h_new, buf

    def _qkv(self, x: torch.Tensor, lp: Params, rope, own_kv: bool = False):
        """q/k/v with RoPE; on a mesh whose TP axis the KV heads do not
        divide, ``own_kv`` (the training forward) has each rank compute its
        own query heads' KV heads (``spmd.gqa_kv``), as GSPMD partitions
        the reference's."""
        cfg = self.cfg
        b, s, _ = x.shape
        q = (x @ lp["wq"]).view(b, s, cfg.n_heads, self.hd)
        if own_kv and is_dtensor(x) and spmd.gqa_split(
                cfg.n_heads, cfg.n_kv_heads,
                dict(zip(x.device_mesh.mesh_dim_names, tuple(x.device_mesh.shape))).get("model", 1)):
            k = spmd.gqa_kv(x, lp["wk"], None, cfg.n_kv_heads, cfg.n_heads, self.hd)
            v = spmd.gqa_kv(x, lp["wv"], None, cfg.n_kv_heads, cfg.n_heads, self.hd)
        else:
            k = (x @ lp["wk"]).view(b, s, cfg.n_kv_heads, self.hd)
            v = (x @ lp["wv"]).view(b, s, cfg.n_kv_heads, self.hd)
        return apply_rope_tables(q, *rope), apply_rope_tables(k, *rope), v

    def _attn_block_seq(self, h: torch.Tensor, lp: Params, rope, own_kv: bool = False):
        cfg = self.cfg
        b, s, _ = h.shape
        x = apply_norm(h, lp["norm"], cfg.norm_kind, cfg.norm_eps)
        q, k, v = self._qkv(x, lp, rope, own_kv)
        out = attention_any(q, k, v, causal=True, window=self.window)
        return constrain_batch_dim(h + constrain_batch_dim(out.reshape(b, s, -1) @ lp["wo"], 0), 0), (k, v)

    def _mlp_block(self, h: torch.Tensor, lp: Params) -> torch.Tensor:
        cfg = self.cfg
        x = apply_norm(h, lp["norm_mlp"], cfg.norm_kind, cfg.norm_eps)
        # on a mesh the residual stream (and its gradient) stays batch-sharded
        # and replicated over the TP axis
        return constrain_batch_dim(h + constrain_batch_dim(mlp_apply(x, lp["mlp"], cfg.mlp_kind), 0), 0)

    def _rec_layer(self, h, lp, cache, i, len_vec=None):
        """A recurrent block and its MLP; the layer's state ``i`` is read
        from ``cache`` (zeros without one) and, with one, updated in place."""
        if cache is None:
            b = h.shape[0]
            h0 = batch_zeros(h, (b, self.rnn), torch.float32)
            buf0 = batch_zeros(h, (b, self.cfg.conv1d_width - 1, self.rnn), torch.float32)
        else:
            h0, buf0 = cache["rnn_h"][i], cache["conv_buf"][i]
        h, h_fin, buf = self._rec_block_seq(h, lp, h0, buf0, len_vec)
        if cache is not None:
            cache["rnn_h"][i].copy_(h_fin)
            cache["conv_buf"][i].copy_(buf)
        return self._mlp_block(h, lp)

    # ------------------------------------------------------------------ #
    # Full-sequence forward (prefill and forward share this)              #
    # ------------------------------------------------------------------ #
    def _forward_seq(self, params: Params, tokens: torch.Tensor, cache=None,
                     lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Final-normed hidden states (B, S, D). With a cache, the recurrent
        states, conv buffers and ring caches are read and written in place
        (a prefill); without one, every state starts at zero."""
        cfg = self.cfg
        b, s = tokens.shape
        dev = tokens.device
        h = embed_tokens(tokens, params["embed"]).to(self.dtype)
        positions = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
        rope = rope_tables(positions, self.hd, cfg.rope_theta)
        len_vec = None if lengths is None else lengths.to(torch.int32)
        if cache is not None:
            ring = cache["attn"]
            new_len = torch.full((b,), s, dtype=torch.int32, device=dev) if len_vec is None else len_vec
            pos_map = ring_positions_prefill(b, ring["k"].shape[2], new_len)
        views = self._layer_views(params)

        def rec(h, stack, i, state):
            return self._rec_layer(h, views[stack][i], cache, state, len_vec)

        def attn(h, p):
            at = views["attn"][p]
            h, (k, v) = self._attn_block_seq(h, at, rope)
            if cache is not None:
                ring_cache_write_prefill(ring["k"][p], ring["v"][p], k, v, pos_map)
            return self._mlp_block(h, at)

        h = self._run_layers(h, rec, attn, lambda fn, *a: fn(*a))
        if cache is not None:
            ring["pos"].copy_(pos_map)
            ring["length"].copy_(new_len)
            cache["length"].copy_(new_len)
        return apply_norm(h, params["norm_final"], cfg.norm_kind, cfg.norm_eps)

    def _run_layers(self, h: torch.Tensor, rec, attn, run) -> torch.Tensor:
        """Every layer in order, each period's recurrent A and B blocks and
        its attention block, then the recurrent tail: ``h = run(rec, h,
        stack, i, state)`` for layer ``i`` of the recurrent stack ``stack``
        whose state is ``state`` (A's, B's, tail), ``h = run(attn, h, p)``
        for period ``p``'s attention block."""
        pa = self.n_periods
        for p in range(pa):
            h = run(rec, h, "rec_a", p, p)
            h = run(rec, h, "rec_b", p, pa + p)
            h = run(attn, h, p)
        for t in range(self.n_tail_rec):
            h = run(rec, h, "rec_tail", t, 2 * pa + t)
        return h

    def _train_seq(self, params: Params, tokens: torch.Tensor, remat: bool) -> torch.Tensor:
        """Final-normed hidden states of the training forward: the serving
        path's layers in order, every state from zero, each layer's views
        built inside it (a rematerialised layer rebuilds them from the
        leaves) and each layer checkpointed under ``remat``."""
        cfg = self.cfg
        b, s = tokens.shape
        h = embed_tokens(tokens, params["embed"]).to(self.dtype)
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[None].expand(b, s)
        rope = rope_tables(positions, self.hd, cfg.rope_theta)

        def rec(h, stack, i, state):
            return self._rec_layer(h, self._rec_view(params[stack], i), None, 0)

        def attn(h, p):
            at = self._attn_view(params["attn"], p)
            h, _ = self._attn_block_seq(h, at, rope, own_kv=True)
            return self._mlp_block(h, at)

        run = ((lambda fn, *a: checkpoint(fn, *a, use_reentrant=False)) if remat
               else (lambda fn, *a: fn(*a)))
        h = self._run_layers(h, rec, attn, run)
        return apply_norm(h, params["norm_final"], cfg.norm_kind, cfg.norm_eps)

    def forward(
        self,
        params: Params,
        tokens: torch.Tensor,                         # (B, S) int32
        patch_embeds: Optional[torch.Tensor] = None,  # unused: the uniform interface
        remat: bool = True,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full forward → (logits (B, S, V) f32, aux loss 0 f32), every state
        from zero. Where autograd records it is the training forward
        (``_train_seq``); otherwise the serving path's layers."""
        if records_grad(params):
            h = self._train_seq(params, tokens, remat)
        else:
            h = self._forward_seq(params, tokens)
        logits = unembed(h, params["embed"]).float()
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)

    def loss(self, params: Params, batch: Dict[str, torch.Tensor], remat: bool = True) -> torch.Tensor:
        """Cross-entropy of ``batch["labels"]`` (masked by ``batch["mask"]``
        where given)."""
        logits, _ = self.forward(params, batch["tokens"], remat=remat)
        return cross_entropy_loss(logits, batch["labels"], batch.get("mask"))

    @torch.no_grad()
    def prefill(
        self,
        params: Params,
        tokens: torch.Tensor,                # (B, S) int32, right-padded
        cache: Dict[str, Any],               # cache of B slots, updated in place
        lengths: Optional[torch.Tensor] = None,   # (B,) true prompt lengths
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Process the right-padded prompts from the cache's states, fill the
        cache and return the logits at each prompt's last real token.
        ``lengths`` defaults to the full padded width."""
        b = tokens.shape[0]
        h = self._forward_seq(params, tokens, cache, lengths)
        if lengths is None:
            h_last = h[:, -1]
        else:
            h_last = h[torch.arange(b, device=h.device), (lengths.long() - 1).clamp(min=0)]
        return unembed(h_last, params["embed"]).float(), cache

    # ------------------------------------------------------------------ #
    # Decode                                                              #
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def decode_step(
        self,
        params: Params,
        tokens: torch.Tensor,                # (B,) int32 — one new token per slot
        cache: Dict[str, Any],               # updated in place
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Append one token to every slot; returns (logits (B, V) f32, cache).
        The ring fills slot p mod W in order, so its valid entries are the
        prefix [0, min(len + 1, W)), every one inside the new query's window
        (W <= window): kernel 3's length mask is the reference's position
        mask over ``pos``."""
        cfg = self.cfg
        b = tokens.shape[0]
        lengths = cache["length"]
        ring = cache["attn"]
        w = ring["k"].shape[2]
        h = embed_tokens(tokens, params["embed"]).to(self.dtype)          # (B, D)
        rope = rope_tables(lengths[:, None], self.hd, cfg.rope_theta)
        plan = ring_token_plan(lengths, w)
        new_pos = ring_positions_write_token(ring["pos"], lengths)
        kv_lens = torch.clamp(lengths + 1, max=w)
        views = self._layer_views(params)

        def rec(h, stack, i, state):
            return self._rec_layer(h[:, None], views[stack][i], cache, state)[:, 0]

        def attn(h, p):
            at = views["attn"][p]
            x = apply_norm(h, at["norm"], cfg.norm_kind, cfg.norm_eps)[:, None]
            q, k, v = self._qkv(x, at, rope)
            kc, vc = ring["k"][p], ring["v"][p]
            write_token(kc, vc, k, v, plan)
            out = decode_any(q[:, 0], kc, vc, kv_lens)
            return self._mlp_block(h + constrain_batch_dim(out.reshape(b, -1) @ at["wo"], 0), at)

        h = self._run_layers(h, rec, attn, lambda fn, *a: fn(*a))
        h = apply_norm(h, params["norm_final"], cfg.norm_kind, cfg.norm_eps)
        logits = unembed(h, params["embed"]).float()
        ring["pos"].copy_(new_pos)
        ring["length"].add_(1)
        lengths.add_(1)
        return logits, cache
