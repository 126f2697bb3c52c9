"""Whisper (arXiv:2212.04356): encoder-decoder backbone with the audio
front end stubbed, serving and training paths (counterpart of
``repro.models.whisper``).

Inputs are frame embeddings (B, S_enc, d_model), as in the reference. The
encoder is bidirectional self-attention and a GELU MLP; the decoder causal
self-attention, cross-attention over the encoder states and a GELU MLP;
layernorm with bias everywhere; q, v and output projections with biases
and k without; tied embeddings; sinusoidal positions on both stacks (the
reference's adaptation), evaluated in closed form at each slot's position
in a decode step.

* Parameters keep the reference's tree: stacked ``encoder`` and
  ``decoder`` layers, ``embed``, ``norm_enc_final``, ``norm_dec_final``;
  its ``lax.scan`` over layers is a loop over layer slices
  (``layers.layer_slice``, which also takes the list of per-layer trees
  that ``train.train_step`` differentiates).
* Attention runs the hand-written kernels: the encoder's self-attention,
  the decoder's prefill self-attention and every cross-attention over the
  encoder states (Sq != Sk) run kernel 2's dense entry
  (``attention_any`` / ``attention_cross``), and under autograd its
  backward kernel (``FlashAttentionFn``); a decode step's self-attention
  over the slot's cache row and its cross-attention of one token over the
  ``enc_len`` encoder keys run kernel 3 (``decode_attention``). CPU tensors
  take the wrappers' plain versions.
* ``forward(batch_or_tokens, patch_embeds, remat)`` / ``loss`` as in the
  reference (a dict with ``frames`` and ``tokens``, or tokens with the
  frames as ``patch_embeds``); ``remat`` checkpoints each layer.
* Serving: ``prefill`` (equal-length prompts, as the reference's takes no
  lengths: the encoder pass, the cross K/V of every layer and the prompt's
  self K/V into the cache) and ``decode_step`` run under ``no_grad`` and
  update the cache in place, returning it as the reference returns a new
  one.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..configs.base import ArchConfig
from ..distributed.sharding import constrain_batch_dim, gather_fsdp
from .attention import attention_any, attention_cross, decode_any
from .cache import full_cache_init, full_cache_shape, full_cache_write, full_token_plan, write_token
from .layers import (
    DTYPES,
    ParamDef,
    apply_norm,
    cross_entropy_loss,
    embed_defs,
    embed_tokens,
    init_params,
    layer_slice,
    mlp_apply,
    mlp_defs,
    norm_defs,
    sinusoid_at,
    sinusoidal_positions,
    tree_map,
    unembed,
)

Params = Dict[str, Any]


class Whisper:
    """Whisper on ``device`` (default the CUDA device; raises if there is
    none — pass ``device="cpu"`` for the plain path)."""

    #: the stacked subtrees, one entry a layer (``train.train_step``)
    STACKS = ("encoder", "decoder")

    def __init__(self, cfg: ArchConfig, device="cuda"):
        if not cfg.is_encoder_decoder or cfg.encoder_layers <= 0:
            raise ValueError("Whisper requires is_encoder_decoder and encoder_layers")
        self.cfg = cfg
        self.hd = cfg.resolved_head_dim
        self.dtype = DTYPES[cfg.dtype]
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ #
    # Parameters                                                          #
    # ------------------------------------------------------------------ #
    def _attn_defs(self, n: int, kv_heads: int) -> Params:
        cfg, dt, hd = self.cfg, self.dtype, self.hd
        d = cfg.d_model
        return {
            "wq": ParamDef((n, d, cfg.n_heads, hd), dt,
                           axes=("layers", "embed", "heads", "head_dim")),
            "wk": ParamDef((n, d, kv_heads, hd), dt,
                           axes=("layers", "embed", "kv_heads", "head_dim")),
            "wv": ParamDef((n, d, kv_heads, hd), dt,
                           axes=("layers", "embed", "kv_heads", "head_dim")),
            "wo": ParamDef((n, cfg.n_heads, hd, d), dt,
                           axes=("layers", "heads", "head_dim", "embed")),
            "bq": ParamDef((n, cfg.n_heads, hd), dt, "zeros", axes=("layers", "heads", "head_dim")),
            "bv": ParamDef((n, kv_heads, hd), dt, "zeros", axes=("layers", "kv_heads", "head_dim")),
            "bo": ParamDef((n, d), dt, "zeros", axes=("layers", "embed")),
        }

    def param_defs(self) -> Params:
        cfg, dt = self.cfg, self.dtype
        d, ne, nd = cfg.d_model, cfg.encoder_layers, cfg.n_layers
        enc = {
            "norm_attn": norm_defs(d, "layernorm", dt, layers=ne),
            "attn": self._attn_defs(ne, cfg.n_kv_heads),
            "norm_mlp": norm_defs(d, "layernorm", dt, layers=ne),
            "mlp": mlp_defs(d, cfg.d_ff, "gelu", dt, layers=ne, use_bias=True),
        }
        dec = {
            "norm_self": norm_defs(d, "layernorm", dt, layers=nd),
            "self_attn": self._attn_defs(nd, cfg.n_kv_heads),
            "norm_cross": norm_defs(d, "layernorm", dt, layers=nd),
            "cross_attn": self._attn_defs(nd, cfg.n_kv_heads),
            "norm_mlp": norm_defs(d, "layernorm", dt, layers=nd),
            "mlp": mlp_defs(d, cfg.d_ff, "gelu", dt, layers=nd, use_bias=True),
        }
        return {
            "embed": embed_defs(cfg.vocab_size, d, dt, tie=True),
            "encoder": enc,
            "decoder": dec,
            "norm_enc_final": norm_defs(d, "layernorm", dt),
            "norm_dec_final": norm_defs(d, "layernorm", dt),
        }

    def init_params(self, seed: int = 0) -> Params:
        """Random parameters drawn on the model's device from a seeded
        ``torch.Generator``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return init_params(self.param_defs(), gen, self.device)

    # ------------------------------------------------------------------ #
    # Blocks                                                              #
    # ------------------------------------------------------------------ #
    def _q(self, x: torch.Tensor, lp: Params) -> torch.Tensor:
        b, s, _ = x.shape
        w = lp["wq"].reshape(self.cfg.d_model, -1)
        return (x @ w).view(b, s, self.cfg.n_heads, self.hd) + lp["bq"]

    def _kv(self, x: torch.Tensor, lp: Params) -> Tuple[torch.Tensor, torch.Tensor]:
        b, s, _ = x.shape
        kv, d = self.cfg.n_kv_heads, self.cfg.d_model
        k = (x @ lp["wk"].reshape(d, -1)).view(b, s, kv, self.hd)
        v = (x @ lp["wv"].reshape(d, -1)).view(b, s, kv, self.hd) + lp["bv"]
        return k, v

    def _out(self, attn: torch.Tensor, lp: Params) -> torch.Tensor:
        b, s = attn.shape[:2]
        # on a mesh the residual stream stays batch-sharded, replicated over TP
        return constrain_batch_dim(
            attn.reshape(b, s, -1) @ lp["wo"].reshape(-1, self.cfg.d_model) + lp["bo"], 0)

    def _norm(self, h: torch.Tensor, p: Params) -> torch.Tensor:
        return apply_norm(h, p, "layernorm", self.cfg.norm_eps)

    def _mlp(self, h: torch.Tensor, lp: Params) -> torch.Tensor:
        out = mlp_apply(self._norm(h, lp["norm_mlp"]), lp["mlp"], "gelu")
        return constrain_batch_dim(h + constrain_batch_dim(out, 0), 0)

    def _enc_layer(self, h: torch.Tensor, stack: Params, i: int) -> torch.Tensor:
        lp = tree_map(gather_fsdp, layer_slice(stack, i))
        x = self._norm(h, lp["norm_attn"])
        k, v = self._kv(x, lp["attn"])
        h = constrain_batch_dim(h + self._out(attention_cross(self._q(x, lp["attn"]), k, v), lp["attn"]), 0)
        return self._mlp(h, lp)

    def _dec_layer(self, h: torch.Tensor, enc: torch.Tensor, stack: Params, i: int,
                   kv_out: Optional[List] = None) -> torch.Tensor:
        """Decoder layer ``i`` over the whole prompt; ``kv_out`` collects
        its self K/V and cross K/V (a prefill)."""
        lp = tree_map(gather_fsdp, layer_slice(stack, i))
        sa, ca = lp["self_attn"], lp["cross_attn"]
        x = self._norm(h, lp["norm_self"])
        k, v = self._kv(x, sa)
        h = constrain_batch_dim(h + self._out(attention_any(self._q(x, sa), k, v, causal=True), sa), 0)
        x = self._norm(h, lp["norm_cross"])
        ck, cv = self._kv(enc, ca)
        h = constrain_batch_dim(h + self._out(attention_cross(self._q(x, ca), ck, cv), ca), 0)
        if kv_out is not None:
            kv_out.append((k, v, ck, cv))
        return self._mlp(h, lp)

    @staticmethod
    def _run(remat: bool):
        if remat and torch.is_grad_enabled():
            return lambda fn, *a: checkpoint(fn, *a, use_reentrant=False)
        return lambda fn, *a: fn(*a)

    # ------------------------------------------------------------------ #
    # Encoder and decoder over whole sequences                            #
    # ------------------------------------------------------------------ #
    def encode(self, params: Params, frames: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """frames (B, S_enc, D) → encoder states (B, S_enc, D)."""
        b, s, d = frames.shape
        pos = sinusoidal_positions(s, d, frames.device).to(self.dtype)
        h = frames.to(self.dtype) + pos[None]
        run = self._run(remat)
        for i in range(self.cfg.encoder_layers):
            h = run(self._enc_layer, h, params["encoder"], i)
        return self._norm(h, params["norm_enc_final"])

    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        s, d = tokens.shape[1], self.cfg.d_model
        h = embed_tokens(tokens, params["embed"]).to(self.dtype)
        return h + sinusoidal_positions(s, d, tokens.device).to(self.dtype)[None]

    def _decoder_full(self, params: Params, tokens: torch.Tensor, enc: torch.Tensor,
                      remat: bool) -> torch.Tensor:
        h = self._embed(params, tokens)
        run = self._run(remat)
        for i in range(self.cfg.n_layers):
            h = run(self._dec_layer, h, enc, params["decoder"], i)
        return self._norm(h, params["norm_dec_final"])

    def forward(self, params: Params, batch_or_tokens, patch_embeds: Optional[torch.Tensor] = None,
                remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """Training forward → (logits (B, S, V) f32, aux loss 0 f32). Takes
        a ``{"frames", "tokens"}`` dict, or tokens with ``patch_embeds`` as
        the frames."""
        if isinstance(batch_or_tokens, dict):
            frames, tokens = batch_or_tokens["frames"], batch_or_tokens["tokens"]
        else:
            tokens, frames = batch_or_tokens, patch_embeds
        enc = self.encode(params, frames, remat=remat)
        h = self._decoder_full(params, tokens, enc, remat)
        logits = unembed(h, params["embed"]).float()
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)

    def loss(self, params: Params, batch: Dict[str, torch.Tensor], remat: bool = True) -> torch.Tensor:
        logits, _ = self.forward(params, batch, remat=remat)
        return cross_entropy_loss(logits, batch["labels"], batch.get("mask"))

    # ------------------------------------------------------------------ #
    # Serving                                                             #
    # ------------------------------------------------------------------ #
    def cache_shape(self, batch: int, max_len: int, enc_len: int = 1500):
        cfg = self.cfg
        cross = (cfg.n_layers, batch, enc_len, cfg.n_kv_heads, self.hd)
        return {
            "self": full_cache_shape(cfg.n_layers, batch, max_len, cfg.n_kv_heads, self.hd),
            "cross_k": cross,
            "cross_v": cross,
        }

    def cache_init(self, batch: int, max_len: int, enc_len: int = 1500) -> Dict[str, Any]:
        shape = self.cache_shape(batch, max_len, enc_len)
        zeros = lambda s: torch.zeros(s, dtype=self.dtype, device=self.device)
        return {
            "self": full_cache_init(self.cfg.n_layers, batch, max_len, self.cfg.n_kv_heads,
                                    self.hd, self.dtype, self.device),
            "cross_k": zeros(shape["cross_k"]),
            "cross_v": zeros(shape["cross_v"]),
        }

    def refresh_views(self, params: Params) -> None:
        """Whisper keeps no serving views: its layers read the leaves on
        every call, a captured decode step included."""

    def decode_attention_caches(self, batch: int, max_len: int,
                                enc_len: int = 1500) -> List[Tuple[int, ...]]:
        """The (L, B, S, KV, D) caches a decode step's attention kernel
        reads: the self cache and the cross cache."""
        shape = self.cache_shape(batch, max_len, enc_len)
        return [shape["self"]["k"], shape["cross_k"]]

    @torch.no_grad()
    def prefill(self, params: Params, tokens: torch.Tensor, cache: Dict[str, Any],
                patch_embeds: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Encoder pass and decoder prompt prefill of equal-length prompts
        (B, S); ``patch_embeds`` carries the frames (B, S_enc, D). Fills the
        self cache's first S rows and the cross cache in place and returns
        the logits of the last token."""
        if patch_embeds is None:
            raise ValueError("whisper prefill needs frame embeddings")
        b, s = tokens.shape
        enc = self.encode(params, patch_embeds)
        h = self._embed(params, tokens)
        kvs: List = []
        for i in range(self.cfg.n_layers):
            h = self._dec_layer(h, enc, params["decoder"], i, kvs)
        sc = cache["self"]
        for i, (k, v, ck, cv) in enumerate(kvs):
            full_cache_write(sc["k"][i], sc["v"][i], k, v, 0)
            cache["cross_k"][i].copy_(ck)
            cache["cross_v"][i].copy_(cv)
        sc["length"].fill_(s)
        h = self._norm(h, params["norm_dec_final"])
        return unembed(h[:, -1], params["embed"]).float(), cache

    @torch.no_grad()
    def decode_step(self, params: Params, tokens: torch.Tensor,
                    cache: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One token per slot (B,) at each slot's ``length`` → (logits
        (B, V) f32, cache updated in place)."""
        cfg = self.cfg
        sc = cache["self"]
        lengths = sc["length"]
        b = tokens.shape[0]
        h = embed_tokens(tokens, params["embed"]).to(self.dtype)
        h = (h + sinusoid_at(lengths.float()[:, None], cfg.d_model).to(self.dtype))[:, None]
        plan = full_token_plan(lengths, sc["k"].shape[2])
        kv_lens = lengths + 1
        enc_lens = torch.full((b,), cache["cross_k"].shape[2], dtype=torch.int32, device=h.device)
        for i in range(cfg.n_layers):
            lp = tree_map(gather_fsdp, layer_slice(params["decoder"], i))
            sa, ca = lp["self_attn"], lp["cross_attn"]
            x = self._norm(h, lp["norm_self"])
            k, v = self._kv(x, sa)
            kc, vc = sc["k"][i], sc["v"][i]
            write_token(kc, vc, k, v, plan)
            attn = decode_any(self._q(x, sa)[:, 0], kc, vc, kv_lens)
            h = h + self._out(attn[:, None], sa)
            x = self._norm(h, lp["norm_cross"])
            attn = decode_any(self._q(x, ca)[:, 0], cache["cross_k"][i], cache["cross_v"][i],
                              enc_lens)
            h = self._mlp(h + self._out(attn[:, None], ca), lp)
        h = self._norm(h[:, 0], params["norm_dec_final"])
        lengths.add_(1)
        return unembed(h, params["embed"]).float(), cache
