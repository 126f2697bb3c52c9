"""Decoder-only transformer LM, serving and training paths (counterpart of
``repro.models.transformer``, which serves and trains the dense, MoE and VLM
families).

* Parameters keep the reference's tree and stacked ``(L, ...)`` layout; the
  reference's ``lax.scan`` over layers becomes a loop over layer slices.
* The block options follow the config as in the reference: RMSNorm or
  layernorm (with its bias), q/k/v and output biases, SwiGLU, squared-ReLU
  or GELU MLPs (with biases), a top-k MoE in place of the MLP
  (``models.moe``), qk-norm, sliding windows (dense ring cache only) and
  M-RoPE, whose serving positions are the 1-D positions broadcast to three
  streams (text only; ``prefill`` merges ``patch_embeds`` into the prefix).
* Two KV layouts, as in the reference: the dense slot cache (full rows, or
  rings of W for sliding-window configs; ``cache_init`` / ``prefill`` /
  ``decode_step``) and the paged pool (``paged_cache_init`` /
  ``prefill_chunk`` / ``mixed_step`` / ``decode_step``). ``decode_step``
  and ``decode_steps`` take either; a ``block_tables`` key selects the pool.
* Caches are updated in place (the reference donates them to its jitted
  steps and gets new ones back); every method still returns the cache so
  call sites read like the reference's.
* Attention runs through the hand-written kernels: dense decode through
  ``kernels.decode_attention``, dense prefill through the dense entry of
  ``kernels.flash_attention``, the decode lanes of the paged ``mixed_step`` /
  ``decode_steps`` through ``kernels.paged_decode_attention`` and the
  prefill-chunk rows of ``prefill_chunk`` / ``mixed_step`` through the paged
  entry of ``kernels.flash_attention``. On CPU tensors those wrappers run
  their plain PyTorch versions.
* Nothing inside ``decode_steps`` reads device values on the host: its K
  iterations queue without a host sync, so a fused horizon is one sync (the
  caller's copy of the token block).
* What XLA hoists out of the reference's layer scan is hoisted here by hand:
  each step computes its RoPE tables and its KV write plan once, and the
  per-layer weights (with float32 norm scales) are sliced once per
  parameter tree (``layers.ViewCache``: the float32 copies are refreshed
  in place when an optimizer step has updated the leaves, by the next
  eager call or, before a captured dispatch replays, by
  ``refresh_views``).
* Training: ``forward`` / ``loss`` as in the reference (full causal forward,
  float32 logits, the MoE aux loss summed over layers). They carry no
  ``no_grad`` and build each layer's views on every call (no cache, so an
  in-place optimizer step leaves nothing stale and every call has its own
  graph); ``remat`` checkpoints each block (``torch.utils.checkpoint``, the
  reference's ``jax.checkpoint(policy=nothing_saveable)``). Attention runs
  kernel 2's dense entry forward and the backward kernel
  (``kernels.flash_attention_bwd``) through ``attention_any``. The serving
  methods stay under ``no_grad`` and keep their cache.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..configs.base import ArchConfig
from ..distributed import spmd
from ..distributed.sharding import (
    constrain_batch_dim,
    constrain_kv_for_cache,
    constrain_residual,
    gather_fsdp,
    is_dtensor,
)
from ..kernels.flash_attention import paged_chunk_attention
from ..kernels.paged_decode_attention import paged_decode_attention
from ..serving.sampler import fold_row_keys
from .attention import attention_any, decode_any
from .cache import (
    chunk_write_plan,
    full_cache_init,
    full_cache_shape,
    full_cache_write,
    full_token_plan,
    paged_cache_init,
    ring_cache_init,
    ring_cache_shape,
    ring_cache_write_prefill,
    ring_positions_prefill,
    ring_positions_write_token,
    ring_token_plan,
    token_write_plan,
    write_rows,
    write_token,
)
from .layers import (
    DTYPES,
    ParamDef,
    apply_norm,
    apply_rope_tables,
    cross_entropy_loss,
    embed_defs,
    embed_tokens,
    init_params,
    layer_slice,
    m_rope_tables,
    mlp_apply,
    mlp_defs,
    moe_aux_weight,
    norm_defs,
    rms_norm,
    rope_tables,
    tree_map,
    unembed,
    ViewCache,
)
from .moe import moe_apply, moe_defs

Params = Dict[str, Any]


def scatter_lengths(
    length: torch.Tensor, slot_ids: torch.Tensor, values: torch.Tensor
) -> None:
    """``length[slot_ids[i]] = values[i]`` in place, dropping ids outside
    ``[0, n_slots)`` (pad rows) with a mask instead of an out-of-range index."""
    n = length.shape[0]
    hit = slot_ids.long()[:, None] == torch.arange(n, device=length.device)[None, :]
    pick = hit.float().argmax(dim=0)
    length.copy_(torch.where(hit.any(dim=0), values[pick], length))


class TransformerLM:
    """Decoder LM (dense, MoE or VLM backbone) on ``device`` (default the
    CUDA device; raises if there is none — pass ``device="cpu"`` for the
    plain path)."""

    FAMILIES = ("dense", "moe", "vlm")
    #: the stacked subtrees, one entry a layer (``train.train_step``)
    STACKS = ("blocks",)

    def __init__(self, cfg: ArchConfig, device="cuda"):
        if cfg.family not in self.FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} is not a TransformerLM family "
                f"{self.FAMILIES} (see models.registry)"
            )
        self.cfg = cfg
        self.hd = cfg.resolved_head_dim
        self.dtype = DTYPES[cfg.dtype]
        self.device = resolve_device(device)
        self._layers = ViewCache(
            lambda blocks: [self._layer_view(blocks, l) for l in range(cfg.n_layers)])

    # ------------------------------------------------------------------ #
    # Parameters                                                          #
    # ------------------------------------------------------------------ #
    def param_defs(self) -> Params:
        cfg, hd, dt = self.cfg, self.hd, self.dtype
        L = cfg.n_layers
        block: Params = {
            "norm_attn": norm_defs(cfg.d_model, cfg.norm_kind, dt, layers=L),
            "norm_mlp": norm_defs(cfg.d_model, cfg.norm_kind, dt, layers=L),
            "wq": ParamDef((L, cfg.d_model, cfg.n_heads, hd), dt,
                           axes=("layers", "embed", "heads", "head_dim")),
            "wk": ParamDef((L, cfg.d_model, cfg.n_kv_heads, hd), dt,
                           axes=("layers", "embed", "kv_heads", "head_dim")),
            "wv": ParamDef((L, cfg.d_model, cfg.n_kv_heads, hd), dt,
                           axes=("layers", "embed", "kv_heads", "head_dim")),
            "wo": ParamDef((L, cfg.n_heads, hd, cfg.d_model), dt,
                           axes=("layers", "heads", "head_dim", "embed")),
        }
        if cfg.use_bias:
            block["bq"] = ParamDef((L, cfg.n_heads, hd), dt, "zeros",
                                   axes=("layers", "heads", "head_dim"))
            block["bk"] = ParamDef((L, cfg.n_kv_heads, hd), dt, "zeros",
                                   axes=("layers", "kv_heads", "head_dim"))
            block["bv"] = ParamDef((L, cfg.n_kv_heads, hd), dt, "zeros",
                                   axes=("layers", "kv_heads", "head_dim"))
            block["bo"] = ParamDef((L, cfg.d_model), dt, "zeros", axes=("layers", "embed"))
        if cfg.qk_norm:
            block["q_norm"] = ParamDef((L, hd), dt, "ones", axes=("layers", "head_dim"))
            block["k_norm"] = ParamDef((L, hd), dt, "ones", axes=("layers", "head_dim"))
        if cfg.is_moe:
            block["moe"] = moe_defs(L, cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.mlp_kind, dt)
        else:
            block["mlp"] = mlp_defs(cfg.d_model, cfg.d_ff, cfg.mlp_kind, dt, layers=L,
                                    use_bias=cfg.use_bias)
        return {
            "embed": embed_defs(cfg.vocab_size, cfg.d_model, dt, tie=cfg.tie_embeddings),
            "blocks": block,
            "norm_final": norm_defs(cfg.d_model, cfg.norm_kind, dt),
        }

    def init_params(self, seed: int = 0) -> Params:
        """Random parameters drawn on the model's device from a seeded
        ``torch.Generator``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return init_params(self.param_defs(), gen, self.device)

    def _layer_view(self, blocks, l: int) -> Params:
        """Layer ``l``'s views of the block weights — the stacked tree (each
        leaf ``(L, ...)``) or a list of per-layer trees — with the
        projection matrices flattened to 2-D and the norm parameters in
        float32."""
        cfg, hd = self.cfg, self.hd
        d = cfg.d_model
        f32 = lambda x: x.float()
        ffn = "moe" if cfg.is_moe else "mlp"
        # on a mesh, the layer's FSDP shards gathered (GSPMD's all-gather)
        layer = tree_map(gather_fsdp, layer_slice(blocks, l))
        lp: Params = {
            "norm_attn": {k: f32(w) for k, w in layer["norm_attn"].items()},
            "norm_mlp": {k: f32(w) for k, w in layer["norm_mlp"].items()},
            "wq": layer["wq"].reshape(d, cfg.n_heads * hd),
            "wk": layer["wk"].reshape(d, cfg.n_kv_heads * hd),
            "wv": layer["wv"].reshape(d, cfg.n_kv_heads * hd),
            "wo": layer["wo"].reshape(cfg.n_heads * hd, d),
            ffn: dict(layer[ffn]),
        }
        if cfg.use_bias:
            for name in ("bq", "bk", "bv", "bo"):
                lp[name] = layer[name]
        if cfg.qk_norm:
            lp["q_norm"] = f32(layer["q_norm"])
            lp["k_norm"] = f32(layer["k_norm"])
        return lp

    def _layer_params(self, params: Params) -> List[Params]:
        """Every layer's ``_layer_view`` for serving, cached for the last
        parameter tree and refreshed in place after an in-place update of
        its leaves (``ViewCache``)."""
        return self._layers(params["blocks"])

    def refresh_views(self, params: Params) -> None:
        """Bring the serving views up to date with ``params`` (after an
        in-place update): a captured dispatch reads them without rebuilding
        them (``serving.graphs``)."""
        self._layer_params(params)

    # ------------------------------------------------------------------ #
    # Serving: cache declaration (dense layout)                           #
    # ------------------------------------------------------------------ #
    def cache_shape(self, batch: int, max_len: int):
        """Tensor shapes of ``cache_init``: a ring of W = min(window,
        max_len) for sliding-window configs, else a full row of max_len."""
        cfg = self.cfg
        if cfg.sliding_window > 0:
            w = min(cfg.sliding_window, max_len)
            return ring_cache_shape(cfg.n_layers, batch, w, cfg.n_kv_heads, self.hd)
        return full_cache_shape(cfg.n_layers, batch, max_len, cfg.n_kv_heads, self.hd)

    def cache_init(self, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        args = (cfg.n_layers, batch)
        tail = (cfg.n_kv_heads, self.hd, self.dtype, self.device)
        if cfg.sliding_window > 0:
            return ring_cache_init(*args, min(cfg.sliding_window, max_len), *tail)
        return full_cache_init(*args, max_len, *tail)

    # ------------------------------------------------------------------ #
    # Serving: paged cache                                                #
    # ------------------------------------------------------------------ #
    def _check_paged_supported(self) -> None:
        if self.cfg.sliding_window > 0:
            raise NotImplementedError(
                "paged KV cache does not support sliding-window configs "
                "(the ring cache already bounds their KV memory at W)"
            )

    def paged_cache_init(
        self, num_pages: int, page_size: int, n_slots: int,
        max_pages_per_slot: int,
    ) -> Dict[str, torch.Tensor]:
        self._check_paged_supported()
        return paged_cache_init(
            self.cfg.n_layers, num_pages, page_size, self.cfg.n_kv_heads,
            self.hd, n_slots, max_pages_per_slot, self.dtype, self.device,
        )

    # ------------------------------------------------------------------ #
    # Block pieces                                                        #
    # ------------------------------------------------------------------ #
    def _rope(self, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """A step's rotation tables for ``positions`` (..., seq): RoPE, or
        M-RoPE over the positions broadcast to three (t, h, w) streams, as
        the reference's serving paths broadcast them."""
        cfg = self.cfg
        if cfg.m_rope:
            pos3 = positions[..., None].expand(*positions.shape, 3)
            return m_rope_tables(pos3, self.hd, cfg.rope_theta, cfg.m_rope_sections)
        return rope_tables(positions, self.hd, cfg.rope_theta)

    def _qkv_block(self, x: torch.Tensor, lp: Params, kv_layout: str = "replicated"):
        """q/k/v projection (+ biases) + qk-norm: (B, S, D) → three ``bshk``
        tensors. On a mesh whose TP axis the KV heads do not divide, K/V
        are partitioned as GSPMD partitions the reference's: replicated over
        it (a decode step's, a ring's), each rank's own KV heads
        (``kv_layout="own"``, the training forward: ``spmd.gqa_kv``), or
        every KV head of the rank's sequence shard (``"cache"``, a prefill
        into a full cache: ``constrain_kv_for_cache`` of the input)."""
        cfg = self.cfg
        b, s, _ = x.shape
        q = (x @ lp["wq"]).view(b, s, cfg.n_heads, self.hd)
        if kv_layout == "own" and is_dtensor(x) and self._gqa_over_tp(x):
            # the rank's KV heads, their biases added
            k, v = (spmd.gqa_kv(x, lp[w], lp.get(bias), cfg.n_kv_heads, cfg.n_heads, self.hd)
                    for w, bias in (("wk", "bk"), ("wv", "bv")))
            if cfg.use_bias:
                q = q + lp["bq"]
        else:
            if kv_layout == "cache" and is_dtensor(x) and constrain_kv_for_cache(x, cfg.n_kv_heads) is not x:
                proj = spmd.seq_sharded_proj
            else:
                proj = lambda x, w: x @ w
            k = proj(x, lp["wk"]).view(b, s, cfg.n_kv_heads, self.hd)
            v = proj(x, lp["wv"]).view(b, s, cfg.n_kv_heads, self.hd)
            if cfg.use_bias:
                q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        if cfg.qk_norm:
            q = rms_norm(q, lp["q_norm"], cfg.norm_eps)
            k = rms_norm(k, lp["k_norm"], cfg.norm_eps)
        return q, k, v

    def _gqa_over_tp(self, x) -> bool:
        sizes = dict(zip(x.device_mesh.mesh_dim_names, tuple(x.device_mesh.shape)))
        return spmd.gqa_split(self.cfg.n_heads, self.cfg.n_kv_heads, sizes.get("model", 1)) is not None

    def _attn_out(self, attn: torch.Tensor, lp: Params) -> torch.Tensor:
        b, s = attn.shape[:2]
        out = attn.reshape(b, s, -1) @ lp["wo"]
        if self.cfg.use_bias:
            out = out + lp["bo"]
        # on a mesh the residual stream stays batch-sharded and replicated
        # over the TP axis: the row-parallel product's partial sums are
        # all-reduced here, and (the constraint on each sum with the residual)
        # the column-parallel products' input gradients where they join it
        return constrain_batch_dim(out, 0)

    def _ffn(self, h: torch.Tensor, lp: Params) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Norm and MLP (or MoE, whose groups and capacity follow ``h``'s
        shape, as in the reference) with the residual, and the MoE's aux
        load-balancing loss (None for an MLP)."""
        cfg = self.cfg
        x = apply_norm(h, lp["norm_mlp"], cfg.norm_kind, cfg.norm_eps)
        if cfg.is_moe:
            out, aux = moe_apply(
                x, lp["moe"], n_experts=cfg.n_experts, top_k=cfg.experts_per_token,
                mlp_kind=cfg.mlp_kind, capacity_factor=cfg.moe_capacity_factor,
                group_size=cfg.moe_group_size,
            )
            return constrain_batch_dim(h + constrain_batch_dim(out, 0), 0), aux
        out = mlp_apply(x, lp["mlp"], cfg.mlp_kind)
        return constrain_batch_dim(h + constrain_batch_dim(out, 0), 0), None

    def _mlp_block(self, h: torch.Tensor, lp: Params) -> torch.Tensor:
        return self._ffn(h, lp)[0]

    def _embed(self, tokens: torch.Tensor, params: Params) -> torch.Tensor:
        return embed_tokens(tokens, params["embed"]).to(self.dtype)

    def _logits(self, h: torch.Tensor, params: Params) -> torch.Tensor:
        cfg = self.cfg
        h = apply_norm(h, params["norm_final"], cfg.norm_kind, cfg.norm_eps)
        return unembed(h, params["embed"]).float()

    def _merge_patches(self, h: torch.Tensor, patch_embeds: Optional[torch.Tensor]) -> torch.Tensor:
        """A VLM config (``num_patch_tokens > 0``) takes ``patch_embeds``
        (B, P, D) in place of the first P token embeddings."""
        if patch_embeds is None or self.cfg.num_patch_tokens <= 0:
            return h
        b, s, _ = h.shape
        p = patch_embeds.shape[1]
        pad = torch.zeros((b, s - p, h.shape[2]), dtype=patch_embeds.dtype, device=h.device)
        merged = torch.cat([patch_embeds, pad], dim=1).to(self.dtype)
        is_patch = (torch.arange(s, device=h.device) < p)[None, :, None]
        return torch.where(is_patch, merged, h)

    # ------------------------------------------------------------------ #
    # Training / full forward                                             #
    # ------------------------------------------------------------------ #
    def _train_block(self, h, blocks, l: int, cos, sin):
        """Layer ``l`` of the full causal forward: (h, aux loss f32). The
        layer's views are built here, so a rematerialised block rebuilds
        them from the leaves."""
        cfg = self.cfg
        lp = self._layer_view(blocks, l)
        x = apply_norm(h, lp["norm_attn"], cfg.norm_kind, cfg.norm_eps)
        q, k, v = self._qkv_block(x, lp, "own")
        q, k = apply_rope_tables(q, cos, sin), apply_rope_tables(k, cos, sin)
        attn = attention_any(q, k, v, causal=True, window=cfg.sliding_window)
        h, aux = self._ffn(constrain_batch_dim(h + self._attn_out(attn, lp), 0), lp)
        return h, aux if aux is not None else torch.zeros((), dtype=torch.float32, device=h.device)

    def forward(
        self,
        params: Params,
        tokens: torch.Tensor,                        # (B, S) int32
        patch_embeds: Optional[torch.Tensor] = None,  # (B, P, D) VLM stub input
        remat: bool = True,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full causal forward → (logits (B, S, V) f32, MoE aux loss f32).
        ``params["blocks"]`` is the stacked tree, or a list of per-layer
        trees (what ``train.train_step`` differentiates: each layer's
        gradient is then its own tensor). With ``remat`` each block is
        recomputed in the backward pass instead of keeping its
        activations."""
        cfg = self.cfg
        b, s = tokens.shape
        h = self._merge_patches(self._embed(tokens, params), patch_embeds)
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[None].expand(b, s)
        cos, sin = self._rope(positions)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        blocks = params["blocks"]
        for l in range(cfg.n_layers):
            if remat:
                h, aux_l = checkpoint(self._train_block, h, blocks, l, cos, sin, use_reentrant=False)
            else:
                h, aux_l = self._train_block(h, blocks, l, cos, sin)
            h = constrain_residual(h)
            aux = aux + aux_l
        return self._logits(h, params), aux

    def loss(self, params: Params, batch: Dict[str, torch.Tensor], remat: bool = True) -> torch.Tensor:
        """Cross-entropy of ``batch["labels"]`` (masked by ``batch["mask"]``
        where given) plus the MoE aux loss times ``moe_aux_weight``."""
        logits, aux = self.forward(params, batch["tokens"], batch.get("patch_embeds"), remat=remat)
        return cross_entropy_loss(logits, batch["labels"], batch.get("mask")) + (
            moe_aux_weight(self.cfg) * aux
        )

    # ------------------------------------------------------------------ #
    # Serving: whole-prompt prefill into a dense cache                    #
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def prefill(
        self,
        params: Params,
        tokens: torch.Tensor,                # (B, S) int32, right-padded
        cache: Dict[str, torch.Tensor],      # dense cache of B rows, updated in place
        patch_embeds: Optional[torch.Tensor] = None,  # (B, P, D) VLM stub input
        lengths: Optional[torch.Tensor] = None,   # (B,) true prompt lengths
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Process the right-padded prompts, fill the cache and return the
        logits at each prompt's last real token. ``lengths`` defaults to the
        full padded width. Pad positions are computed and written like the
        reference writes them; ``length`` masks them from every later read.
        A VLM config (``num_patch_tokens > 0``) takes ``patch_embeds`` in
        place of the first P token embeddings."""
        cfg = self.cfg
        b, s = tokens.shape
        dev = tokens.device
        positions = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
        rope = self._rope(positions)
        len_vec = (
            torch.full((b,), s, dtype=torch.int32, device=dev) if lengths is None
            else lengths.to(torch.int32)
        )
        ring = cfg.sliding_window > 0
        if ring:
            pos_map = ring_positions_prefill(b, cache["k"].shape[2], len_vec)
        h = self._merge_patches(self._embed(tokens, params), patch_embeds)
        for l, lp in enumerate(self._layer_params(params)):
            kc, vc = cache["k"][l], cache["v"][l]
            x = apply_norm(h, lp["norm_attn"], cfg.norm_kind, cfg.norm_eps)
            q, k, v = self._qkv_block(x, lp, "replicated" if ring else "cache")
            q, k = apply_rope_tables(q, *rope), apply_rope_tables(k, *rope)
            if ring:
                ring_cache_write_prefill(kc, vc, k, v, pos_map)
            else:
                # on a mesh the write's source takes the cache's layout
                full_cache_write(kc, vc, constrain_kv_for_cache(k, cfg.n_kv_heads),
                                 constrain_kv_for_cache(v, cfg.n_kv_heads), 0)
            attn = attention_any(q, k, v, causal=True, window=cfg.sliding_window)
            h = constrain_residual(self._mlp_block(h + self._attn_out(attn, lp), lp))
        if lengths is None:
            h_last = h[:, -1]
        else:
            h_last = h[torch.arange(b, device=dev), (len_vec.long() - 1).clamp(min=0)]
        logits = self._logits(h_last, params)
        cache["length"].copy_(len_vec)
        if ring:
            cache["pos"].copy_(pos_map)
        return logits, cache

    # ------------------------------------------------------------------ #
    # Serving: chunked prefill into the paged pool                        #
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def prefill_chunk(
        self,
        params: Params,
        tokens: torch.Tensor,                # (B, C) int32 — one chunk per row
        cache: Dict[str, torch.Tensor],      # paged pool, updated in place
        slot_ids: torch.Tensor,              # (B,) int32; >= n_slots → pad row
        starts: torch.Tensor,                # (B,) int32 — chunk offset in prompt
        chunk_lens: torch.Tensor,            # (B,) int32 — real tokens (≤ C)
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Process one prompt chunk per row, writing K/V straight into the
        rows' pages; queries attend to everything the slot has accumulated.
        Returns the logits at each row's last real chunk token and the pool."""
        cfg = self.cfg
        self._check_paged_supported()
        b, c = tokens.shape
        n_slots = cache["block_tables"].shape[0]
        positions = starts[:, None] + torch.arange(c, dtype=torch.int32, device=tokens.device)
        tables = cache["block_tables"][slot_ids.long().clamp(0, n_slots - 1)]
        new_lens = starts + chunk_lens
        rope = self._rope(positions)
        plan = chunk_write_plan(tables, starts, chunk_lens, cache["k"].shape[3], c)
        h = self._embed(tokens, params)
        for l, lp in enumerate(self._layer_params(params)):
            kc, vc = cache["k"][l], cache["v"][l]
            x = apply_norm(h, lp["norm_attn"], cfg.norm_kind, cfg.norm_eps)
            q, k, v = self._qkv_block(x, lp)
            q, k = apply_rope_tables(q, *rope), apply_rope_tables(k, *rope)
            write_rows(kc, vc, k, v, plan)
            attn = paged_chunk_attention(q, kc, vc, tables, starts, new_lens)
            h = self._mlp_block(h + self._attn_out(attn, lp), lp)
        rows = torch.arange(b, device=h.device)
        h_last = h[rows, (chunk_lens.long() - 1).clamp(min=0)]
        logits = self._logits(h_last, params)
        scatter_lengths(cache["length"], slot_ids, new_lens)
        return logits, cache

    # ------------------------------------------------------------------ #
    # Serving: unified mixed prefill+decode dispatch                      #
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def mixed_step(
        self,
        params: Params,
        dec_tokens: torch.Tensor,            # (J,) int32 — pending token/slot
        cache: Dict[str, torch.Tensor],      # paged pool, updated in place
        chunk_tokens: torch.Tensor,          # (R, C) int32 — one chunk per row
        chunk_slots: torch.Tensor,           # (R,) int32; >= n_slots → pad row
        chunk_starts: torch.Tensor,          # (R,) int32 — offset in prompt
        chunk_lens: torch.Tensor,            # (R,) int32 — real tokens (≤ C)
        *,
        sampler,                             # serving.sampler.Sampler object
        dec_active: torch.Tensor,            # (J,) bool — slots decoding now
        rids: torch.Tensor,                  # (J+R,) int32 — request ids
        token_idx: torch.Tensor,             # (J+R,) int32 — sampled token index
        sample_rows: torch.Tensor,           # (J+R,) bool — rows that sample
        base_key: Optional[torch.Tensor] = None,  # (2,) threefry key
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One mixed batch — a decode round over all J slots plus R ragged
        prefill-chunk rows — in one pass over the layers. The sub-batches own
        disjoint slots, so the round equals the chunk round followed by the
        decode round. Decode lanes sample first, then chunk rows (a prompt's
        final chunk emits its first token here). A stochastic sampler draws
        each row from keys folded from ``(base_key, rids, token_idx)``, so
        streams stay a pure function of (seed, rid, token index) whatever
        the batch holds. Returns ``(sampled (J+R,) int32 with -1 on
        non-sampling rows, pool)``."""
        cfg = self.cfg
        self._check_paged_supported()
        r, c = chunk_tokens.shape
        n_slots = cache["block_tables"].shape[0]
        dev = chunk_tokens.device
        lengths = cache["length"]
        grow = dec_active.to(torch.int32)
        dec_valid = lengths + grow
        dec_pos = lengths[:, None]
        dec_tables = cache["block_tables"]
        ch_pos = chunk_starts[:, None] + torch.arange(c, dtype=torch.int32, device=dev)
        ch_tables = cache["block_tables"][chunk_slots.long().clamp(0, n_slots - 1)]
        ch_new_lens = chunk_starts + chunk_lens
        page_size = cache["k"].shape[3]
        rope_d = self._rope(dec_pos)
        rope_c = self._rope(ch_pos)
        plan_c = chunk_write_plan(ch_tables, chunk_starts, chunk_lens, page_size, c)
        plan_d = token_write_plan(dec_tables, lengths, dec_active, page_size)

        h_d = self._embed(dec_tokens[:, None], params)
        h_c = self._embed(chunk_tokens, params)
        for l, lp in enumerate(self._layer_params(params)):
            kc, vc = cache["k"][l], cache["v"][l]
            x_d = apply_norm(h_d, lp["norm_attn"], cfg.norm_kind, cfg.norm_eps)
            q_d, k_d, v_d = self._qkv_block(x_d, lp)
            x_c = apply_norm(h_c, lp["norm_attn"], cfg.norm_kind, cfg.norm_eps)
            q_c, k_c, v_c = self._qkv_block(x_c, lp)
            q_d, k_d = apply_rope_tables(q_d, *rope_d), apply_rope_tables(k_d, *rope_d)
            q_c, k_c = apply_rope_tables(q_c, *rope_c), apply_rope_tables(k_c, *rope_c)
            # all page writes land before either attention reads — the
            # sub-batches own disjoint slots, so write order is irrelevant
            write_rows(kc, vc, k_c, v_c, plan_c)
            write_rows(kc, vc, k_d, v_d, plan_d)
            attn_c = paged_chunk_attention(q_c, kc, vc, ch_tables, chunk_starts, ch_new_lens)
            attn_d = paged_decode_attention(q_d, kc, vc, dec_tables, dec_valid)
            h_d = self._mlp_block(h_d + self._attn_out(attn_d, lp), lp)
            h_c = self._mlp_block(h_c + self._attn_out(attn_c, lp), lp)
        rows = torch.arange(r, device=dev)
        h_last = torch.cat(
            [h_d[:, 0], h_c[rows, (chunk_lens.long() - 1).clamp(min=0)]]
        )
        logits = self._logits(h_last, params)
        if base_key is None:
            nxt = sampler(logits)
        else:
            nxt = sampler(logits, fold_row_keys(base_key, rids, token_idx))
        sampled = torch.where(sample_rows, nxt, -1)
        # decode lanes grow their slot by one; chunk rows set start+len
        # (disjoint slots; pad rows are masked out)
        lengths.copy_(dec_valid)
        scatter_lengths(lengths, chunk_slots, ch_new_lens)
        return sampled, cache

    # ------------------------------------------------------------------ #
    # Serving: one decode step / fused multi-step decode                  #
    # ------------------------------------------------------------------ #
    def decode_step(self, params, tokens, cache, active=None):
        """Append one token per slot; returns (logits (B, V) f32, cache). A
        ``block_tables`` key selects the paged pool, else the dense cache
        (a ``pos`` key: its ring form). ``active`` masks the slots that may
        write and advance; ``None`` advances every slot."""
        if "block_tables" in cache:
            return self._decode_step_paged(params, tokens, cache, active)
        return self._decode_step_dense(params, tokens, cache, active)

    @torch.no_grad()
    def _decode_step_dense(
        self,
        params: Params,
        tokens: torch.Tensor,                # (B,) int32
        cache: Dict[str, torch.Tensor],      # full or ring cache of B slots
        active: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        b = tokens.shape[0]
        lengths = cache["length"]
        if active is None:
            active = torch.ones((b,), dtype=torch.bool, device=tokens.device)
        new_lens = lengths + active.to(torch.int32)
        rope = self._rope(lengths[:, None])
        ring = "pos" in cache
        if ring:
            # the ring fills slot p mod W in order, so its valid entries are
            # the prefix [0, min(len, W)), and every one of them lies inside
            # the new query's window (W <= sliding_window): a length mask is
            # the reference's position mask over ``pos``
            w = cache["k"].shape[2]
            plan = ring_token_plan(lengths, w, active)
            new_pos = ring_positions_write_token(cache["pos"], lengths, active)
            kv_lens = torch.clamp(new_lens, max=w)
        else:
            plan = full_token_plan(lengths, cache["k"].shape[2], active)
            kv_lens = new_lens
        h = self._embed(tokens[:, None], params)
        for l, lp in enumerate(self._layer_params(params)):
            kc, vc = cache["k"][l], cache["v"][l]
            x = apply_norm(h, lp["norm_attn"], cfg.norm_kind, cfg.norm_eps)
            q, k, v = self._qkv_block(x, lp)
            q, k = apply_rope_tables(q, *rope), apply_rope_tables(k, *rope)
            write_token(kc, vc, k, v, plan)
            attn = decode_any(q[:, 0], kc, vc, kv_lens)
            h = self._mlp_block(h + self._attn_out(attn[:, None], lp), lp)
        logits = self._logits(h[:, 0], params)
        lengths.copy_(new_lens)
        if ring:
            cache["pos"].copy_(new_pos)
        return logits, cache

    @torch.no_grad()
    def _decode_step_paged(
        self,
        params: Params,
        tokens: torch.Tensor,                # (B,) int32
        cache: Dict[str, torch.Tensor],      # paged pool; B = n_slots
        active: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        b = tokens.shape[0]
        tables = cache["block_tables"]
        lengths = cache["length"]
        if active is None:
            active = torch.ones((b,), dtype=torch.bool, device=tokens.device)
        new_lens = lengths + active.to(torch.int32)
        rope = self._rope(lengths[:, None])
        plan = token_write_plan(tables, lengths, active, cache["k"].shape[3])
        h = self._embed(tokens[:, None], params)
        for l, lp in enumerate(self._layer_params(params)):
            kc, vc = cache["k"][l], cache["v"][l]
            x = apply_norm(h, lp["norm_attn"], cfg.norm_kind, cfg.norm_eps)
            q, k, v = self._qkv_block(x, lp)
            q, k = apply_rope_tables(q, *rope), apply_rope_tables(k, *rope)
            write_rows(kc, vc, k, v, plan)
            # post-write valid counts: active slots gained one token at
            # position ``lengths``; inactive slots' outputs are ignored
            attn = paged_decode_attention(q, kc, vc, tables, new_lens)
            h = self._mlp_block(h + self._attn_out(attn, lp), lp)
        logits = self._logits(h[:, 0], params)
        lengths.copy_(new_lens)
        return logits, cache

    @torch.no_grad()
    def decode_steps(
        self,
        params: Params,
        tokens: torch.Tensor,                # (B,) int32 — last sampled token
        cache: Dict[str, torch.Tensor],      # dense or paged, updated in place
        *,
        num_steps: int,                      # the fused horizon K
        sampler,                             # serving.sampler.Sampler object
        active: torch.Tensor,                # (B,) bool — slots decoding now
        budgets: torch.Tensor,               # (B,) int32 — max tokens to emit
        rids: torch.Tensor,                  # (B,) int32 — request ids
        token_idx0: torch.Tensor,            # (B,) int32 — next token's index
        base_key: Optional[torch.Tensor] = None,  # (2,) threefry key
        eos_id: Optional[int] = None,
    ):
        """K decode iterations queued back to back on the device: attention,
        KV append and sampling all stay there, and no iteration reads a
        device value on the host. A stochastic sampler draws each row from
        keys folded from ``(base_key, rids, token_idx0 + emitted so far)``,
        so a stream does not depend on the horizon K. A slot stops after
        ``budgets[b]`` tokens or on ``eos_id`` and is a no-op from then on
        (masked KV write, frozen length). Returns ``(token_block (K, B)
        int32 with -1 where a slot emitted nothing, emitted (B,) int32,
        active_out (B,) bool, last_token (B,) int32, pool)``."""
        cur, act = tokens, active
        counts = torch.zeros_like(tokens)
        block = []
        keys = None
        if base_key is not None:
            # a slot that samples at iteration i has been active at every
            # iteration before it, so its count is i: the K iterations' keys
            # are folded up front, in one batch, and equal the reference's
            # per-iteration fold on every row whose draw is kept
            steps = token_idx0 + torch.arange(num_steps, dtype=token_idx0.dtype,
                                              device=token_idx0.device)[:, None]
            keys = fold_row_keys(base_key, rids, steps)
        for i in range(num_steps):
            logits, cache = self.decode_step(params, cur, cache, active=act)
            nxt = sampler(logits) if keys is None else sampler(logits, keys[i])
            nxt = torch.where(act, nxt, cur)      # frozen slots keep theirs
            counts = counts + act.to(torch.int32)
            new_act = act & (counts < budgets)
            if eos_id is not None:
                new_act = new_act & (nxt != eos_id)
            block.append(torch.where(act, nxt, -1))
            cur, act = nxt, new_act
        return torch.stack(block), counts, act, cur, cache
