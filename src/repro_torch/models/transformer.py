"""Decoder-only transformer LM, paged serving path (counterpart of the dense
family's serving methods in ``repro.models.transformer``).

* Parameters keep the reference's tree and stacked ``(L, ...)`` layout; the
  reference's ``lax.scan`` over layers becomes a loop over layer slices.
* The KV pool is updated in place (the reference donates it to its jitted
  steps and gets a new one back); every method still returns the pool so
  call sites read like the reference's.
* Attention runs through the hand-written kernels: the decode lanes of
  ``mixed_step`` / ``decode_steps`` through ``kernels.paged_decode_attention``
  and the prefill-chunk rows of ``prefill_chunk`` / ``mixed_step`` through the
  paged entry of ``kernels.flash_attention``. On CPU tensors those wrappers
  run their plain PyTorch versions.
* Nothing inside ``decode_steps`` reads device values on the host: its K
  iterations queue without a host sync, so a fused horizon is one sync (the
  caller's copy of the token block).
* What XLA hoists out of the reference's layer scan is hoisted here by hand:
  each step computes its RoPE tables and its KV write plan once, and the
  per-layer weights (with float32 norm scales) are sliced once per
  parameter tree.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from .. import resolve_device
from ..configs.base import ArchConfig
from ..kernels.flash_attention import paged_chunk_attention
from ..kernels.paged_decode_attention import paged_decode_attention
from .cache import chunk_write_plan, paged_cache_init, token_write_plan, write_rows
from .layers import (
    DTYPES,
    ParamDef,
    apply_norm,
    apply_rope_tables,
    embed_defs,
    embed_tokens,
    init_params,
    mlp_apply,
    mlp_defs,
    norm_defs,
    rms_norm,
    rope_tables,
    unembed,
)

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
    """Dense decoder LM on ``device`` (default the CUDA device; raises if
    there is none — pass ``device="cpu"`` for the plain path)."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        unsupported = {
            "family": cfg.family != "dense",
            "moe": cfg.is_moe,
            "m_rope": cfg.m_rope,
            "sliding_window": cfg.sliding_window > 0,
            "use_bias": cfg.use_bias,
            "norm_kind": cfg.norm_kind != "rmsnorm",
            "mlp_kind": cfg.mlp_kind != "swiglu",
        }
        missing = [k for k, v in unsupported.items() if v]
        if missing:
            raise NotImplementedError(
                f"{cfg.name}: {missing} not ported yet — the port serves dense "
                f"RMSNorm/SwiGLU decoders with full attention (see ROADMAP.md)"
            )
        self.cfg = cfg
        self.hd = cfg.resolved_head_dim
        self.dtype = DTYPES[cfg.dtype]
        self.device = resolve_device(device)
        self._layers_src: Optional[Params] = None
        self._layers: List[Params] = []

    # ------------------------------------------------------------------ #
    # Parameters                                                          #
    # ------------------------------------------------------------------ #
    def param_defs(self) -> Params:
        cfg, hd, dt = self.cfg, self.hd, self.dtype
        L = cfg.n_layers
        block: Params = {
            "norm_attn": norm_defs(cfg.d_model, dt, layers=L),
            "norm_mlp": norm_defs(cfg.d_model, dt, layers=L),
            "wq": ParamDef((L, cfg.d_model, cfg.n_heads, hd), dt),
            "wk": ParamDef((L, cfg.d_model, cfg.n_kv_heads, hd), dt),
            "wv": ParamDef((L, cfg.d_model, cfg.n_kv_heads, hd), dt),
            "wo": ParamDef((L, cfg.n_heads, hd, cfg.d_model), dt),
            "mlp": mlp_defs(cfg.d_model, cfg.d_ff, cfg.mlp_kind, dt, layers=L),
        }
        if cfg.qk_norm:
            block["q_norm"] = ParamDef((L, hd), dt, "ones")
            block["k_norm"] = ParamDef((L, hd), dt, "ones")
        return {
            "embed": embed_defs(cfg.vocab_size, cfg.d_model, dt, tie=cfg.tie_embeddings),
            "blocks": block,
            "norm_final": norm_defs(cfg.d_model, dt),
        }

    def init_params(self, seed: int = 0) -> Params:
        """Random parameters drawn on the model's device from a seeded
        ``torch.Generator``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return init_params(self.param_defs(), gen, self.device)

    def _layer_params(self, params: Params) -> List[Params]:
        """Per-layer views of the stacked block weights, with the projection
        matrices flattened to 2-D (cached for the last parameter tree)."""
        blocks = params["blocks"]
        if self._layers_src is not blocks:
            cfg, hd = self.cfg, self.hd
            d = cfg.d_model
            layers = []
            f32 = lambda x: x.float()
            for l in range(cfg.n_layers):
                lp: Params = {
                    "norm_attn": {"scale": f32(blocks["norm_attn"]["scale"][l])},
                    "norm_mlp": {"scale": f32(blocks["norm_mlp"]["scale"][l])},
                    "wq": blocks["wq"][l].reshape(d, cfg.n_heads * hd),
                    "wk": blocks["wk"][l].reshape(d, cfg.n_kv_heads * hd),
                    "wv": blocks["wv"][l].reshape(d, cfg.n_kv_heads * hd),
                    "wo": blocks["wo"][l].reshape(cfg.n_heads * hd, d),
                    "mlp": {k: w[l] for k, w in blocks["mlp"].items()},
                }
                if cfg.qk_norm:
                    lp["q_norm"] = f32(blocks["q_norm"][l])
                    lp["k_norm"] = f32(blocks["k_norm"][l])
                layers.append(lp)
            self._layers, self._layers_src = layers, blocks
        return self._layers

    # ------------------------------------------------------------------ #
    # Serving: paged cache                                                #
    # ------------------------------------------------------------------ #
    def paged_cache_init(
        self, num_pages: int, page_size: int, n_slots: int,
        max_pages_per_slot: int,
    ) -> Dict[str, torch.Tensor]:
        return paged_cache_init(
            self.cfg.n_layers, num_pages, page_size, self.cfg.n_kv_heads,
            self.hd, n_slots, max_pages_per_slot, self.dtype, self.device,
        )

    # ------------------------------------------------------------------ #
    # Block pieces                                                        #
    # ------------------------------------------------------------------ #
    def _qkv_block(self, x: torch.Tensor, lp: Params):
        """q/k/v projection + qk-norm: (B, S, D) → three ``bshk`` tensors."""
        cfg = self.cfg
        b, s, _ = x.shape
        q = (x @ lp["wq"]).view(b, s, cfg.n_heads, self.hd)
        k = (x @ lp["wk"]).view(b, s, cfg.n_kv_heads, self.hd)
        v = (x @ lp["wv"]).view(b, s, cfg.n_kv_heads, self.hd)
        if cfg.qk_norm:
            q = rms_norm(q, lp["q_norm"], cfg.norm_eps)
            k = rms_norm(k, lp["k_norm"], cfg.norm_eps)
        return q, k, v

    def _attn_out(self, attn: torch.Tensor, lp: Params) -> torch.Tensor:
        b, s = attn.shape[:2]
        return attn.reshape(b, s, -1) @ lp["wo"]

    def _mlp_block(self, h: torch.Tensor, lp: Params) -> torch.Tensor:
        cfg = self.cfg
        x = apply_norm(h, lp["norm_mlp"], cfg.norm_kind, cfg.norm_eps)
        return h + mlp_apply(x, lp["mlp"], cfg.mlp_kind)

    def _embed(self, tokens: torch.Tensor, params: Params) -> torch.Tensor:
        return embed_tokens(tokens, params["embed"]).to(self.dtype)

    def _logits(self, h: torch.Tensor, params: Params) -> torch.Tensor:
        cfg = self.cfg
        h = apply_norm(h, params["norm_final"], cfg.norm_kind, cfg.norm_eps)
        return unembed(h, params["embed"]).float()

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
        b, c = tokens.shape
        n_slots = cache["block_tables"].shape[0]
        positions = starts[:, None] + torch.arange(c, dtype=torch.int32, device=tokens.device)
        tables = cache["block_tables"][slot_ids.long().clamp(0, n_slots - 1)]
        new_lens = starts + chunk_lens
        rope = rope_tables(positions, self.hd, cfg.rope_theta)
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
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One mixed batch — a decode round over all J slots plus R ragged
        prefill-chunk rows — in one pass over the layers. The sub-batches own
        disjoint slots, so the round equals the chunk round followed by the
        decode round. Decode lanes sample first, then chunk rows (a prompt's
        final chunk emits its first token here). Returns ``(sampled (J+R,)
        int32 with -1 on non-sampling rows, pool)``. ``rids`` / ``token_idx``
        key stochastic samplers in the reference; greedy sampling ignores
        them."""
        if getattr(sampler, "stochastic", False):
            raise NotImplementedError("stochastic samplers are not ported yet")
        cfg = self.cfg
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
        rope_d = rope_tables(dec_pos, self.hd, cfg.rope_theta)
        rope_c = rope_tables(ch_pos, self.hd, cfg.rope_theta)
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
        nxt = sampler(self._logits(h_last, params))
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
        """Append one token per slot; returns (logits (B, V) f32, pool). The
        port has only the paged layout."""
        return self._decode_step_paged(params, tokens, cache, active)

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
        rope = rope_tables(lengths[:, None], self.hd, cfg.rope_theta)
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
        cache: Dict[str, torch.Tensor],      # paged pool, updated in place
        *,
        num_steps: int,                      # the fused horizon K
        sampler,                             # serving.sampler.Sampler object
        active: torch.Tensor,                # (B,) bool — slots decoding now
        budgets: torch.Tensor,               # (B,) int32 — max tokens to emit
        rids: torch.Tensor,                  # (B,) int32 — request ids
        token_idx0: torch.Tensor,            # (B,) int32 — next token's index
        eos_id: Optional[int] = None,
    ):
        """K decode iterations queued back to back on the device: attention,
        KV append and greedy sampling all stay there, and no iteration reads
        a device value on the host. A slot stops after ``budgets[b]`` tokens
        or on ``eos_id`` and is a no-op from then on (masked KV write, frozen
        length). Returns ``(token_block (K, B) int32 with -1 where a slot
        emitted nothing, emitted (B,) int32, active_out (B,) bool,
        last_token (B,) int32, pool)``."""
        if getattr(sampler, "stochastic", False):
            raise NotImplementedError("stochastic samplers are not ported yet")
        cur, act = tokens, active
        counts = torch.zeros_like(tokens)
        block = []
        for _ in range(num_steps):
            logits, cache = self._decode_step_paged(params, cur, cache, active=act)
            nxt = torch.where(act, sampler(logits), cur)   # frozen slots keep theirs
            counts = counts + act.to(torch.int32)
            new_act = act & (counts < budgets)
            if eos_id is not None:
                new_act = new_act & (nxt != eos_id)
            block.append(torch.where(act, nxt, -1))
            cur, act = nxt, new_act
        return torch.stack(block), counts, act, cur, cache
