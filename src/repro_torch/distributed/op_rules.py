"""DTensor sharding rules of the kernels' custom ops (``repro_torch::*``):
which placements of its inputs each op runs on shard by shard, and where
its outputs then lie. Each op runs replicated, on the batch (or paged rows)
sharded, or on its heads (the RG-LRU: its channels) sharded. An attention's
heads shard only with its KV heads, one group to the same rank, so a
sharding of the query heads alone is not among them: the models' call
sites take that case (``distributed.spmd``).

``register()`` installs the rules (once; importing DTensor is left to the
processes that run one: the dry-run and the tests).
"""
from __future__ import annotations

_DONE = {"registered": False}


def register() -> None:
    if _DONE["registered"]:
        return
    import torch
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    from ..kernels import (  # noqa: F401  (each defines its ops)
        decode_attention,
        flash_attention_bwd,
        paged_decode_attention,
        rglru,
    )

    R = Replicate()
    ops = torch.ops.repro_torch

    @register_sharding(ops.rglru_scan.default)
    def _rglru(a, x, h0):
        return [([R, R], [R, R, R]),
                ([Shard(0), Shard(0)], [Shard(0), Shard(0), Shard(0)]),
                ([Shard(2), Shard(1)], [Shard(2), Shard(2), Shard(1)])]

    @register_sharding(ops.rglru_scan_backward.default)
    def _rglru_bwd(a, h, h0, g, g_fin):
        return [([R, R, R], [R] * 5),
                ([Shard(0)] * 3, [Shard(0)] * 5),
                ([Shard(2), Shard(2), Shard(1)], [Shard(2), Shard(2), Shard(1), Shard(2), Shard(1)])]

    @register_sharding(ops.flash_attention.default)
    def _flash(q, k, v, causal, window, scale, return_lse):
        rules = [([R, R], [R, R, R, None, None, None, None])]
        for dim in (0, 1):                                  # batch, heads
            lse = Shard(dim) if return_lse else R
            rules.append(([Shard(dim), lse], [Shard(dim)] * 3 + [None] * 4))
        return rules

    @register_sharding(ops.flash_attention_backward.default)
    def _flash_bwd(q, k, v, out, lse, d_out, causal, window, scale):
        return [([R] * 3, [R] * 6 + [None] * 3)] + [
            ([Shard(dim)] * 3, [Shard(dim)] * 6 + [None] * 3) for dim in (0, 1)]

    @register_sharding(ops.decode_attention.default)
    def _decode(q, k, v, lengths, scale, return_lse):
        lse = lambda pl: pl if return_lse else R
        return [([R, R], [R, R, R, R, None, None]),
                ([Shard(0), lse(Shard(0))], [Shard(0)] * 4 + [None, None]),
                ([Shard(1), lse(Shard(1))], [Shard(1)] * 3 + [R, None, None])]

    @register_sharding(ops.paged_decode_attention.default)
    def _paged_decode(q, k_pages, v_pages, tables, lengths, scale):
        return [([R], [R] * 5 + [None]),
                ([Shard(0)], [Shard(0), R, R, Shard(0), Shard(0), None]),
                ([Shard(2)], [Shard(2), Shard(0), Shard(0), R, R, None])]

    @register_sharding(ops.paged_chunk_attention.default)
    def _paged_chunk(q, k_pages, v_pages, tables, starts, valid_lens, scale):
        return [([R], [R] * 6 + [None]),
                ([Shard(0)], [Shard(0), R, R] + [Shard(0)] * 3 + [None]),
                ([Shard(2)], [Shard(2), Shard(0), Shard(0), R, R, R, None])]

    _DONE["registered"] = True
