"""KV caches (counterpart of ``repro.models.cache``).

Three layouts, each a dict of tensors stacked over layers:

  * full cache  — ``k``/``v`` (L, B, S_max, KV, D) and ``length`` (B,): one
                  dense row per slot, written at the slot's ``length``;
  * ring cache  — ``k``/``v`` (L, B, W, KV, D), ``pos`` (B, W) int32 (the
                  absolute position each ring slot holds, -1 = empty) and
                  ``length``: sliding-window configs, position p in slot
                  p mod W;
  * paged pool  — below.

The paged pool is a dict of tensors:

  * ``k``, ``v``      — (L, KV, P, bs, D): P pages of ``bs`` tokens per layer,
                        KV heads outermost so one page of one head is a
                        contiguous (bs, D) tile (what the decode and prefill
                        kernels load);
  * ``block_tables``  — (n_slots, MB) int32, slot → page ids, -1 = unallocated;
  * ``length``        — (n_slots,) int32 valid tokens per slot.

Where the reference returns an updated copy of the pool (its jitted steps
donate the buffer), the writes here update the layer slice in place.

Dropped writes follow the reference's rules (tokens past ``lens``, table
entries of -1, blocks past MB, inactive slots) but are realised with masks
and in-range indices only: on a CUDA tensor an out-of-range index is a
device-side assert, not a drop. No write synchronises with the host, so a
fused decode horizon stays one host sync. A step computes its write plan
once (``chunk_write_plan`` / ``token_write_plan``) and every layer reuses it.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from ..distributed import spmd
from ..distributed.sharding import is_dtensor


# --------------------------------------------------------------------------- #
# Full and ring caches (the dense layout)                                     #
# --------------------------------------------------------------------------- #
def full_cache_shape(
    n_layers: int, batch: int, max_len: int, kv_heads: int, head_dim: int,
) -> Dict[str, Tuple[int, ...]]:
    kv = (n_layers, batch, max_len, kv_heads, head_dim)
    return {"k": kv, "v": kv, "length": (batch,)}


def full_cache_init(
    n_layers: int, batch: int, max_len: int, kv_heads: int, head_dim: int,
    dtype=torch.bfloat16, device="cuda",
) -> Dict[str, torch.Tensor]:
    shape = full_cache_shape(n_layers, batch, max_len, kv_heads, head_dim)
    return {
        "k": torch.zeros(shape["k"], dtype=dtype, device=device),
        "v": torch.zeros(shape["v"], dtype=dtype, device=device),
        "length": torch.zeros(shape["length"], dtype=torch.int32, device=device),
    }


def ring_cache_shape(
    n_layers: int, batch: int, window: int, kv_heads: int, head_dim: int,
) -> Dict[str, Tuple[int, ...]]:
    kv = (n_layers, batch, window, kv_heads, head_dim)
    return {"k": kv, "v": kv, "pos": (batch, window), "length": (batch,)}


def ring_cache_init(
    n_layers: int, batch: int, window: int, kv_heads: int, head_dim: int,
    dtype=torch.bfloat16, device="cuda",
) -> Dict[str, torch.Tensor]:
    shape = ring_cache_shape(n_layers, batch, window, kv_heads, head_dim)
    return {
        "k": torch.zeros(shape["k"], dtype=dtype, device=device),
        "v": torch.zeros(shape["v"], dtype=dtype, device=device),
        "pos": torch.full(shape["pos"], -1, dtype=torch.int32, device=device),
        "length": torch.zeros(shape["length"], dtype=torch.int32, device=device),
    }


def full_cache_write(
    k_layer: torch.Tensor,       # (B, S_max, KV, D) — updated in place
    v_layer: torch.Tensor,
    k_new: torch.Tensor,         # (B, S_new, KV, D)
    v_new: torch.Tensor,
    start: int,                  # write offset
) -> None:
    """Bulk write of ``S_new`` tokens at ``start`` (a prefill); on DTensors
    each rank writes its shard's rows (``distributed.spmd``)."""
    if is_dtensor(k_layer) and start == 0:
        return spmd.write_prefill(k_layer, v_layer, k_new, v_new)
    s = k_new.shape[1]
    k_layer[:, start : start + s].copy_(k_new)
    v_layer[:, start : start + s].copy_(v_new)


class TokenWritePlan(NamedTuple):
    """Where one decode token per slot goes in a full or ring layer slice,
    shared by every layer of the step: ``index`` (B,) int64 in-range row
    positions and ``valid`` (B,) whether the row writes (a dropped row
    writes back what it holds)."""

    index: torch.Tensor
    valid: torch.Tensor


def full_token_plan(
    positions: torch.Tensor,                # (B,) int32 — per-slot write positions
    max_len: int,
    active: Optional[torch.Tensor] = None,  # (B,) bool — rows allowed to write
) -> TokenWritePlan:
    """The reference drops an inactive row (and one at or past ``max_len``)
    by scattering out of range; here it gets position 0 and writes back."""
    pos = positions.long()
    valid = (pos >= 0) & (pos < max_len)
    if active is not None:
        valid = valid & active
    return TokenWritePlan(torch.where(valid, pos, 0), valid)


def ring_token_plan(
    positions: torch.Tensor,                # (B,) int32 — absolute token positions
    window: int,
    active: Optional[torch.Tensor] = None,
) -> TokenWritePlan:
    """Position p lands in ring slot p mod W; inactive rows write back."""
    valid = torch.ones_like(positions, dtype=torch.bool) if active is None else active
    return TokenWritePlan(torch.remainder(positions.long(), window), valid)


def write_token(
    k_layer: torch.Tensor,       # (B, S, KV, D) — full or ring slice, in place
    v_layer: torch.Tensor,
    k_new: torch.Tensor,         # (B, 1, KV, D)
    v_new: torch.Tensor,
    plan: TokenWritePlan,
) -> None:
    """``layer[b, index[b]] = new[b, 0]`` for the valid rows. Each row writes
    only its own slot row, so no two writes alias. On DTensors each rank
    writes the rows its shard holds (``distributed.spmd``)."""
    if is_dtensor(k_layer):
        return spmd.write_token(k_layer, v_layer, k_new, v_new, plan.index, plan.valid)
    rows = torch.arange(k_layer.shape[0], device=k_layer.device)
    keep = plan.valid[:, None, None]
    for layer, new in ((k_layer, k_new), (v_layer, v_new)):
        old = layer[rows, plan.index]
        layer[rows, plan.index] = torch.where(keep, new[:, 0].to(layer.dtype), old)


def full_cache_write_token(
    k_layer: torch.Tensor, v_layer: torch.Tensor,
    k_new: torch.Tensor, v_new: torch.Tensor,
    positions: torch.Tensor,                # (B,) int32
    active: Optional[torch.Tensor] = None,  # (B,) bool
) -> None:
    write_token(k_layer, v_layer, k_new, v_new,
                full_token_plan(positions, k_layer.shape[1], active))


def ring_cache_write_token(
    k_layer: torch.Tensor, v_layer: torch.Tensor,
    k_new: torch.Tensor, v_new: torch.Tensor,
    positions: torch.Tensor,                # (B,) int32 — absolute positions
    active: Optional[torch.Tensor] = None,
) -> None:
    write_token(k_layer, v_layer, k_new, v_new,
                ring_token_plan(positions, k_layer.shape[1], active))


def ring_positions_write_token(
    pos: torch.Tensor,                      # (B, W) int32
    positions: torch.Tensor,                # (B,) int32
    active: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The (B, W) slot→position map after one token per slot (a new tensor;
    inactive rows keep theirs)."""
    w = pos.shape[1]
    hit = torch.remainder(positions.long(), w)[:, None] == torch.arange(w, device=pos.device)
    if active is not None:
        hit = hit & active[:, None]
    return torch.where(hit, positions.to(pos.dtype)[:, None], pos)


def ring_positions_prefill(
    batch: int, window: int, s: Union[int, torch.Tensor], device="cpu",
) -> torch.Tensor:
    """Slot→position map after prefills of length ``s`` (an int, uniform, or
    a (B,) tensor of per-slot lengths): slot z holds the largest p < s with
    p ≡ z (mod W), or -1 beyond the fill level."""
    w = window
    if isinstance(s, int):
        s = torch.full((batch,), s, dtype=torch.int32, device=device)
    slots = torch.arange(w, dtype=torch.int32, device=s.device)[None, :]
    sv = s.to(torch.int32)[:, None]                             # (B, 1)
    pos = sv - 1 - torch.remainder(sv - 1 - slots, w)          # (B, W)
    return torch.where((slots >= sv) & (sv <= w), -1, pos).to(torch.int32)


def ring_cache_write_prefill(
    k_layer: torch.Tensor,       # (B, W, KV, D) — updated in place
    v_layer: torch.Tensor,
    k_new: torch.Tensor,         # (B, S, KV, D) — token p at row p
    v_new: torch.Tensor,
    pos_map: torch.Tensor,       # (B, W) slot→position (-1 = empty)
) -> None:
    """Bulk write of a prefill into a ring: each slot takes the token its
    ``pos_map`` entry names; empty slots are zeroed (on DTensors, each rank
    its shard's slots)."""
    if is_dtensor(k_layer):
        return spmd.write_ring_prefill(k_layer, v_layer, k_new, v_new, pos_map)
    s = k_new.shape[1]
    rows = torch.arange(k_layer.shape[0], device=k_layer.device)[:, None]
    idx = pos_map.long().clamp(0, s - 1)
    valid = (pos_map >= 0)[..., None, None]
    for layer, new in ((k_layer, k_new), (v_layer, v_new)):
        layer.copy_(torch.where(valid, new[rows, idx], 0).to(layer.dtype))


# --------------------------------------------------------------------------- #
# Paged pool                                                                  #
# --------------------------------------------------------------------------- #
def paged_cache_init(
    n_layers: int, num_pages: int, page_size: int, kv_heads: int,
    head_dim: int, n_slots: int, max_pages_per_slot: int,
    dtype=torch.bfloat16, device="cuda",
) -> Dict[str, torch.Tensor]:
    return {
        "k": torch.zeros(
            (n_layers, kv_heads, num_pages, page_size, head_dim),
            dtype=dtype, device=device,
        ),
        "v": torch.zeros(
            (n_layers, kv_heads, num_pages, page_size, head_dim),
            dtype=dtype, device=device,
        ),
        "block_tables": torch.full(
            (n_slots, max_pages_per_slot), -1, dtype=torch.int32, device=device
        ),
        "length": torch.zeros((n_slots,), dtype=torch.int32, device=device),
    }


class RowWritePlan(NamedTuple):
    """Where one step's new K/V rows go in a layer's flattened pool, shared
    by every layer of the step: ``index`` (M,) int64 in-range row indices,
    ``pick`` (M,) the source row each index takes, ``hit`` (M,) whether any
    valid row targets that index (else the row writes back what it holds)."""

    index: torch.Tensor
    pick: torch.Tensor
    hit: torch.Tensor


def row_write_plan(index: torch.Tensor, valid: torch.Tensor) -> RowWritePlan:
    """Plan ``dst[..., index[m], :] = src[..., m, :]`` for the valid rows only.

    Every row gets an in-range index; an invalid row writes back what the
    destination row holds — unless a valid row targets the same index, in
    which case it writes that row's value. So every duplicate index carries
    one value and the scatter is deterministic, without a host round trip
    to compact the valid rows. Valid rows must target distinct indices (the
    allocator's page ownership guarantees it)."""
    same = (index[:, None] == index[None, :]) & valid[None, :]     # (M, M)
    return RowWritePlan(index, same.float().argmax(dim=1), same.any(dim=1))


def masked_row_write(
    dst: torch.Tensor,       # (..., N, D) — written in place along axis -2
    plan: RowWritePlan,
    src: torch.Tensor,       # (..., M, D)
) -> None:
    old = dst.index_select(-2, plan.index)
    vals = torch.where(plan.hit[:, None], src.index_select(-2, plan.pick), old)
    dst.index_copy_(-2, plan.index, vals)


def chunk_write_plan(
    block_tables: torch.Tensor,  # (B, MB) int32; -1 = unallocated
    starts: torch.Tensor,        # (B,) int32 — first token's absolute position
    lens: torch.Tensor,          # (B,) int32 — valid tokens per row (≤ S)
    page_size: int,
    s: int,                      # tokens per row (the chunk width)
) -> RowWritePlan:
    """Write plan of a prefill chunk: token t of row b lands at position
    starts[b] + t; tokens beyond ``lens``, on -1 pages or past the table
    are dropped."""
    bs, mb, dev = page_size, block_tables.shape[1], block_tables.device
    pos = starts.long()[:, None] + torch.arange(s, device=dev)[None, :]   # (B, S)
    blk = pos // bs
    page = torch.gather(block_tables.long(), 1, blk.clamp(0, mb - 1))
    valid = (
        (torch.arange(s, device=dev)[None, :] < lens.long()[:, None])
        & (page >= 0) & (blk < mb)
    )
    flat = torch.where(valid, page * bs + pos % bs, 0)
    return row_write_plan(flat.reshape(-1), valid.reshape(-1))


def token_write_plan(
    block_tables: torch.Tensor,  # (B, MB)
    positions: torch.Tensor,     # (B,) int32 — absolute write positions
    active: torch.Tensor,        # (B,) bool — rows allowed to write
    page_size: int,
) -> RowWritePlan:
    """Write plan of one decode token per slot. Paged pages are shared
    through the allocator, so inactive slots MUST NOT write — their row
    could alias a page now owned by another slot."""
    bs, mb = page_size, block_tables.shape[1]
    pos = positions.long()
    blk = pos // bs
    page = torch.gather(block_tables.long(), 1, blk.clamp(0, mb - 1)[:, None])[:, 0]
    valid = active & (page >= 0) & (blk < mb)
    return row_write_plan(torch.where(valid, page * bs + pos % bs, 0), valid)


def write_rows(
    k_layer: torch.Tensor,       # (KV, P, bs, D) — one layer's pool, updated in place
    v_layer: torch.Tensor,
    k_new: torch.Tensor,         # (B, S, KV, D) — rows in plan order (b, t)
    v_new: torch.Tensor,
    plan: RowWritePlan,
) -> None:
    kv, p, bs, d = k_layer.shape
    for pool, new in ((k_layer, k_new), (v_layer, v_new)):
        rows = new.to(pool.dtype).permute(2, 0, 1, 3).reshape(kv, -1, d)
        masked_row_write(pool.view(kv, p * bs, d), plan, rows)


def paged_cache_write(
    k_layer: torch.Tensor,       # (KV, P, bs, D) — one layer's pool, updated in place
    v_layer: torch.Tensor,
    k_new: torch.Tensor,         # (B, S, KV, D) — token t of row b at position
    v_new: torch.Tensor,         #                 starts[b] + t
    block_tables: torch.Tensor,  # (B, MB) int32; -1 = unallocated
    starts: torch.Tensor,        # (B,) int32 — first token's absolute position
    lens: torch.Tensor,          # (B,) int32 — valid tokens per row (≤ S)
) -> None:
    """Scatter a prefill chunk into the page pool through the block table.

    Rows may sit at different offsets (ragged chunked prefill); tokens beyond
    ``lens`` or mapping to an unallocated page are dropped, so padded batch
    rows can point at any table row without corrupting it."""
    plan = chunk_write_plan(block_tables, starts, lens, k_layer.shape[2], k_new.shape[1])
    write_rows(k_layer, v_layer, k_new, v_new, plan)


def paged_cache_write_token(
    k_layer: torch.Tensor,       # (KV, P, bs, D) — updated in place
    v_layer: torch.Tensor,
    k_new: torch.Tensor,         # (B, 1, KV, D)
    v_new: torch.Tensor,
    block_tables: torch.Tensor,  # (B, MB)
    positions: torch.Tensor,     # (B,) int32 — absolute write positions
    active: torch.Tensor,        # (B,) bool — rows allowed to write
) -> None:
    """One-token-per-slot decode write (inactive slots never write)."""
    plan = token_write_plan(block_tables, positions, active, k_layer.shape[2])
    write_rows(k_layer, v_layer, k_new, v_new, plan)


def paged_gather_kv(
    k_layer: torch.Tensor,       # (KV, P, bs, D)
    v_layer: torch.Tensor,
    block_tables: torch.Tensor,  # (B, MB)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assemble each slot's logical KV sequence, (B, MB·bs, KV, D), from the
    page pool — what the kernels do with block-table addressing. Unallocated
    pages read page 0; callers mask those positions via
    ``paged_key_positions``."""
    kv, p, bs, d = k_layer.shape
    b, mb = block_tables.shape
    idx = torch.arange(mb * bs, device=k_layer.device)
    page = block_tables.long()[:, idx // bs]                            # (B, MB·bs)
    flat = torch.where(page >= 0, page * bs + idx % bs, 0).reshape(-1)
    k_ctx = k_layer.reshape(kv, p * bs, d)[:, flat]
    v_ctx = v_layer.reshape(kv, p * bs, d)[:, flat]
    k_ctx = k_ctx.reshape(kv, b, mb * bs, d).permute(1, 2, 0, 3)
    v_ctx = v_ctx.reshape(kv, b, mb * bs, d).permute(1, 2, 0, 3)
    return k_ctx, v_ctx


def paged_key_positions(
    block_tables: torch.Tensor,  # (B, MB)
    lengths: torch.Tensor,       # (B,) — valid tokens per slot
    page_size: int,
) -> torch.Tensor:
    """(B, MB·bs) position map for gathered paged KV: index i where valid,
    -1 where past ``lengths`` or on an unallocated page."""
    b, mb = block_tables.shape
    idx = torch.arange(mb * page_size, device=block_tables.device)
    page = block_tables[:, idx // page_size]
    valid = (idx[None, :] < lengths.long()[:, None]) & (page >= 0)
    return torch.where(valid, idx[None, :], -1)
