"""Mixture-of-Experts block with sort-based scatter dispatch (counterpart of
``repro.models.moe``).

Top-k routing with grouped scatter dispatch, as in the reference: within each
group (a chunk of a row's sequence) the (token, choice) pairs are ranked
within their chosen expert by a stable argsort (token order has priority),
scattered into a per-expert capacity buffer ``(G, E, C, D)``, run through the
expert FFNs as one batched product and gathered back with their gate
weights. Choices past an expert's capacity drop to the residual path.

The shapes decide which choices drop: a group is ``min(group_size, S)``
tokens of one row (the whole row when S is not a multiple of it), so callers
pass exactly the tensors the reference passes (decode lanes as ``(B, 1, D)``,
chunk rows as ``(R, C, D)``, a prefill bucket whole, padding rows included).

The reference computes the dispatch and the expert products outside any
Pallas kernel, so they stay plain torch here. Nothing reads a device value
on the host.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from .layers import ParamDef, mlp_activation


def moe_defs(
    n_layers: Optional[int], d_model: int, d_ff: int, n_experts: int, mlp_kind: str, dtype,
):
    lead = (n_layers,) if n_layers else ()
    defs: Dict[str, ParamDef] = {
        "router": ParamDef(lead + (d_model, n_experts), torch.float32),
    }
    if mlp_kind == "swiglu":
        defs["w_gate"] = ParamDef(lead + (n_experts, d_model, d_ff), dtype)
    defs["w_up"] = ParamDef(lead + (n_experts, d_model, d_ff), dtype)
    defs["w_down"] = ParamDef(lead + (n_experts, d_ff, d_model), dtype)
    return defs


def _ranks_within_expert(flat_choice: torch.Tensor) -> torch.Tensor:
    """flat_choice: (..., T) expert ids. Each element's rank among the
    same-expert elements of its row (stable: token order has priority)."""
    t = flat_choice.shape[-1]
    order = torch.argsort(flat_choice, dim=-1, stable=True)
    sorted_e = torch.gather(flat_choice, -1, order)
    idx = torch.arange(t, dtype=torch.int64, device=flat_choice.device).expand_as(order)
    is_new = torch.ones_like(sorted_e, dtype=torch.bool)
    is_new[..., 1:] = sorted_e[..., 1:] != sorted_e[..., :-1]
    seg_start = torch.cummax(torch.where(is_new, idx, 0), dim=-1).values
    return torch.zeros_like(order).scatter_(-1, order, idx - seg_start)


class Routing(NamedTuple):
    gate_vals: torch.Tensor    # (G, g, k) f32, renormalised over the k choices
    gate_idx: torch.Tensor     # (G, g, k) expert ids
    within: torch.Tensor       # (G, g * k) bool: the choice fits its expert's capacity
    slot: torch.Tensor         # (G, g * k) its row in the (E x C) buffer (C - 1 if dropped)
    capacity: int
    aux_loss: torch.Tensor     # () f32 load-balancing loss


def moe_route(xg: torch.Tensor, router: torch.Tensor, n_experts: int, top_k: int,
              capacity_factor: float) -> Routing:
    """Route groups ``xg`` (G, g, D): a float32 softmax router, top-k choices
    renormalised with max(sum, 1e-9), capacity max(1, int(cf x g x k / E)),
    and each (token, choice) pair, flattened token-major, ranked within its
    expert."""
    e, k = n_experts, top_k
    n_groups, g, _ = xg.shape
    probs = torch.softmax(xg.float() @ router, dim=-1)          # (G, g, E)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)           # (G, g, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    # load-balancing aux loss (Switch): E * sum_e f_e * mean p_e
    me = probs.mean(dim=(0, 1))
    fe = torch.nn.functional.one_hot(gate_idx[..., 0], e).float().mean(dim=(0, 1))
    capacity = max(1, int(capacity_factor * g * k / e))
    flat_choice = gate_idx.reshape(n_groups, g * k)
    ranks = _ranks_within_expert(flat_choice)
    slot = flat_choice * capacity + torch.clamp(ranks, max=capacity - 1)
    return Routing(gate_vals, gate_idx, ranks < capacity, slot, capacity, e * torch.sum(me * fe))


def moe_apply(
    x: torch.Tensor,                 # (B, S, D)
    p: Dict[str, torch.Tensor],
    *,
    n_experts: int,
    top_k: int,
    mlp_kind: str,
    capacity_factor: float = 1.25,
    group_size: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, D) in x's dtype, aux load-balancing loss)."""
    b, s, d = x.shape
    e, k = n_experts, top_k
    g = min(group_size, s)
    if s % g != 0:
        g = s
    n_groups = b * (s // g)
    xg = x.reshape(n_groups, g, d)                               # (G, g, D)
    r = moe_route(xg, p["router"], e, k, capacity_factor)
    cap = r.capacity

    # scatter the kept choices into per-expert capacity buffers; a dropped
    # choice adds zeros at slot C - 1 (kept slots are distinct, so every sum
    # is one value plus zeros: exact in any order)
    xk = xg.repeat_interleave(k, dim=1)                          # (G, T, D)
    contrib = torch.where(r.within[..., None], xk, 0).to(x.dtype)
    expert_in = torch.zeros((n_groups, e * cap, d), dtype=x.dtype, device=x.device)
    expert_in.scatter_add_(1, r.slot[..., None].expand(-1, -1, d), contrib)
    # (G, E, C, D) → one batched product over the experts
    expert_in = expert_in.view(n_groups, e, cap, d).transpose(0, 1).reshape(e, n_groups * cap, d)
    if mlp_kind == "swiglu":
        gate_h = torch.bmm(expert_in, p["w_gate"])
        up_h = torch.bmm(expert_in, p["w_up"])
        h = torch.nn.functional.silu(gate_h.float()).to(x.dtype) * up_h
    else:
        h = mlp_activation(torch.bmm(expert_in, p["w_up"]), mlp_kind, x.dtype)
    expert_out = torch.bmm(h, p["w_down"])                       # (E, G*C, D)
    expert_out = expert_out.view(e, n_groups, cap, d).transpose(0, 1).reshape(n_groups, e * cap, d)

    # gather each choice's expert output, weight it by its gate, sum over k
    out_k = torch.gather(expert_out, 1, r.slot[..., None].expand(-1, -1, d)).float()
    out_k = out_k * (r.gate_vals.reshape(n_groups, g * k) * r.within)[..., None]
    out = out_k.view(n_groups, g, k, d).sum(dim=2)
    return out.reshape(b, s, d).to(x.dtype), r.aux_loss
