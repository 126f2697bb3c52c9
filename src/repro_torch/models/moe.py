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
on the host, so the engine's dispatches capture the block in their CUDA
graphs.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..distributed import spmd
from ..distributed.sharding import is_dtensor
from .layers import ParamDef, mlp_activation


def moe_defs(
    n_layers: Optional[int], d_model: int, d_ff: int, n_experts: int, mlp_kind: str, dtype,
):
    lead = (n_layers,) if n_layers else ()
    lax = ("layers",) if n_layers else ()
    defs: Dict[str, ParamDef] = {
        "router": ParamDef(lead + (d_model, n_experts), torch.float32,
                           axes=lax + ("embed", "experts")),
    }
    if mlp_kind == "swiglu":
        defs["w_gate"] = ParamDef(lead + (n_experts, d_model, d_ff), dtype,
                                  axes=lax + ("experts", "embed", "mlp"))
    defs["w_up"] = ParamDef(lead + (n_experts, d_model, d_ff), dtype,
                            axes=lax + ("experts", "embed", "mlp"))
    defs["w_down"] = ParamDef(lead + (n_experts, d_ff, d_model), dtype,
                              axes=lax + ("experts", "mlp", "embed"))
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
    probs_mean: torch.Tensor   # (E,) f32 router probabilities' mean over the tokens
    first_choice_mean: torch.Tensor  # (E,) f32 share of tokens whose first choice is e


def moe_route(xg: torch.Tensor, router: Optional[torch.Tensor], n_experts: int, top_k: int,
              capacity_factor: float, logits: Optional[torch.Tensor] = None) -> Routing:
    """Route groups ``xg`` (G, g, D): a float32 softmax router (``logits``,
    or ``xg @ router``), top-k choices renormalised with max(sum, 1e-9),
    capacity max(1, int(cf x g x k / E)), and each (token, choice) pair,
    flattened token-major, ranked within its expert."""
    e, k = n_experts, top_k
    n_groups, g, _ = xg.shape
    if logits is None:
        logits = xg.float() @ router
    probs = torch.softmax(logits, dim=-1)                       # (G, g, E)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)           # (G, g, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    # load-balancing aux loss (Switch): E * sum_e f_e * mean p_e
    me = probs.mean(dim=(0, 1))
    # one_hot as a comparison: no range check of the ids on the host
    fe = (gate_idx[..., 0, None] == torch.arange(e, device=xg.device)).float().mean(dim=(0, 1))
    capacity = max(1, int(capacity_factor * g * k / e))
    flat_choice = gate_idx.reshape(n_groups, g * k)
    ranks = _ranks_within_expert(flat_choice)
    slot = flat_choice * capacity + torch.clamp(ranks, max=capacity - 1)
    return Routing(gate_vals, gate_idx, ranks < capacity, slot, capacity, e * torch.sum(me * fe),
                   me, fe)


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

    def route(xg, router, logits=None):
        # scatter the kept choices into per-expert capacity buffers; a dropped
        # choice adds zeros at slot C - 1 (kept slots are distinct, so every
        # sum is one value plus zeros: exact in any order)
        # (on a mesh ``d`` is the rank's slice of the model width)
        n_groups, d = xg.shape[0], xg.shape[-1]
        r = moe_route(xg, router, e, k, capacity_factor, logits)
        xk = xg[:, :, None].expand(n_groups, g, k, d).reshape(n_groups, g * k, d)  # (G, T, D)
        contrib = torch.where(r.within[..., None], xk, 0).to(x.dtype)
        expert_in = torch.zeros((n_groups, e * r.capacity, d), dtype=x.dtype, device=xg.device)
        expert_in.scatter_add_(1, r.slot[..., None].expand(-1, -1, d), contrib)
        return r, expert_in

    def experts(expert_in, w, bmm=None):
        # (G, E, C, D) → one batched product over the experts of ``w``
        # (``bmm(x, name)``: on a mesh, a product with the weights left
        # where they lie)
        bmm = bmm or (lambda t, k: torch.bmm(t, w[k]))
        n_groups, ne, d = expert_in.shape[0], w["w_up"].shape[0], expert_in.shape[-1]
        cap = expert_in.shape[1] // ne
        ein = expert_in.view(n_groups, ne, cap, d).transpose(0, 1).reshape(ne, n_groups * cap, d)
        if mlp_kind == "swiglu":
            gate_h = bmm(ein, "w_gate")
            up_h = bmm(ein, "w_up")
            h = torch.nn.functional.silu(gate_h.float()).to(x.dtype) * up_h
        else:
            h = mlp_activation(bmm(ein, "w_up"), mlp_kind, x.dtype)
        out = bmm(h, "w_down")                                    # (E, G*C, D)
        d = out.shape[-1]
        return out.view(ne, n_groups, cap, d).transpose(0, 1).reshape(n_groups, ne * cap, d)

    def combine(r, expert_out, reduce=lambda t: t):
        # gather each choice's expert output (``reduce``d: on a mesh, summed
        # over the ranks that hold a part of it), weight it by its gate, sum
        # over k
        n_groups, d = expert_out.shape[0], expert_out.shape[-1]
        out_k = reduce(torch.gather(expert_out, 1, r.slot[..., None].expand(-1, -1, d))).float()
        out_k = out_k * (r.gate_vals.reshape(n_groups, g * k) * r.within)[..., None]
        return out_k.view(n_groups, g, k, d).sum(dim=2).to(x.dtype)

    if is_dtensor(x):
        return spmd.moe(x, p, route=route, experts=experts, combine=combine, group=g)
    r, expert_in = route(x.reshape(b * (s // g), g, d), p["router"])
    return combine(r, experts(expert_in, p)).reshape(b, s, d), r.aux_loss
