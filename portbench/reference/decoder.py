"""Plain float32 reference of the benchmark's decoder configurations.

A pre-norm decoder-only transformer written with nothing but ``torch``
operations: no kernel, no cache, no batching, no import of the program under
test. It reads the benchmark's own weight tree (``portbench.weights``, the
same tensors the program serves) layer by layer, casting each layer's bf16
leaves to float32 as it goes, so that a 7B model fits beside its activations.

Equations (``arch`` is the ``arch`` block of a configuration file):

* block: ``h += attn(norm_attn(h)) (+ bo)``; ``h += ffn(norm_mlp(h))``;
  logits ``= norm_final(h) @ unembed``;
* norms: LayerNorm with bias, or RMSNorm ``x * rsqrt(mean(x^2) + eps) * w``;
* attention: q/k/v projections (plus biases), rotary embedding on the two
  halves of each head (``rope_theta``), causal softmax over every earlier
  position scaled by ``1/sqrt(head_dim)``, query head ``h`` reading KV head
  ``h // (n_heads / n_kv_heads)``;
* MLP: GELU (tanh form) with biases, or SwiGLU;
* MoE: a float32 softmax router, top-k experts with their probabilities
  renormalised to sum to one, SwiGLU experts. Each expert takes at most
  ``capacity = max(1, int(capacity_factor * g * k / E))`` (token, choice)
  pairs of a group of ``g`` tokens, first come first served in token order
  (a token's choices in rank order); a pair past capacity adds nothing.
  Which tokens form a group is the serving schedule's: a prompt is processed
  in chunks of ``chunk`` tokens starting at position 0, and each chunk is one
  group of ``g = chunk`` (the last chunk's padding comes after its real
  tokens, so it never takes their capacity); every generated token is fed
  alone, a group of one, whose capacity of one per expert drops nothing.

Departures from the published models that the program makes, and that this
reference therefore makes too, are listed in each configuration file under
``departures``.

``precision="fp8"`` is the control, the reference computed one precision
below bf16 as an fp8 GEMM computes: both operands of every projection
(attention, MLP or experts, unembedding) rounded to float8 e4m3 — the
weights with one scale an output channel, the activations with one scale a
token — then multiplied and summed in float32. Norms, the router (float32 in
the program), attention and softmax stay float32.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

# projection leaves whose input dimension is every dimension but the last
# (the output channel) of the per-layer slice
_MATRICES = ("wq", "wk", "wv", "wo", "w_up", "w_down", "w_gate", "unembed")


def _fp8(w: torch.Tensor, out_dims: int) -> torch.Tensor:
    """Round ``w`` (float32) to e4m3 with one scale per output channel (its
    last ``out_dims`` dimensions) and back."""
    flat = w.reshape(-1, math.prod(w.shape[w.dim() - out_dims:]))
    scale = flat.abs().amax(dim=0).clamp(min=1e-30) / 448.0
    q = (flat / scale).to(torch.float8_e4m3fn).float() * scale
    return q.reshape(w.shape)


def _rows(x: torch.Tensor, precision: str) -> torch.Tensor:
    """A projection's input: as it is, or for the control rounded to e4m3
    with one scale a token (row)."""
    if precision != "fp8":
        return x
    scale = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _leaf(x: torch.Tensor, name: str, precision: str, out_dims: int = 1) -> torch.Tensor:
    x = x.float()
    if precision == "fp8" and name in _MATRICES:
        return _fp8(x, out_dims)
    return x


def _norm(x, p, arch):
    if arch["norm_kind"] == "rmsnorm":
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + arch["norm_eps"]) * p["scale"]
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p.get("bias"), arch["norm_eps"])


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (S, heads, hd), positions 0..S-1."""
    s, _, hd = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd))
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)[:, None, :]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def _attention(q, k, v, block: int = 1024):
    """Causal attention, q (S, H, hd), k/v (S, KV, hd), in blocks of query
    rows so that the score matrix stays small."""
    s, h, hd = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)          # (H, S, hd)
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    qt = q.transpose(0, 1) / math.sqrt(hd)
    out = torch.empty_like(qt)
    keys = torch.arange(s, device=q.device)
    for a in range(0, s, block):
        b = min(s, a + block)
        scores = qt[:, a:b] @ k[:, :b].transpose(1, 2)          # (H, rows, b)
        mask = keys[None, :b] > torch.arange(a, b, device=q.device)[:, None]
        scores.masked_fill_(mask, float("-inf"))
        out[:, a:b] = torch.softmax(scores, dim=-1) @ v[:, :b]
    return out.transpose(0, 1)                                   # (S, H, hd)


def moe_groups(n_tokens: int, prompt_len: int, chunk: int) -> List[Tuple[int, int, int]]:
    """(start, end, group size) of each MoE group of a served sequence: the
    prompt's chunks, then one group a generated token."""
    groups = [(a, min(a + chunk, prompt_len), chunk) for a in range(0, prompt_len, chunk)]
    return groups + [(i, i + 1, 1) for i in range(prompt_len, n_tokens)]


def _moe(x, p, arch, groups, precision):
    e, k = arch["n_experts"], arch["experts_per_token"]
    probs = torch.softmax(x @ p["router"], dim=-1)               # (S, E)
    gate, idx = torch.topk(probs, k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    choices = idx.tolist()
    keep_rows = []
    for a, b, g in groups:
        cap = max(1, int(arch["moe_capacity_factor"] * g * k / e))
        taken = [0] * e
        for row in choices[a:b]:
            kept = []
            for ex in row:
                kept.append(taken[ex] < cap)
                taken[ex] += 1
            keep_rows.append(kept)
    keep = torch.tensor(keep_rows, dtype=torch.bool, device=x.device)
    out = torch.zeros_like(x)
    for ex in range(e):
        tok, choice = torch.nonzero((idx == ex) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = _rows(x[tok], precision)
        w_gate = _leaf(p["w_gate"][ex], "w_gate", precision)
        w_up = _leaf(p["w_up"][ex], "w_up", precision)
        w_down = _leaf(p["w_down"][ex], "w_down", precision)
        he = _rows(F.silu(xe @ w_gate) * (xe @ w_up), precision) @ w_down
        out.index_add_(0, tok, he * gate[tok, choice][:, None])
    return out


def _mlp(x, p, arch, precision):
    x = _rows(x, precision)
    if arch["mlp_kind"] == "swiglu":
        w_gate = _leaf(p["w_gate"], "w_gate", precision)
        h = F.silu(x @ w_gate) * (x @ _leaf(p["w_up"], "w_up", precision))
        return _rows(h, precision) @ _leaf(p["w_down"], "w_down", precision)
    h = x @ _leaf(p["w_up"], "w_up", precision)
    if "b_up" in p:
        h = h + p["b_up"].float()
    h = F.gelu(h, approximate="tanh")
    out = _rows(h, precision) @ _leaf(p["w_down"], "w_down", precision)
    if "b_down" in p:
        out = out + p["b_down"].float()
    return out


def _layer(blocks: Dict, l: int, precision: str) -> Dict:
    """Layer ``l``'s leaves in float32 (projections rounded for the control)."""
    def take(tree, name):
        if isinstance(tree, dict):
            return {k: take(v, k) for k, v in tree.items()}
        # wq/wk/wv (d, heads, hd) and wo (heads, hd, d): output channels are
        # (heads, hd) and d
        out_dims = 2 if name in ("wq", "wk", "wv") else 1
        if name in ("w_gate", "w_up", "w_down"):
            return tree[l]                                       # cast per expert or below
        return _leaf(tree[l], name, precision, out_dims)
    lp = take(blocks, "")
    for sub in ("norm_attn", "norm_mlp"):
        lp[sub] = {k: v.float() for k, v in lp[sub].items()}
    return lp


@torch.no_grad()
def served_logits(
    weights: Dict,
    arch: Dict,
    seqs: Sequence[Tuple[torch.Tensor, int, torch.Tensor]],
    chunk: int,
    precision: str = "float32",
) -> List[torch.Tensor]:
    """Float32 logits of each sequence at the positions asked for.

    ``seqs``: (tokens (S,) int64, prompt length, positions (n,) int64) on the
    weights' device. Every sequence advances through one layer before the
    next layer is cast, so each layer's weights are converted once. TF32 is
    switched off for the duration."""
    if precision not in ("float32", "fp8"):
        raise ValueError(f"unknown precision {precision!r}")
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _served_logits(weights, arch, seqs, chunk, precision)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _served_logits(weights, arch, seqs, chunk, precision):
    h_heads, kv_heads, hd = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
    emb = weights["embed"]["embedding"]
    hs = [emb[t].float() for t, _, _ in seqs]
    blocks = weights["blocks"]
    for l in range(arch["n_layers"]):
        lp = _layer(blocks, l, precision)
        for i, (tokens, prompt_len, _) in enumerate(seqs):
            h = hs[i]
            s = h.shape[0]
            x = _rows(_norm(h, lp["norm_attn"], arch), precision)
            q = (x @ lp["wq"].reshape(x.shape[1], -1)).view(s, h_heads, hd)
            k = (x @ lp["wk"].reshape(x.shape[1], -1)).view(s, kv_heads, hd)
            v = (x @ lp["wv"].reshape(x.shape[1], -1)).view(s, kv_heads, hd)
            if "bq" in lp:
                q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
            q, k = _rope(q, arch["rope_theta"]), _rope(k, arch["rope_theta"])
            att = _rows(_attention(q, k, v).reshape(s, -1), precision) @ lp["wo"].reshape(-1, x.shape[1])
            if "bo" in lp:
                att = att + lp["bo"]
            h = h + att
            x = _norm(h, lp["norm_mlp"], arch)
            if arch["n_experts"]:
                groups = moe_groups(s, prompt_len, chunk)
                h = h + _moe(x, lp["moe"], arch, groups, precision)
            else:
                h = h + _mlp(x, lp["mlp"], arch, precision)
            hs[i] = h
        del lp
    final = {k: v.float() for k, v in weights["norm_final"].items()}
    unembed = weights["embed"].get("unembed")
    unembed = emb.T if unembed is None else unembed
    unembed = _leaf(unembed, "unembed", precision)
    return [_rows(_norm(h[pos], final, arch), precision) @ unembed for h, (_, _, pos) in zip(hs, seqs)]
