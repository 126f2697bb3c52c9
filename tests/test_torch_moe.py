"""Port parity, MoE block: ``moe_apply`` and the ranks within an expert against
the reference's (``repro.models.moe``) on the same float32 inputs and
weights (outputs allclose 1e-5), at the shapes the serving paths pass —
decode lanes ``(B, 1, D)`` (groups of one token), chunk rows ``(R, C, D)``
with padding rows, a bucketed prefill (groups of ``group_size``, and the whole
row where the row is not a multiple of it) — for SwiGLU, squared-ReLU and GELU
experts, and at a capacity factor low enough that choices drop: the same
(token, choice) pairs drop on both sides. A choice that differs between the
two routers (a near-tie in top-k) is reported, not hidden."""
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as ref_moe
from repro_torch.models import moe
from torch_port_arrays import to_np

TOL = 1e-5


def _weights(rng, d, f, e, kind):
    w = {"router": rng.standard_normal((d, e)) / np.sqrt(d),
         "w_up": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "w_down": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    if kind == "swiglu":
        w["w_gate"] = rng.standard_normal((e, d, f)) / np.sqrt(d)
    return {n: v.astype(np.float32) for n, v in w.items()}


def _ref_routing(xg, router, e, k, cf):
    """The reference's routing steps (``moe_apply``'s own lines) on groups
    ``xg`` (G, g, D): (top-k ids, kept mask) as numpy."""

    @jax.jit
    def route(xg, router):
        probs = jax.nn.softmax(jnp.einsum("Ggd,de->Gge", xg, router), axis=-1)
        _, idx = jax.lax.top_k(probs, k)
        flat = idx.reshape(idx.shape[0], -1)
        return idx, jax.vmap(lambda fc: ref_moe._ranks_within_expert(fc, e))(flat)

    idx, ranks = route(jnp.asarray(xg), jnp.asarray(router))
    return np.asarray(idx), np.asarray(ranks) < max(1, int(cf * xg.shape[1] * k / e))


CASES = [
    # (name, x shape (B, S, D), E, k, capacity factor, group size, mlp kind, pad rows)
    ("decode lanes, olmoe ratio", (8, 1, 32), 64, 8, 1.25, 512, "swiglu", 0),
    ("decode lanes, smoke", (4, 1, 32), 8, 2, 2.0, 512, "swiglu", 0),
    ("chunk rows with pad rows", (4, 16, 32), 8, 2, 2.0, 512, "swiglu", 2),
    ("bucketed prefill, groups of 16", (2, 64, 32), 8, 2, 1.25, 16, "swiglu", 0),
    ("row not a multiple of the group", (3, 24, 32), 4, 2, 1.25, 16, "squared_relu", 1),
    ("gelu experts", (2, 32, 32), 8, 2, 1.25, 256, "gelu", 0),
    ("drops at capacity factor 0.5", (4, 32, 32), 8, 2, 0.5, 512, "swiglu", 1),
]


@pytest.mark.parametrize("name,shape,e,k,cf,gs,kind,pads", CASES, ids=[c[0] for c in CASES])
def test_moe_apply_matches_reference(name, shape, e, k, cf, gs, kind, pads):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    b, s, d = shape
    x = rng.standard_normal(shape).astype(np.float32)
    if pads:
        x[-pads:] = x[-1]                     # pad rows: one token's embedding, repeated
    w = _weights(rng, d, 48, e, kind)
    kw = dict(n_experts=e, top_k=k, mlp_kind=kind, capacity_factor=cf, group_size=gs)
    ref_out, ref_aux = jax.jit(functools.partial(ref_moe.moe_apply, **kw))(
        jnp.asarray(x), {n: jnp.asarray(v) for n, v in w.items()})
    out, aux = moe.moe_apply(torch.from_numpy(x), {n: torch.from_numpy(v) for n, v in w.items()},
                             **kw)

    g = min(gs, s)
    g = g if s % g == 0 else s
    xg = x.reshape(-1, g, d)
    r = moe.moe_route(torch.from_numpy(xg), torch.from_numpy(w["router"]), e, k, cf)
    ref_idx, ref_within = _ref_routing(xg, w["router"], e, k, cf)
    differ = np.argwhere(to_np(r.gate_idx) != ref_idx)
    assert differ.size == 0, f"top-k choices differ at (group, token, choice) {differ.tolist()}"
    np.testing.assert_array_equal(to_np(r.within), ref_within)
    if cf < 1:
        assert not ref_within.all(), "the low capacity factor dropped no choice"
    np.testing.assert_allclose(to_np(out), np.asarray(ref_out), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=TOL, atol=TOL)


def test_moe_apply_bf16_matches_reference():
    """bf16 activations and experts, the float32 router: within bf16's 2e-2."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 16, 32)).astype(np.float32)
    w = _weights(rng, 32, 48, 8, "swiglu")
    kw = dict(n_experts=8, top_k=2, mlp_kind="swiglu", capacity_factor=1.25, group_size=512)
    bf = lambda a, n: jnp.asarray(a) if n == "router" else jnp.asarray(a, jnp.bfloat16)
    ref_out, _ = jax.jit(functools.partial(ref_moe.moe_apply, **kw))(
        jnp.asarray(x, jnp.bfloat16), {n: bf(v, n) for n, v in w.items()})
    tb = lambda a, n: torch.from_numpy(a) if n == "router" else torch.from_numpy(a).bfloat16()
    out, _ = moe.moe_apply(torch.from_numpy(x).bfloat16(), {n: tb(v, n) for n, v in w.items()}, **kw)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(to_np(out.float()), np.asarray(ref_out.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("t,e", [(1, 8), (16, 4), (64, 8), (512, 64)])
def test_ranks_within_expert_match_reference(t, e):
    rng = np.random.default_rng(t + e)
    flat = rng.integers(0, e, size=(3, t)).astype(np.int32)
    ref = np.stack([np.asarray(ref_moe._ranks_within_expert(jnp.asarray(row), e)) for row in flat])
    out = to_np(moe._ranks_within_expert(torch.from_numpy(flat).long()))
    np.testing.assert_array_equal(out, ref)
    # a rank counts the earlier same-expert elements of the row
    for row, ranks in zip(flat, out):
        assert [int((row[:i] == row[i]).sum()) for i in range(t)] == ranks.tolist()
