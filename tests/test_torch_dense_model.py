"""Port parity, dense KV layout of the model: ``prefill`` on ragged prompt
lengths, then ``decode_step`` and ``decode_steps`` (K = 1, 4, 8), against the
reference on the same converted float32 weights — logits allclose 1e-4,
identical greedy tokens, caches allclose 1e-4 and lengths exact — for the
full cache of the smoke Qwen3 and for the ring cache of a sliding-window
config across ring wraps. Also: the ring's length mask equals the
reference's position mask over ``pos``, and within the port the dense and
paged layouts give the same tokens."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as RefArchConfig
from repro.models import cache as ref_cache
from repro.models.attention import attention as ref_attention
from repro.serving.sampler import greedy as ref_greedy
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.serving.sampler import greedy
from torch_port_arrays import to_np
from torch_port_helpers import port_model_and_params, ref_model_and_params

TOL = 1e-4
N_SLOTS, MAX_LEN, S = 4, 64, 32
# tests/test_fused_decode.py:126 — the sliding-window config the reference
# serves through its ring cache (W = 24 < MAX_LEN), in float32 like the rest
SWA_REF = RefArchConfig(
    name="swa", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=256, sliding_window=24, dtype="float32",
)
LENGTHS = np.array([13, 30, 21, 5], np.int32)     # 30 > 24 wraps the ring at prefill


def _models(ref_cfg=None):
    if ref_cfg is None:
        ref_model, ref_params = ref_model_and_params()
        model, params = port_model_and_params(ref_params)
    else:
        ref_model, ref_params = ref_model_and_params(ref_cfg)
        model, params = port_model_and_params(
            ref_params, ArchConfig(**dataclasses.asdict(ref_cfg))
        )
    return ref_model, ref_params, model, params


@pytest.fixture(scope="module", params=["full", "ring"])
def models(request):
    return request.param, _models(None if request.param == "full" else SWA_REF)


def _prompts():
    rng = np.random.default_rng(7)
    tok = rng.integers(1, 256, size=(N_SLOTS, S)).astype(np.int32)
    tok[np.arange(S)[None, :] >= LENGTHS[:, None]] = 0        # right padding
    return tok


def _assert_caches_close(jc, tc):
    assert jc.keys() == tc.keys()
    for key in ("k", "v"):
        np.testing.assert_allclose(to_np(tc[key]), to_np(jc[key]), rtol=TOL, atol=TOL)
    for key in ("length", "pos"):
        if key in jc:
            np.testing.assert_array_equal(to_np(tc[key]), to_np(jc[key]))


def _prefilled(models):
    ref_model, ref_params, model, params = models
    tok = _prompts()
    jc = ref_model.cache_init(N_SLOTS, MAX_LEN)
    tc = model.cache_init(N_SLOTS, MAX_LEN)
    jl, jc = jax.jit(lambda p, t, c, l: ref_model.prefill(p, t, c, lengths=l))(
        ref_params, jnp.asarray(tok), jc, jnp.asarray(LENGTHS)
    )
    tl, tc = model.prefill(params, torch.from_numpy(tok), tc, lengths=torch.from_numpy(LENGTHS))
    return jl, jc, tl, tc


def test_prefill_matches_reference(models):
    kind, m = models
    jl, jc, tl, tc = _prefilled(m)
    np.testing.assert_allclose(to_np(tl), to_np(jl), rtol=TOL, atol=TOL)
    assert (to_np(tl).argmax(-1) == to_np(jl).argmax(-1)).all()
    _assert_caches_close(jc, tc)
    assert to_np(tc["length"]).tolist() == LENGTHS.tolist()
    assert tc["k"].shape[2] == (24 if kind == "ring" else MAX_LEN)


def test_decode_step_matches_reference(models):
    _, m = models
    ref_model, ref_params, model, params = m
    _, jc, _, tc = _prefilled(m)
    tokens = np.array([3, 4, 5, 6], np.int32)
    active = np.array([True, False, True, True])             # slot 1 idle
    jl, jc = ref_model.decode_step(ref_params, jnp.asarray(tokens), jc, jnp.asarray(active))
    tl, tc = model.decode_step(params, torch.from_numpy(tokens), tc, torch.from_numpy(active))
    np.testing.assert_allclose(to_np(tl)[active], to_np(jl)[active], rtol=TOL, atol=TOL)
    _assert_caches_close(jc, tc)


@pytest.mark.parametrize("k", [1, 4, 8])
def test_decode_steps_match_reference(models, k):
    _, m = models
    ref_model, ref_params, model, params = m
    jl, jc, _, tc = _prefilled(m)
    cur = np.asarray(ref_greedy(jl)).astype(np.int32)
    active = np.array([True, True, True, False])             # slot 3 idle throughout
    budgets = np.array([8, 3, 8, 8], np.int32)               # slot 1 stops mid-horizon
    rids = np.arange(N_SLOTS, dtype=np.int32)
    idx0 = np.ones(N_SLOTS, np.int32)
    jout = ref_model.decode_steps(
        ref_params, jnp.asarray(cur), jc, num_steps=k, sampler=ref_greedy,
        active=jnp.asarray(active), budgets=jnp.asarray(budgets),
        rids=jnp.asarray(rids), token_idx0=jnp.asarray(idx0),
    )
    tout = model.decode_steps(
        params, torch.from_numpy(cur), tc, num_steps=k, sampler=greedy,
        active=torch.from_numpy(active), budgets=torch.from_numpy(budgets),
        rids=torch.from_numpy(rids), token_idx0=torch.from_numpy(idx0),
    )
    for t, j in zip(tout[:4], jout[:4]):                     # block, emitted, active, last
        np.testing.assert_array_equal(to_np(t), to_np(j))
    _assert_caches_close(jout[4], tout[4])


@pytest.mark.parametrize("fill", [5, 23, 24, 25, 40, 61])
def test_ring_length_mask_equals_reference_position_mask(fill):
    """After ``fill`` tokens (a ragged prefill, then decode writes) the ring
    holds its valid entries in slots [0, min(fill, W)), all inside the next
    query's window: the kernel's length mask over the ring gives what the
    reference's ``attention`` gives over the ``pos`` map."""
    w, window, kv, h, d = 24, 24, 2, 4, 16
    rng = np.random.default_rng(fill)
    b = 3
    pre = np.array([min(fill, 30), min(fill, 7), fill], np.int32)   # prefill part per row
    pos = ref_cache.ring_positions_prefill(b, w, jnp.asarray(pre))
    cur = pre.copy()
    while (cur < fill).any():                                       # decode part
        act = cur < fill
        # decode writes at positions pre .. fill - 1
        pos = ref_cache.ring_positions_write_token(pos, jnp.asarray(cur), jnp.asarray(act))
        cur = cur + act
    qpos = cur.copy()                                               # the new query's position
    pos = ref_cache.ring_positions_write_token(pos, jnp.asarray(qpos))
    k = rng.standard_normal((b, w, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, w, kv, d)).astype(np.float32)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    ref = ref_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_positions=jnp.asarray(qpos[:, None]),
        k_positions=pos, causal=True, window=window,
    )
    valid = np.asarray(pos) >= 0
    assert (valid == (np.arange(w)[None, :] < np.minimum(qpos + 1, w)[:, None])).all()
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    out = decode_attention(
        torch.from_numpy(q[:, 0]), tk.transpose(1, 2), tv.transpose(1, 2),
        torch.from_numpy(np.minimum(qpos + 1, w).astype(np.int32)),
    )
    np.testing.assert_allclose(to_np(out), to_np(ref)[:, 0], rtol=2e-5, atol=2e-5)


def test_dense_and_paged_layouts_give_the_same_tokens():
    """Within the port: whole-prompt prefill into the slot cache plus fused
    decode, against chunked prefill into the paged pool plus fused decode."""
    ref_model, ref_params, model, params = _models()
    tok = _prompts()
    k = 8
    args = dict(num_steps=k, sampler=greedy, active=torch.ones(N_SLOTS, dtype=torch.bool),
                budgets=torch.full((N_SLOTS,), k, dtype=torch.int32),
                rids=torch.arange(N_SLOTS, dtype=torch.int32),
                token_idx0=torch.ones(N_SLOTS, dtype=torch.int32))
    dense = model.cache_init(N_SLOTS, MAX_LEN)
    logits, dense = model.prefill(params, torch.from_numpy(tok), dense,
                                  lengths=torch.from_numpy(LENGTHS))
    first = greedy(logits)
    block_dense = model.decode_steps(params, first, dense, **args)[0]

    page, mb = 8, MAX_LEN // 8
    pool = model.paged_cache_init(N_SLOTS * mb, page, N_SLOTS, mb)
    pool["block_tables"].copy_(torch.arange(N_SLOTS * mb, dtype=torch.int32).reshape(N_SLOTS, mb))
    slots = torch.arange(N_SLOTS, dtype=torch.int32)
    for start in range(0, S, 16):
        n = np.clip(LENGTHS - start, 0, 16).astype(np.int32)
        chunk = np.zeros((N_SLOTS, 16), np.int32)
        chunk[:, : min(16, S - start)] = tok[:, start : start + 16]
        logits_p, pool = model.prefill_chunk(
            params, torch.from_numpy(chunk), pool, torch.where(torch.from_numpy(n) > 0, slots, N_SLOTS),
            torch.full((N_SLOTS,), start, dtype=torch.int32), torch.from_numpy(n),
        )
        last = (start < LENGTHS) & (LENGTHS <= start + 16)
        first_p = greedy(logits_p) if start == 0 else torch.where(torch.from_numpy(last), greedy(logits_p), first_p)
    assert torch.equal(first_p, first)
    block_paged = model.decode_steps(params, first_p, pool, **args)[0]
    assert torch.equal(block_dense, block_paged)
    assert torch.equal(dense["length"], pool["length"])


def test_sliding_window_is_dense_only():
    _, _, model, _ = _models(SWA_REF)
    with pytest.raises(NotImplementedError, match="sliding-window"):
        model.paged_cache_init(16, 8, 2, 8)
