"""Port parity, dense KV layout, for every decoder the reference's
TransformerLM serves beside Qwen3 (the smoke Granite-3-8B, LLaMA-65B,
StarCoder2-7B, Nemotron-4-15B, OLMoE-1B-7B, Mixtral-8x22B and Qwen2-VL-7B):
``prefill`` on ragged prompts, one ``decode_step`` with an idle slot, then
``decode_steps`` (K = 4) with a budget that stops a slot mid-horizon, against
the reference on the same float32 weights, every leaf perturbed off its init
— logits allclose 1e-4 on live rows, identical greedy tokens, caches allclose
1e-4 and lengths / ring positions exact. Mixtral's window of 8 wraps its
ring in the prefill and again in the decode. The reference runs are computed
once per arch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.sampler import greedy as ref_greedy
from repro_torch.serving.sampler import greedy
from torch_port_arrays import to_np
from torch_port_helpers import FAMILY_ARCHS, family_models

TOL = 1e-4
N_SLOTS, MAX_LEN, S, K = 4, 64, 32, 4
LENGTHS = np.array([30, 17, 5, 24], np.int32)


def _snapshot(cache):
    return {k: to_np(v).copy() for k, v in cache.items()}


@pytest.fixture(scope="module", params=FAMILY_ARCHS)
def runs(request):
    ref_model, ref_params, model, params = family_models(request.param)
    rng = np.random.default_rng(7)
    tok = rng.integers(1, 256, size=(N_SLOTS, S)).astype(np.int32)
    tok[np.arange(S)[None, :] >= LENGTHS[:, None]] = 0
    out = {"arch": request.param, "window": model.cfg.sliding_window}

    jc = ref_model.cache_init(N_SLOTS, MAX_LEN)
    jl, jc = jax.jit(lambda p, t, c, l: ref_model.prefill(p, t, c, lengths=l))(
        ref_params, jnp.asarray(tok), jc, jnp.asarray(LENGTHS))
    tc = model.cache_init(N_SLOTS, MAX_LEN)
    tl, tc = model.prefill(params, torch.from_numpy(tok), tc, lengths=torch.from_numpy(LENGTHS))
    out["prefill"] = (to_np(jl), to_np(tl), _snapshot(jc), _snapshot(tc))

    tokens = np.asarray(ref_greedy(jl)).astype(np.int32)
    active = np.array([True, False, True, True])             # slot 1 idle
    jl, jc = jax.jit(ref_model.decode_step)(ref_params, jnp.asarray(tokens), jc, jnp.asarray(active))
    tl, tc = model.decode_step(params, torch.from_numpy(tokens), tc, torch.from_numpy(active))
    out["step"] = (to_np(jl), to_np(tl), _snapshot(jc), _snapshot(tc), active)

    cur = np.asarray(ref_greedy(jl)).astype(np.int32)
    args = dict(active=np.array([True, True, True, False]),    # slot 3 idle throughout
                budgets=np.array([K, 2, K, K], np.int32),      # slot 1 stops mid-horizon
                rids=np.arange(N_SLOTS, dtype=np.int32), token_idx0=np.ones(N_SLOTS, np.int32))
    jout = ref_model.decode_steps(ref_params, jnp.asarray(cur), jc, num_steps=K, sampler=ref_greedy,
                                  **{k: jnp.asarray(v) for k, v in args.items()})
    tout = model.decode_steps(params, torch.from_numpy(cur), tc, num_steps=K, sampler=greedy,
                              **{k: torch.from_numpy(v) for k, v in args.items()})
    out["steps"] = ([to_np(x) for x in jout[:4]], [to_np(x) for x in tout[:4]],
                    _snapshot(jout[4]), _snapshot(tout[4]))
    return out


def _assert_caches_close(jc, tc):
    assert jc.keys() == tc.keys()
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key], jc[key], rtol=TOL, atol=TOL)
    for key in ("length", "pos"):
        if key in jc:
            np.testing.assert_array_equal(tc[key], jc[key])


def test_prefill_matches_reference(runs):
    jl, tl, jc, tc = runs["prefill"]
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    assert (tl.argmax(-1) == jl.argmax(-1)).all()
    _assert_caches_close(jc, tc)
    assert tc["length"].tolist() == LENGTHS.tolist()
    if runs["window"]:
        # the ring of W = 8 < MAX_LEN wrapped for the prompts longer than 8
        assert tc["k"].shape[2] == runs["window"] == 8
        assert (tc["pos"].max(axis=1) == LENGTHS - 1).all()


def test_decode_step_matches_reference(runs):
    jl, tl, jc, tc, active = runs["step"]
    np.testing.assert_allclose(tl[active], jl[active], rtol=TOL, atol=TOL)
    assert (tl[active].argmax(-1) == jl[active].argmax(-1)).all()
    _assert_caches_close(jc, tc)


def test_decode_steps_match_reference(runs):
    jout, tout, jc, tc = runs["steps"]
    for t, j in zip(tout, jout):                 # block, emitted, active, last
        np.testing.assert_array_equal(t, j)
    _assert_caches_close(jc, tc)
    assert tout[1].tolist() == [K, 2, K, 0]
