"""Port parity, model: ``prefill_chunk``, ``mixed_step`` and ``decode_steps`` of
the port against the reference on the same converted float32 weights and the
same pool state — logits allclose 1e-4 on live rows, identical greedy
tokens, pools allclose 1e-4 and lengths exact — and, within the port, a
mixed round against the chunk round followed by the decode round."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.sampler import greedy as ref_greedy
from repro_torch.serving.sampler import GreedySampler, greedy
from torch_port_arrays import to_np
from torch_port_helpers import port_model_and_params, ref_model_and_params

TOL = 1e-4
N_SLOTS, PAGE, MAX_LEN, C = 4, 8, 64, 16
MB = MAX_LEN // PAGE
N_PAGES = N_SLOTS * MB


class _Capture:
    """Greedy sampler that keeps the logits it was handed (host side)."""

    stochastic = False

    def __init__(self, inner):
        self.inner, self.logits = inner, []

    def __call__(self, logits, keys=None):
        self.logits.append(to_np(logits))
        return self.inner(logits)


@pytest.fixture(scope="module")
def models():
    ref_model, ref_params = ref_model_and_params()
    model, params = port_model_and_params(ref_params)
    return ref_model, ref_params, model, params


def _tables():
    rng = np.random.default_rng(0)
    return rng.permutation(N_PAGES).astype(np.int32).reshape(N_SLOTS, MB)


def _pools(ref_model, model):
    tables = _tables()
    jc = ref_model.paged_cache_init(N_PAGES, PAGE, N_SLOTS, MB)
    jc["block_tables"] = jnp.asarray(tables)
    tc = model.paged_cache_init(N_PAGES, PAGE, N_SLOTS, MB)
    tc["block_tables"].copy_(torch.from_numpy(tables))
    return jc, tc


def _assert_pools_close(jc, tc):
    np.testing.assert_allclose(to_np(tc["k"]), to_np(jc["k"]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(to_np(tc["v"]), to_np(jc["v"]), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(to_np(tc["length"]), to_np(jc["length"]))


def _prompts():
    rng = np.random.default_rng(1)
    return {s: rng.integers(1, 256, size=n).astype(np.int32) for s, n in
            {0: 13, 1: 16, 2: 21, 3: 10}.items()}


def _chunk_batch(rows):
    """rows: [(slot, prompt, start, n)] → padded (R, C) arrays (pad slot =
    N_SLOTS), R bucketed to 4 as the engine does."""
    r = 4
    tok = np.zeros((r, C), np.int32)
    slots = np.full(r, N_SLOTS, np.int32)
    starts = np.zeros(r, np.int32)
    lens = np.zeros(r, np.int32)
    for i, (slot, prompt, start, n) in enumerate(rows):
        tok[i, :n] = prompt[start : start + n]
        slots[i], starts[i], lens[i] = slot, start, n
    return tok, slots, starts, lens


def _run_prefill(ref_model, ref_params, model, params, jc, tc, rows):
    arrays = _chunk_batch(rows)
    jl, jc = ref_model.prefill_chunk(ref_params, *[jnp.asarray(a) for a in arrays[:1]], jc,
                                     *[jnp.asarray(a) for a in arrays[1:]])
    tl, tc = model.prefill_chunk(params, torch.from_numpy(arrays[0]), tc,
                                 *[torch.from_numpy(a) for a in arrays[1:]])
    return arrays, jl, jc, tl, tc


def _mixed_inputs(prompts):
    """Decode lanes 0 and 1 active; chunk rows continue slot 2 and start
    slot 3; one pad row."""
    chunk = _chunk_batch([(2, prompts[2], 16, 5), (3, prompts[3], 0, 10)])
    dec_tokens = np.array([7, 11, 0, 0], np.int32)
    dec_active = np.array([True, True, False, False])
    r = chunk[0].shape[0]
    sample_rows = np.concatenate([dec_active, chunk[3] > 0])
    rids = np.arange(N_SLOTS + r, dtype=np.int32)
    token_idx = np.zeros(N_SLOTS + r, np.int32)
    return chunk, dec_tokens, dec_active, sample_rows, rids, token_idx


def _state_after_prefill(models):
    ref_model, ref_params, model, params = models
    jc, tc = _pools(ref_model, model)
    prompts = _prompts()
    rows = [(0, prompts[0], 0, 13), (1, prompts[1], 0, 16), (2, prompts[2], 0, 16)]
    arrays, jl, jc, tl, tc = _run_prefill(ref_model, ref_params, model, params, jc, tc, rows)
    return prompts, arrays, jl, jc, tl, tc


def _mixed(models, jc, tc, prompts, ref_sampler=ref_greedy, sampler=greedy):
    ref_model, ref_params, model, params = models
    chunk, dec_tokens, dec_active, sample_rows, rids, token_idx = _mixed_inputs(prompts)
    js, jc = ref_model.mixed_step(
        ref_params, jnp.asarray(dec_tokens), jc, *[jnp.asarray(a) for a in chunk],
        sampler=ref_sampler, dec_active=jnp.asarray(dec_active), rids=jnp.asarray(rids),
        token_idx=jnp.asarray(token_idx), sample_rows=jnp.asarray(sample_rows),
    )
    ts, tc = model.mixed_step(
        params, torch.from_numpy(dec_tokens), tc, *[torch.from_numpy(a) for a in chunk],
        sampler=sampler, dec_active=torch.from_numpy(dec_active), rids=torch.from_numpy(rids),
        token_idx=torch.from_numpy(token_idx), sample_rows=torch.from_numpy(sample_rows),
    )
    return sample_rows, js, jc, ts, tc


def test_prefill_chunk_matches_reference(models):
    prompts, (tok, slots, starts, lens), jl, jc, tl, tc = _state_after_prefill(models)
    live = lens > 0
    np.testing.assert_allclose(to_np(tl)[live], to_np(jl)[live], rtol=TOL, atol=TOL)
    assert (to_np(tl)[live].argmax(-1) == to_np(jl)[live].argmax(-1)).all()
    _assert_pools_close(jc, tc)
    assert to_np(tc["length"]).tolist() == [13, 16, 16, 0]


def test_mixed_step_matches_reference(models):
    prompts, _, _, jc, _, tc = _state_after_prefill(models)
    ref_cap, cap = _Capture(ref_greedy), _Capture(greedy)
    sample_rows, js, jc, ts, tc = _mixed(models, jc, tc, prompts, ref_cap, cap)
    np.testing.assert_allclose(
        cap.logits[0][sample_rows], ref_cap.logits[0][sample_rows], rtol=TOL, atol=TOL
    )
    np.testing.assert_array_equal(to_np(ts), to_np(js))
    assert (to_np(ts)[~sample_rows] == -1).all()
    _assert_pools_close(jc, tc)
    assert to_np(tc["length"]).tolist() == [14, 17, 21, 10]


@pytest.mark.parametrize("k", [1, 4])
def test_decode_steps_match_reference(models, k):
    ref_model, ref_params, model, params = models
    prompts, _, _, jc, _, tc = _state_after_prefill(models)
    _, js, jc, ts, tc = _mixed(models, jc, tc, prompts)
    cur = to_np(ts)[:N_SLOTS].copy()
    cur[2:] = to_np(ts)[N_SLOTS : N_SLOTS + 2]          # the chunk rows' first tokens
    active = np.array([True, True, True, True])
    budgets = np.array([4, 2, 4, 3], np.int32)
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
    for t, j in zip(tout[:4], jout[:4]):                 # block, emitted, active, last
        np.testing.assert_array_equal(to_np(t), to_np(j))
    _assert_pools_close(jout[4], tout[4])


def test_decode_step_logits_match_reference(models):
    ref_model, ref_params, model, params = models
    prompts, _, _, jc, _, tc = _state_after_prefill(models)
    tokens = np.array([3, 4, 5, 6], np.int32)
    active = np.array([True, False, True, False])   # slot 1 idle, slot 3 empty
    jl, jc = ref_model.decode_step(ref_params, jnp.asarray(tokens), jc, jnp.asarray(active))
    tl, tc = model.decode_step(params, torch.from_numpy(tokens), tc, torch.from_numpy(active))
    np.testing.assert_allclose(to_np(tl)[active], to_np(jl)[active], rtol=TOL, atol=TOL)
    _assert_pools_close(jc, tc)


def test_mixed_step_equals_chunk_round_then_decode_round(models):
    """Within the port: one mixed round gives the tokens (and pool) of the
    chunk round followed by the decode round, as its docstring claims."""
    ref_model, ref_params, model, params = models
    prompts, _, _, _, _, tc = _state_after_prefill(models)
    split = {k: v.clone() for k, v in tc.items()}
    chunk, dec_tokens, dec_active, sample_rows, rids, token_idx = _mixed_inputs(prompts)
    fused, tc = model.mixed_step(
        params, torch.from_numpy(dec_tokens), tc, *[torch.from_numpy(a) for a in chunk],
        sampler=greedy, dec_active=torch.from_numpy(dec_active), rids=torch.from_numpy(rids),
        token_idx=torch.from_numpy(token_idx), sample_rows=torch.from_numpy(sample_rows),
    )
    logits, split = model.prefill_chunk(
        params, torch.from_numpy(chunk[0]), split, *[torch.from_numpy(a) for a in chunk[1:]]
    )
    first = GreedySampler()(logits)
    # the decode round sees the chunk slots as inactive lanes
    dl, split = model.decode_step(
        params, torch.from_numpy(dec_tokens), split, torch.from_numpy(dec_active)
    )
    dec = greedy(dl)
    fused = to_np(fused)
    np.testing.assert_array_equal(fused[:N_SLOTS][dec_active], to_np(dec)[dec_active])
    live = chunk[3] > 0
    np.testing.assert_array_equal(fused[N_SLOTS:][live], to_np(first)[live])
    for key in ("k", "v"):
        torch.testing.assert_close(tc[key], split[key], rtol=1e-5, atol=1e-5)
    assert torch.equal(tc["length"], split["length"])
