"""Port parity, paged KV layout, for the decoders of ``test_torch_family_dense``
that the reference's paged layout takes (all but Mixtral-8x22B, whose
sliding window it refuses there, as the port does): ``prefill_chunk`` (three
rows and a pad row), ``mixed_step`` (two decode lanes, two chunk rows — one
continuing a prompt, one starting one — and a pad row), then
``decode_steps`` (K = 4), against the reference on the same pool state and
the same float32 weights, every leaf perturbed off its init — logits
allclose 1e-4 on live rows, identical greedy tokens, pools allclose 1e-4 and
lengths exact. For the MoE configs the decode lanes route as groups of one
token and the chunk rows as groups of their chunk, padding included, as in
the reference."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.sampler import greedy as ref_greedy
from repro_torch.serving.sampler import greedy
from torch_port_arrays import to_np
from torch_port_helpers import PAGED_FAMILY_ARCHS, family_models

TOL = 1e-4
N_SLOTS, PAGE, MAX_LEN, C, K = 4, 8, 64, 16, 4
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


def _chunk_batch(prompts, rows):
    """rows: [(slot, start, n)] → (R = 4, C) arrays, pad slot = N_SLOTS."""
    tok = np.zeros((4, C), np.int32)
    slots = np.full(4, N_SLOTS, np.int32)
    starts = np.zeros(4, np.int32)
    lens = np.zeros(4, np.int32)
    for i, (slot, start, n) in enumerate(rows):
        tok[i, :n] = prompts[slot][start:start + n]
        slots[i], starts[i], lens[i] = slot, start, n
    return tok, slots, starts, lens


def _snapshot(cache):
    return {k: to_np(v).copy() for k, v in cache.items() if k != "block_tables"}


@pytest.fixture(scope="module", params=PAGED_FAMILY_ARCHS)
def runs(request):
    ref_model, ref_params, model, params = family_models(request.param)
    tables = np.random.default_rng(0).permutation(N_PAGES).astype(np.int32).reshape(N_SLOTS, MB)
    jc = ref_model.paged_cache_init(N_PAGES, PAGE, N_SLOTS, MB)
    jc["block_tables"] = jnp.asarray(tables)
    tc = model.paged_cache_init(N_PAGES, PAGE, N_SLOTS, MB)
    tc["block_tables"].copy_(torch.from_numpy(tables))
    rng = np.random.default_rng(1)
    prompts = {s: rng.integers(1, 256, size=n).astype(np.int32)
               for s, n in {0: 13, 1: 16, 2: 21, 3: 10}.items()}
    j = lambda xs: [jnp.asarray(x) for x in xs]
    t = lambda xs: [torch.from_numpy(x) for x in xs]
    out = {}

    batch = _chunk_batch(prompts, [(0, 0, 13), (1, 0, 16), (2, 0, 16)])
    jl, jc = ref_model.prefill_chunk(ref_params, *j(batch[:1]), jc, *j(batch[1:]))
    tl, tc = model.prefill_chunk(params, *t(batch[:1]), tc, *t(batch[1:]))
    out["prefill"] = (to_np(jl), to_np(tl), _snapshot(jc), _snapshot(tc), batch[3] > 0)

    chunk = _chunk_batch(prompts, [(2, 16, 5), (3, 0, 10)])
    dec_tokens = np.array([7, 11, 0, 0], np.int32)
    dec_active = np.array([True, True, False, False])
    sample_rows = np.concatenate([dec_active, chunk[3] > 0])
    rest = (dec_active, np.arange(N_SLOTS + 4, dtype=np.int32), np.zeros(N_SLOTS + 4, np.int32),
            sample_rows)
    names = ("dec_active", "rids", "token_idx", "sample_rows")
    ref_cap, cap = _Capture(ref_greedy), _Capture(greedy)
    js, jc = ref_model.mixed_step(ref_params, jnp.asarray(dec_tokens), jc, *j(chunk),
                                  sampler=ref_cap, **dict(zip(names, j(rest))))
    ts, tc = model.mixed_step(params, torch.from_numpy(dec_tokens), tc, *t(chunk),
                              sampler=cap, **dict(zip(names, t(rest))))
    out["mixed"] = (ref_cap.logits[0], cap.logits[0], to_np(js), to_np(ts),
                    _snapshot(jc), _snapshot(tc), sample_rows)

    cur = to_np(ts)[:N_SLOTS].copy()
    cur[2:] = to_np(ts)[N_SLOTS:N_SLOTS + 2]            # the chunk rows' first tokens
    args = dict(active=np.ones(N_SLOTS, bool), budgets=np.array([K, 2, K, 3], np.int32),
                rids=np.arange(N_SLOTS, dtype=np.int32), token_idx0=np.ones(N_SLOTS, np.int32))
    jout = ref_model.decode_steps(ref_params, jnp.asarray(cur), jc, num_steps=K, sampler=ref_greedy,
                                  **{k: jnp.asarray(v) for k, v in args.items()})
    tout = model.decode_steps(params, torch.from_numpy(cur), tc, num_steps=K, sampler=greedy,
                              **{k: torch.from_numpy(v) for k, v in args.items()})
    out["steps"] = ([to_np(x) for x in jout[:4]], [to_np(x) for x in tout[:4]],
                    _snapshot(jout[4]), _snapshot(tout[4]))
    return out


def _assert_pools_close(jc, tc):
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key], jc[key], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tc["length"], jc["length"])


def test_prefill_chunk_matches_reference(runs):
    jl, tl, jc, tc, live = runs["prefill"]
    np.testing.assert_allclose(tl[live], jl[live], rtol=TOL, atol=TOL)
    assert (tl[live].argmax(-1) == jl[live].argmax(-1)).all()
    _assert_pools_close(jc, tc)
    assert tc["length"].tolist() == [13, 16, 16, 0]


def test_mixed_step_matches_reference(runs):
    jlog, tlog, js, ts, jc, tc, rows = runs["mixed"]
    np.testing.assert_allclose(tlog[rows], jlog[rows], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(ts, js)
    assert (ts[~rows] == -1).all()
    _assert_pools_close(jc, tc)
    assert tc["length"].tolist() == [14, 17, 21, 10]


def test_decode_steps_match_reference(runs):
    jout, tout, jc, tc = runs["steps"]
    for t, j in zip(tout, jout):                 # block, emitted, active, last
        np.testing.assert_array_equal(t, j)
    _assert_pools_close(jc, tc)
    assert tout[1].tolist() == [K, 2, K, 3]
