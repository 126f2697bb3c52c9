"""Port parity, dense KV layout: the in-place full- and ring-cache writes of
the port leave the cache bit for bit where the reference's functional writes
leave it (inactive rows, rows at or past max_len and ring wraps included),
the ring's slot→position maps match on ragged lengths, and the slot
manager's merge of a prefill cache keeps the reference's rules (rows zeroed
past the bucket, ring ``pos`` padded with -1, only the real rows merged)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cache as ref_cache
from repro.serving.kv_slots import _scatter_cache as ref_scatter_cache
from repro_torch.models import cache
from repro_torch.serving.kv_slots import scatter_cache
from torch_port_arrays import to_np

B, S, KV, D, W = 4, 12, 2, 8, 5
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _pair(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def _assert_same(t, j):
    np.testing.assert_array_equal(to_np(t), to_np(j))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_cache_writes_match_reference_bit_for_bit(dtype):
    rng = np.random.default_rng(0)
    jk, tk = _pair(rng, (B, S, KV, D), dtype)
    jv, tv = _pair(rng, (B, S, KV, D), dtype)
    # prefill-style bulk write at offset 0
    jkn, tkn = _pair(rng, (B, 7, KV, D), "float32")
    jvn, tvn = _pair(rng, (B, 7, KV, D), "float32")
    jk, jv = ref_cache.full_cache_write(jk, jv, jkn, jvn, jnp.int32(0))
    cache.full_cache_write(tk, tv, tkn.to(tk.dtype), tvn.to(tv.dtype), 0)
    _assert_same(tk, jk)
    _assert_same(tv, jv)
    # one token per slot: row 1 inactive (no-op), row 3 at max_len (dropped)
    jkn, tkn = _pair(rng, (B, 1, KV, D), "float32")
    jvn, tvn = _pair(rng, (B, 1, KV, D), "float32")
    positions = np.array([7, 3, 11, S], np.int32)
    active = np.array([True, False, True, True])
    before = tk.clone()
    jk, jv = ref_cache.full_cache_write_token(
        jk, jv, jkn, jvn, jnp.asarray(positions), jnp.asarray(active)
    )
    cache.full_cache_write_token(
        tk, tv, tkn, tvn, torch.from_numpy(positions), torch.from_numpy(active)
    )
    _assert_same(tk, jk)
    _assert_same(tv, jv)
    changed = (tk != before).any(dim=-1).any(dim=-1)
    assert changed.nonzero().tolist() == [[0, 7], [2, 11]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_cache_writes_match_reference_bit_for_bit(dtype):
    rng = np.random.default_rng(1)
    jk, tk = _pair(rng, (B, W, KV, D), dtype)
    jv, tv = _pair(rng, (B, W, KV, D), dtype)
    lengths = np.array([3, 9, 5, 0], np.int32)          # ragged: short, wrapped, full, empty
    jpos = ref_cache.ring_positions_prefill(B, W, jnp.asarray(lengths))
    tpos = cache.ring_positions_prefill(B, W, torch.from_numpy(lengths))
    _assert_same(tpos, jpos)
    jkn, tkn = _pair(rng, (B, 9, KV, D), "float32")
    jvn, tvn = _pair(rng, (B, 9, KV, D), "float32")
    jk, jv = ref_cache.ring_cache_write_prefill(jk, jv, jkn, jvn, jpos)
    cache.ring_cache_write_prefill(tk, tv, tkn, tvn, tpos)
    _assert_same(tk, jk)
    _assert_same(tv, jv)
    # decode tokens across the wrap; row 2 inactive
    active = np.array([True, True, False, True])
    for step in range(7):
        positions = lengths + step
        jkn, tkn = _pair(rng, (B, 1, KV, D), "float32")
        jvn, tvn = _pair(rng, (B, 1, KV, D), "float32")
        before = (tk.clone(), tpos.clone())
        jk, jv = ref_cache.ring_cache_write_token(
            jk, jv, jkn, jvn, jnp.asarray(positions), jnp.asarray(active)
        )
        jpos = ref_cache.ring_positions_write_token(jpos, jnp.asarray(positions), jnp.asarray(active))
        cache.ring_cache_write_token(
            tk, tv, tkn, tvn, torch.from_numpy(positions), torch.from_numpy(active)
        )
        tpos = cache.ring_positions_write_token(
            tpos, torch.from_numpy(positions), torch.from_numpy(active)
        )
        _assert_same(tk, jk)
        _assert_same(tv, jv)
        _assert_same(tpos, jpos)
        assert torch.equal(tk[2], before[0][2]) and torch.equal(tpos[2], before[1][2])


@pytest.mark.parametrize("s", [0, 3, W, W + 1, 2 * W + 3])
def test_ring_positions_prefill_matches_reference(s):
    """Uniform (int) fills below, at and past the window; the engine's
    ragged form is covered above."""
    _assert_same(cache.ring_positions_prefill(B, W, s), ref_cache.ring_positions_prefill(B, W, s))


def test_cache_init_layouts_match_reference():
    full = cache.full_cache_init(3, B, S, KV, D, torch.bfloat16, "cpu")
    ring = cache.ring_cache_init(3, B, W, KV, D, torch.bfloat16, "cpu")
    rfull = ref_cache.full_cache_init(3, B, S, KV, D)
    rring = ref_cache.ring_cache_init(3, B, W, KV, D)
    for ours, ref in ((full, rfull), (ring, rring)):
        assert ours.keys() == ref.keys()
        for key in ours:
            assert tuple(ours[key].shape) == ref[key].shape
            _assert_same(ours[key], ref[key])
    shapes = cache.full_cache_shape(3, B, S, KV, D)
    assert shapes == {k: v.shape for k, v in ref_cache.full_cache_shape(3, B, S, KV, D).items()}
    shapes = cache.ring_cache_shape(3, B, W, KV, D)
    assert shapes == {k: v.shape for k, v in ref_cache.ring_cache_shape(3, B, W, KV, D).items()}


@pytest.mark.parametrize("ring", [False, True])
def test_scatter_cache_matches_reference(ring):
    """A 2-row prefill cache of a shorter bucket merged into slots 3 and 1:
    the target rows are zeroed past the bucket, ring ``pos`` rows padded
    with -1, the other slots untouched."""
    rng = np.random.default_rng(2)
    L, n, s_main, s_pref = 2, 2, 8, 5
    main = {
        "k": rng.standard_normal((L, B, s_main, KV, D)).astype(np.float32),
        "v": rng.standard_normal((L, B, s_main, KV, D)).astype(np.float32),
        "length": np.array([4, 6, 2, 8], np.int32),
    }
    pref = {
        "k": rng.standard_normal((L, n, s_pref, KV, D)).astype(np.float32),
        "v": rng.standard_normal((L, n, s_pref, KV, D)).astype(np.float32),
        "length": np.array([5, 3], np.int32),
    }
    if ring:
        main["pos"] = rng.integers(-1, 20, size=(B, s_main)).astype(np.int32)
        pref["pos"] = np.array([[0, 1, 2, 3, 4], [0, 1, 2, -1, -1]], np.int32)
    slots = np.array([3, 1], np.int32)
    ref = ref_scatter_cache(
        {k: jnp.asarray(v) for k, v in main.items()},
        {k: jnp.asarray(v) for k, v in pref.items()}, jnp.asarray(slots),
    )
    ours = {k: torch.from_numpy(v.copy()) for k, v in main.items()}
    scatter_cache(ours, {k: torch.from_numpy(v) for k, v in pref.items()},
                  torch.from_numpy(slots).long())
    for key in main:
        _assert_same(ours[key], ref[key])
    assert (ours["k"][:, 3, s_pref:] == 0).all()
