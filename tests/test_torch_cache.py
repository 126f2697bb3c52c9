"""Port parity, paged KV cache: the in-place page writes of the port leave the
pool bit for bit where the reference's functional writes leave it — over
shuffled physical pages, -1 table entries, lens=0 rows, rows reaching past
the table and inactive decode slots."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cache as ref_cache
from repro_torch.models import cache
from torch_port_arrays import to_np

KV, P, BS, D, MB = 2, 12, 4, 8, 5


def _pool(rng, dtype):
    k = rng.standard_normal((KV, P, BS, D)).astype(np.float32)
    v = rng.standard_normal((KV, P, BS, D)).astype(np.float32)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return (
        (jnp.asarray(k, jdt), jnp.asarray(v, jdt)),
        (torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt)),
    )


def _tables():
    # shuffled pages, unallocated (-1) entries, and a row whose chunk runs
    # past its last allocated page
    return np.array(
        [
            [7, 2, 9, -1, -1],
            [0, 11, -1, -1, -1],
            [5, -1, 3, -1, -1],
            [4, 1, 6, 8, 10],
        ],
        np.int32,
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_cache_write_matches_reference_bit_for_bit(dtype):
    rng = np.random.default_rng(0)
    (jk, jv), (tk, tv) = _pool(rng, dtype)
    s = 6
    k_new = rng.standard_normal((4, s, KV, D)).astype(np.float32)
    v_new = rng.standard_normal((4, s, KV, D)).astype(np.float32)
    tables = _tables()
    starts = np.array([3, 2, 0, 16], np.int32)   # row 3 runs past MB·BS
    lens = np.array([6, 0, 6, 6], np.int32)      # row 1 is a lens=0 row
    rk, rv = ref_cache.paged_cache_write(
        jk, jv, jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(tables),
        jnp.asarray(starts), jnp.asarray(lens),
    )
    cache.paged_cache_write(
        tk, tv, torch.from_numpy(k_new), torch.from_numpy(v_new),
        torch.from_numpy(tables), torch.from_numpy(starts), torch.from_numpy(lens),
    )
    np.testing.assert_array_equal(to_np(tk), to_np(rk))
    np.testing.assert_array_equal(to_np(tv), to_np(rv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_cache_write_token_matches_reference_bit_for_bit(dtype):
    rng = np.random.default_rng(1)
    (jk, jv), (tk, tv) = _pool(rng, dtype)
    k_new = rng.standard_normal((4, 1, KV, D)).astype(np.float32)
    v_new = rng.standard_normal((4, 1, KV, D)).astype(np.float32)
    tables = _tables()
    # row 0 writes on a live page; row 1 is inactive (must not write); row
    # 2 lands on a -1 entry; row 3 sits past the table
    positions = np.array([9, 5, 5, MB * BS + 1], np.int32)
    active = np.array([True, False, True, True])
    rk, rv = ref_cache.paged_cache_write_token(
        jk, jv, jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(tables),
        jnp.asarray(positions), jnp.asarray(active),
    )
    before = tk.clone()
    cache.paged_cache_write_token(
        tk, tv, torch.from_numpy(k_new), torch.from_numpy(v_new),
        torch.from_numpy(tables), torch.from_numpy(positions),
        torch.from_numpy(active),
    )
    np.testing.assert_array_equal(to_np(tk), to_np(rk))
    np.testing.assert_array_equal(to_np(tv), to_np(rv))
    # exactly one token row changed per head: row 0's
    changed = (tk != before).any(dim=-1)
    assert int(changed.sum()) == KV


def test_dropped_rows_aliasing_a_live_write_keep_it():
    """An invalid row whose clamped index equals a valid row's target must
    not undo that write (the port's masked scatter resolves duplicates)."""
    dst = torch.zeros(1, 4, 2)
    index = torch.tensor([0, 0, 0, 3])
    valid = torch.tensor([False, True, False, False])
    src = torch.arange(8, dtype=torch.float32).reshape(1, 4, 2) + 1
    cache.masked_row_write(dst, cache.row_write_plan(index, valid), src)
    assert dst[0, 0].tolist() == [3.0, 4.0]
    assert dst[0, 1:].abs().sum() == 0


def test_gather_and_key_positions_match_reference():
    rng = np.random.default_rng(2)
    (jk, jv), (tk, tv) = _pool(rng, "float32")
    tables = _tables()
    lengths = np.array([10, 0, 3, 20], np.int32)
    rk, rv = ref_cache.paged_gather_kv(jk, jv, jnp.asarray(tables))
    k_ctx, v_ctx = cache.paged_gather_kv(tk, tv, torch.from_numpy(tables))
    np.testing.assert_array_equal(to_np(k_ctx), to_np(rk))
    np.testing.assert_array_equal(to_np(v_ctx), to_np(rv))
    rpos = ref_cache.paged_key_positions(jnp.asarray(tables), jnp.asarray(lengths), BS)
    pos = cache.paged_key_positions(torch.from_numpy(tables), torch.from_numpy(lengths), BS)
    np.testing.assert_array_equal(to_np(pos), to_np(rpos))


def test_paged_cache_init_layout():
    pool = cache.paged_cache_init(3, P, BS, KV, D, 4, MB, torch.bfloat16, "cpu")
    assert pool["k"].shape == (3, KV, P, BS, D) and pool["k"].dtype == torch.bfloat16
    assert pool["block_tables"].dtype == torch.int32
    assert (pool["block_tables"] == -1).all() and (pool["length"] == 0).all()
