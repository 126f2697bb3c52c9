"""Port parity, attention kernels. On the CPU the wrappers run their plain
PyTorch versions; these are held against the reference's Pallas kernels (in
interpret mode, as tests/test_kernels.py runs them) and its oracles, on the
cases of tests/test_kernels.py. Tolerances as there: float32 2e-5, bf16 2e-2.

The CUDA kernels themselves are held against the plain versions on the
card in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import flash_attention as ref_flash
from repro.kernels.ops import paged_decode_attention as ref_paged_decode
from repro.kernels.ref import flash_attention_ref, paged_decode_attention_ref
from repro.models.attention import attention_paged as ref_attention_paged
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.attention import attention_paged
from repro_torch.kernels import paged_decode_attention as pda
from torch_port_arrays import shuffled_tables, to_np

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _tol(dtype):
    return 2e-5 if dtype == "float32" else 2e-2


def _normal(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


PAGED_CASES = [
    # (B, H, KV, pages, page_size, MB, D, dtype) — tests/test_kernels.py:101
    (3, 8, 2, 24, 16, 8, 64, "float32"),
    (2, 4, 4, 12, 8, 6, 128, "float32"),
    (2, 8, 1, 10, 32, 4, 64, "bfloat16"),
]


@pytest.mark.parametrize("case", PAGED_CASES)
def test_plain_paged_decode_matches_pallas_and_oracle(case):
    b, h, kv, p, bs, mb, d, dtype = case
    rng = np.random.default_rng(sum(case[:-1]))
    jq, tq = _normal(rng, (b, h, d), dtype)
    jk, tk = _normal(rng, (kv, p, bs, d), dtype)
    jv, tv = _normal(rng, (kv, p, bs, d), dtype)
    lengths = rng.integers(1, mb * bs + 1, size=b).astype(np.int32)
    tables = shuffled_tables(rng, b, mb, p, bs, lengths)
    args = (jnp.asarray(tables), jnp.asarray(lengths))
    pallas = ref_paged_decode(jq, jk, jv, *args)
    oracle = paged_decode_attention_ref(jq, jk, jv, *args)
    out = pda.paged_decode_attention(
        tq[:, None], tk, tv, torch.from_numpy(tables), torch.from_numpy(lengths)
    )
    assert out.shape == (b, 1, h, d) and out.dtype == TDT[dtype]
    for ref in (pallas, oracle):
        np.testing.assert_allclose(
            to_np(out)[:, 0], to_np(ref), rtol=_tol(dtype), atol=_tol(dtype)
        )


def test_plain_paged_decode_ignores_unallocated_pages_and_zeroes_idle_lanes():
    rng = np.random.default_rng(9)
    b, h, kv, p, bs, mb, d = 3, 4, 2, 10, 16, 4, 64
    q = torch.from_numpy(rng.standard_normal((b, 1, h, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((kv, p, bs, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((kv, p, bs, d)).astype(np.float32))
    tables = torch.tensor([[4, 2, -1, -1], [7, -1, -1, -1], [-1, -1, -1, -1]], dtype=torch.int32)
    lengths = torch.tensor([30, 9, 0], dtype=torch.int32)
    out1 = pda.paged_decode_attention(q, k, v, tables, lengths)
    poison = torch.tensor([0.0 if i in (4, 2, 7) else 1e9 for i in range(p)]).reshape(1, p, 1, 1)
    out2 = pda.paged_decode_attention(q, k + poison, v + poison, tables, lengths)
    np.testing.assert_allclose(to_np(out1), to_np(out2), rtol=1e-5, atol=1e-5)
    assert torch.equal(out1[2], torch.zeros_like(out1[2]))   # idle lane → 0


FLASH_CASES = [
    # (B, H, KV, S, D, causal, window, dtype) — tests/test_kernels.py:21
    (2, 4, 2, 256, 64, True, 0, "float32"),
    (1, 4, 4, 128, 128, True, 32, "float32"),
    (2, 2, 1, 256, 64, False, 0, "float32"),
    (1, 8, 2, 128, 64, True, 0, "bfloat16"),
    (1, 2, 2, 64, 32, True, 16, "bfloat16"),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_plain_flash_matches_pallas_and_oracle(case):
    b, h, kv, s, d, causal, w, dtype = case
    rng = np.random.default_rng(sum(c for c in case[:5]) + w)
    jq, tq = _normal(rng, (b, h, s, d), dtype)
    jk, tk = _normal(rng, (b, kv, s, d), dtype)
    jv, tv = _normal(rng, (b, kv, s, d), dtype)
    pallas = ref_flash(jq, jk, jv, causal=causal, window=w, block_q=64, block_k=64)
    oracle = flash_attention_ref(jq, jk, jv, causal=causal, window=w)
    out = fa.flash_attention(tq, tk, tv, causal=causal, window=w)
    for ref in (pallas, oracle):
        np.testing.assert_allclose(to_np(out), to_np(ref), rtol=_tol(dtype), atol=_tol(dtype))


def _chunk_case(rng, dtype, r=4, c=8, h=4, kv=2, d=16, p=20, bs=4, mb=10):
    """Chunk rows at ragged offsets over shuffled pages, with a pad row
    (chunk_lens 0) reading the last row's table, as mixed_step builds it."""
    starts = np.array([0, 5, 13, 0], np.int32)
    chunk_lens = np.array([8, 3, 7, 0], np.int32)
    valid = starts + chunk_lens
    tables = shuffled_tables(rng, r - 1, mb, p, bs, valid[:-1])
    tables = np.concatenate([tables, tables[-1:]])
    jq, tq = _normal(rng, (r, c, h, d), dtype)
    jk, tk = _normal(rng, (kv, p, bs, d), dtype)
    jv, tv = _normal(rng, (kv, p, bs, d), dtype)
    return starts, chunk_lens, valid, tables, (jq, jk, jv), (tq, tk, tv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_paged_chunk_matches_attention_paged(dtype):
    rng = np.random.default_rng(11)
    starts, chunk_lens, valid, tables, (jq, jk, jv), (tq, tk, tv) = _chunk_case(rng, dtype)
    c = tq.shape[1]
    qpos = starts[:, None] + np.arange(c, dtype=np.int32)[None, :]
    ref = ref_attention_paged(
        jq, jk, jv, jnp.asarray(tables), q_positions=jnp.asarray(qpos),
        valid_lengths=jnp.asarray(valid), causal=True,
    )
    out = fa.paged_chunk_attention(
        tq, tk, tv, torch.from_numpy(tables), torch.from_numpy(starts),
        torch.from_numpy(valid),
    )
    live = np.arange(c)[None, :] < chunk_lens[:, None]           # live rows only
    np.testing.assert_allclose(
        to_np(out)[live], to_np(ref)[live], rtol=_tol(dtype), atol=_tol(dtype)
    )
    assert torch.equal(out[3], torch.zeros_like(out[3]))         # pad row → 0
    assert torch.isfinite(out.float()).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_attention_paged_matches_reference_on_every_row(dtype):
    """The port's reference attention (models/attention.py) equals the JAX
    one on all rows, pad rows included (both give the mean of V there);
    the kernels' plain version agrees with it on the live rows."""
    rng = np.random.default_rng(12)
    starts, chunk_lens, valid, tables, (jq, jk, jv), (tq, tk, tv) = _chunk_case(rng, dtype)
    qpos = starts[:, None] + np.arange(tq.shape[1], dtype=np.int32)[None, :]
    ref = ref_attention_paged(
        jq, jk, jv, jnp.asarray(tables), q_positions=jnp.asarray(qpos),
        valid_lengths=jnp.asarray(valid), causal=True,
    )
    out = attention_paged(
        tq, tk, tv, torch.from_numpy(tables), q_positions=torch.from_numpy(qpos),
        valid_lengths=torch.from_numpy(valid), causal=True,
    )
    np.testing.assert_allclose(to_np(out), to_np(ref), rtol=_tol(dtype), atol=_tol(dtype))
    plain = fa.paged_chunk_attention(tq, tk, tv, torch.from_numpy(tables),
                                     torch.from_numpy(starts), torch.from_numpy(valid))
    live = np.arange(tq.shape[1])[None, :] < chunk_lens[:, None]
    np.testing.assert_allclose(to_np(plain)[live], to_np(out)[live],
                               rtol=_tol(dtype), atol=_tol(dtype))


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    q = torch.zeros(2, 1, 4, 16)
    pool = torch.zeros(2, 6, 4, 16)
    tables = torch.zeros(2, 3, dtype=torch.int32)
    lengths = torch.ones(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        pda.paged_decode_attention(q.half(), pool.half(), pool.half(), tables, lengths)
    with pytest.raises(ValueError):
        pda.paged_decode_attention(q, pool, pool, tables.long(), lengths)
    with pytest.raises(ValueError):   # head_dim 24: no variant
        fa.check_head_dim("paged_decode_attention", 24, pda._HEAD_DIMS)
    with pytest.raises(ValueError):   # pool head_dim differs from q's
        pda.paged_decode_attention(torch.zeros(2, 1, 4, 24), pool, pool, tables, lengths)
    with pytest.raises(ValueError):   # non-contiguous pages
        pda.paged_decode_attention(q, pool.transpose(2, 3), pool, tables, lengths)
    with pytest.raises(ValueError):
        fa.paged_chunk_attention(torch.zeros(2, 3, 5, 16), pool, pool, tables,
                                 lengths, lengths)
    with pytest.raises(ValueError):
        fa.flash_attention(torch.zeros(1, 4, 8, 16), torch.zeros(2, 2, 8, 16),
                           torch.zeros(2, 2, 8, 16))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    pda.reset_launch_count()
    fa.reset_launch_count()
    rng = np.random.default_rng(3)
    starts, chunk_lens, valid, tables, _, (tq, tk, tv) = _chunk_case(rng, "float32")
    fa.paged_chunk_attention(tq, tk, tv, torch.from_numpy(tables),
                             torch.from_numpy(starts), torch.from_numpy(valid))
    pda.paged_decode_attention(tq[:, :1], tk, tv, torch.from_numpy(tables),
                               torch.from_numpy(valid))
    assert pda.launch_count == 0 and fa.launch_count == 0
