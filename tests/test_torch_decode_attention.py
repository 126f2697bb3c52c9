"""Port parity, dense decode attention (kernel 3). On the CPU the wrapper runs
``decode_attention_plain``; it is held against the reference's Pallas kernel
(interpret mode, as tests/test_kernels.py runs it) and its oracle on the
cases of tests/test_kernels.py. Tolerances as there: float32 2e-5, bf16 2e-2.

The reference's oracle returns the mean of V on a row with no valid key;
the Pallas kernel and the port return 0 there, so such rows are checked on
their own. The CUDA kernel is held against the plain version on the card in
tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import decode_attention as ref_decode
from repro.kernels.ref import decode_attention_ref
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels.flash_attention import check_head_dim
from torch_port_arrays import to_np

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _tol(dtype):
    return 2e-5 if dtype == "float32" else 2e-2


def _normal(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


DECODE_CASES = [
    # (B, H, KV, S, D, dtype) — tests/test_kernels.py:44
    (3, 8, 2, 512, 64, "float32"),
    (2, 4, 4, 256, 128, "float32"),
    (2, 8, 1, 128, 64, "bfloat16"),
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_plain_decode_matches_pallas_and_oracle(case):
    b, h, kv, s, d, dtype = case
    rng = np.random.default_rng(sum(case[:-1]))
    jq, tq = _normal(rng, (b, h, d), dtype)
    jk, tk = _normal(rng, (b, kv, s, d), dtype)
    jv, tv = _normal(rng, (b, kv, s, d), dtype)
    lengths = rng.integers(1, s + 1, size=b).astype(np.int32)
    pallas = ref_decode(jq, jk, jv, jnp.asarray(lengths), block_k=128)
    oracle = decode_attention_ref(jq, jk, jv, jnp.asarray(lengths))
    out = da.decode_attention(tq, tk, tv, torch.from_numpy(lengths))
    assert out.shape == (b, h, d) and out.dtype == TDT[dtype]
    for ref in (pallas, oracle):
        np.testing.assert_allclose(to_np(out), to_np(ref), rtol=_tol(dtype), atol=_tol(dtype))


def test_plain_decode_ignores_the_poisoned_tail():
    """Cache rows beyond each slot's length must not affect the output
    (tests/test_kernels.py:66)."""
    rng = np.random.default_rng(0)
    b, h, kv, s, d = 2, 4, 2, 256, 64
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((b, h, d), (b, kv, s, d), (b, kv, s, d)))
    lengths = torch.tensor([100, 17], dtype=torch.int32)
    out1 = da.decode_attention(q, k, v, lengths)
    poison = (torch.arange(s)[None, None, :, None] >= lengths[:, None, None, None]) * 1e9
    out2 = da.decode_attention(q, k + poison, v + poison, lengths)
    np.testing.assert_allclose(to_np(out1), to_np(out2), rtol=1e-5, atol=1e-5)
    pallas = ref_decode(jnp.asarray(to_np(q)), jnp.asarray(to_np(k + poison)),
                        jnp.asarray(to_np(v + poison)), jnp.asarray(to_np(lengths)), block_k=64)
    np.testing.assert_allclose(to_np(out2), to_np(pallas), rtol=2e-5, atol=2e-5)


def test_plain_decode_non_divisible_cache_len():
    """A cache length the Pallas kernel's block does not divide
    (tests/test_kernels.py:85)."""
    rng = np.random.default_rng(3)
    b, h, kv, s, d = 2, 4, 2, 200, 64
    jq, tq = _normal(rng, (b, h, d), "float32")
    jk, tk = _normal(rng, (b, kv, s, d), "float32")
    jv, tv = _normal(rng, (b, kv, s, d), "float32")
    lengths = np.array([200, 37], np.int32)
    pallas = ref_decode(jq, jk, jv, jnp.asarray(lengths), block_k=64)
    oracle = decode_attention_ref(jq, jk, jv, jnp.asarray(lengths))
    out = da.decode_attention(tq, tk, tv, torch.from_numpy(lengths))
    for ref in (pallas, oracle):
        np.testing.assert_allclose(to_np(out), to_np(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_strided_cache_view_equals_contiguous_input(dtype):
    """The model passes its (B, S, KV, D) layer slice as a (B, KV, S, D)
    view; the result equals that of a contiguous copy, and of the oracle."""
    rng = np.random.default_rng(4)
    b, h, kv, s, d = 3, 8, 2, 40, 16
    jq, tq = _normal(rng, (b, h, d), dtype)
    _, k_bskd = _normal(rng, (b, s, kv, d), dtype)
    _, v_bskd = _normal(rng, (b, s, kv, d), dtype)
    lengths = torch.tensor([40, 1, 23], dtype=torch.int32)
    kview, vview = k_bskd.transpose(1, 2), v_bskd.transpose(1, 2)
    assert not kview.is_contiguous()
    strided = da.decode_attention(tq, kview, vview, lengths)
    dense = da.decode_attention(tq, kview.contiguous(), vview.contiguous(), lengths)
    assert torch.equal(strided, dense)
    oracle = decode_attention_ref(jq, jnp.asarray(to_np(kview)), jnp.asarray(to_np(vview)),
                                  jnp.asarray(to_np(lengths)))
    np.testing.assert_allclose(to_np(strided), to_np(oracle), rtol=_tol(dtype), atol=_tol(dtype))


def test_zero_length_row_gives_zero_and_the_others_match_pallas():
    rng = np.random.default_rng(5)
    b, h, kv, s, d = 3, 4, 2, 64, 64
    jq, tq = _normal(rng, (b, h, d), "float32")
    jk, tk = _normal(rng, (b, kv, s, d), "float32")
    jv, tv = _normal(rng, (b, kv, s, d), "float32")
    lengths = np.array([10, 0, 64], np.int32)
    out = da.decode_attention(tq, tk, tv, torch.from_numpy(lengths))
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    pallas = to_np(ref_decode(jq, jk, jv, jnp.asarray(lengths), block_k=64))
    np.testing.assert_allclose(pallas[1], 0.0, atol=1e-6)        # Pallas: 0 too
    live = lengths > 0
    np.testing.assert_allclose(to_np(out)[live], pallas[live], rtol=2e-5, atol=2e-5)


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    q = torch.zeros(2, 4, 16)
    k = torch.zeros(2, 2, 8, 16)
    lengths = torch.ones(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        da.decode_attention(q.half(), k.half(), k.half(), lengths)
    with pytest.raises(ValueError):                     # lengths not int32
        da.decode_attention(q, k, k, lengths.long())
    with pytest.raises(ValueError):                     # head_dim 48: no variant
        check_head_dim("decode_attention", 48, da._HEAD_DIMS)
    with pytest.raises(ValueError):                     # group of 17
        da.decode_attention(torch.zeros(2, 34, 16), k, k, lengths)
    with pytest.raises(ValueError):                     # H not a multiple of KV
        da.decode_attention(torch.zeros(2, 5, 16), k, k, lengths)
    with pytest.raises(ValueError):                     # head_dim not contiguous
        da.decode_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3), k, lengths)
    with pytest.raises(ValueError):                     # batch mismatch
        da.decode_attention(torch.zeros(3, 4, 16), k, k, torch.ones(3, dtype=torch.int32))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    da.reset_launch_count()
    rng = np.random.default_rng(6)
    _, tq = _normal(rng, (2, 4, 16), "float32")
    _, tk = _normal(rng, (2, 2, 8, 16), "float32")
    out = da.decode_attention(tq, tk, tk, torch.tensor([8, 3], dtype=torch.int32))
    assert da.launch_count == 0
    assert torch.equal(out, da.decode_attention_plain(tq, tk, tk, torch.tensor([8, 3], dtype=torch.int32)))
