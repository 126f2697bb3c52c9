"""Port parity, RG-LRU recurrence (kernel 4). On the CPU the wrapper runs
``rglru_scan_plain``; it is held against the reference's Pallas kernel
(interpret mode, as tests/test_kernels.py runs it) and its oracle on the
cases of tests/test_kernels.py, within 1e-5, and the ragged freeze the port's
model uses (a = 1, x = 0 past a slot's length) against the ``where`` of the
reference model's scan. The CUDA kernel is held against the plain version on
the card in tests/test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import rglru_scan as ref_rglru
from repro.kernels.ref import rglru_scan_ref
from repro_torch.kernels import rglru
from torch_port_arrays import to_np

TOL = 1e-5
RGLRU_CASES = [(2, 512, 256), (1, 256, 128), (3, 128, 384)]    # tests/test_kernels.py:161


def _inputs(rng, b, s, r):
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, r)))).astype(np.float32)
    x = rng.standard_normal((b, s, r)).astype(np.float32)
    h0 = rng.standard_normal((b, r)).astype(np.float32)
    return a.astype(np.float32), x, h0


@pytest.mark.parametrize("case", RGLRU_CASES)
def test_plain_rglru_matches_pallas_and_oracle(case):
    a, x, h0 = _inputs(np.random.default_rng(sum(case)), *case)
    out, hf = rglru.rglru_scan(*(torch.from_numpy(t) for t in (a, x, h0)))
    assert out.shape == case and out.dtype == torch.float32 and hf.shape == (case[0], case[2])
    pallas = ref_rglru(jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0), block_s=128, block_r=128)
    oracle = rglru_scan_ref(jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0))
    for ref_out, ref_hf in (pallas, oracle):
        np.testing.assert_allclose(to_np(out), to_np(ref_out), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(to_np(hf), to_np(ref_hf), rtol=TOL, atol=TOL)


def test_plain_rglru_state_chains_across_calls():
    """The final state of one call seeds the next (tests/test_kernels.py:177);
    no initial state means zeros."""
    a, x, _ = _inputs(np.random.default_rng(7), 1, 256, 128)
    ta, tx = torch.from_numpy(a), torch.from_numpy(x)
    full, hf_full = rglru.rglru_scan(ta, tx)
    _, hf1 = rglru.rglru_scan(ta[:, :128], tx[:, :128])
    h2, hf2 = rglru.rglru_scan(ta[:, 128:], tx[:, 128:], hf1)
    np.testing.assert_allclose(to_np(h2), to_np(full[:, 128:]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(to_np(hf2), to_np(hf_full), rtol=TOL, atol=TOL)
    ref_full, ref_hf = ref_rglru(jnp.asarray(a), jnp.asarray(x))
    np.testing.assert_allclose(to_np(full), to_np(ref_full), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(to_np(hf_full), to_np(ref_hf), rtol=TOL, atol=TOL)


def test_freeze_past_length_equals_the_reference_models_where():
    """The reference model freezes a slot's state past its prompt length with
    ``where(t < len, h_t, hprev)`` inside its scan (models/recurrentgemma.py
    :171-177); the port feeds a = 1 and x = 0 there. Both give the same
    states at every position and the same final state, and 1·h + 0 keeps the
    state bit for bit: past its length a slot repeats its last real state."""
    b, s, r = 3, 12, 64
    a, x, h0 = _inputs(np.random.default_rng(3), b, s, r)
    lens = np.array([12, 9, 0], np.int32)

    def step(hprev, xs):
        a_t, x_t, t = xs
        h_t = a_t * hprev + x_t
        h_t = jnp.where((t < jnp.asarray(lens))[:, None], h_t, hprev)
        return h_t, h_t

    ref_hf, ys = jax.lax.scan(
        step, jnp.asarray(h0),
        (jnp.swapaxes(jnp.asarray(a), 0, 1), jnp.swapaxes(jnp.asarray(x), 0, 1),
         jnp.arange(s, dtype=jnp.int32)),
    )
    live = (np.arange(s)[None, :] < lens[:, None])[..., None]
    out, hf = rglru.rglru_scan(torch.from_numpy(np.where(live, a, 1.0).astype(np.float32)),
                               torch.from_numpy(np.where(live, x, 0.0).astype(np.float32)),
                               torch.from_numpy(h0))
    np.testing.assert_allclose(to_np(out), np.swapaxes(to_np(ys), 0, 1), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(to_np(hf), to_np(ref_hf), rtol=TOL, atol=TOL)
    out, hf = to_np(out), to_np(hf)
    np.testing.assert_array_equal(out[1, 9:], np.broadcast_to(out[1, 8], (3, r)))
    np.testing.assert_array_equal(hf[:2], out[:2, -1])
    np.testing.assert_array_equal(out[2], np.broadcast_to(h0[2], (s, r)))   # length 0 keeps h0
    np.testing.assert_array_equal(hf[2], h0[2])


def test_wrapper_casts_to_float32_and_raises_on_bad_shapes():
    a = torch.full((2, 3, 4), 0.5, dtype=torch.bfloat16)
    x = torch.ones((2, 3, 4), dtype=torch.bfloat16)
    out, hf = rglru.rglru_scan(a, x)
    assert out.dtype == hf.dtype == torch.float32
    np.testing.assert_allclose(to_np(hf), np.full((2, 4), 1.75, np.float32))
    with pytest.raises(ValueError, match="one shape"):
        rglru.rglru_scan(a, x[:, :2])
    with pytest.raises(ValueError, match="h0"):
        rglru.rglru_scan(a, x, torch.zeros(2, 5))
    with pytest.raises(ValueError, match="one shape"):
        rglru.rglru_scan(a[0], x[0])


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    rglru.reset_launch_count()
    a, x, h0 = (torch.from_numpy(t) for t in _inputs(np.random.default_rng(1), 2, 5, 8))
    out, hf = rglru.rglru_scan(a, x, h0)
    ref, ref_hf = rglru.rglru_scan_plain(a, x, h0)
    assert torch.equal(out, ref) and torch.equal(hf, ref_hf)
    assert rglru.launch_count == 0
    _, hf0 = rglru.rglru_scan(a[:, :0], x[:, :0], h0)        # no time steps: the state as given
    assert torch.equal(hf0, h0) and hf0.data_ptr() != h0.data_ptr()
