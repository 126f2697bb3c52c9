"""The RG-LRU backward on the CPU: the plain reverse scan
(``rglru_bwd.rglru_scan_backward_plain``, what the CUDA kernel ``csrc/rglru_bwd.cu``
is held against on the card) against ``jax.grad`` of the reference's oracle
``repro.kernels.ref.rglru_scan_ref``, with the gradient of the initial state
and chained across two calls (a prefill's final state seeding the next
call); ``RGLRUScanFn`` through ``rglru_scan`` where autograd records, and
the serving call without it. Inputs from numpy (seeded), float32.

Tolerance: 1e-5 relative to the reference's largest magnitude (float32;
the two frameworks round the recurrence's products apart)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import rglru_scan_ref
from repro_torch.kernels import rglru, rglru_bwd

TOL = 1e-5


def _inputs(b, s, r, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, (b, s, r)).astype(np.float32)
    x = rng.standard_normal((b, s, r)).astype(np.float32)
    h0 = rng.standard_normal((b, r)).astype(np.float32)
    g = rng.standard_normal((b, s, r)).astype(np.float32)
    g_fin = rng.standard_normal((b, r)).astype(np.float32)
    return a, x, h0, g, g_fin


def _rel(a, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(a, np.float32) - ref).max() / max(np.abs(ref).max(), 1e-30))


def _jax_vjp(a, x, h0, g, g_fin):
    _, vjp = jax.vjp(rglru_scan_ref, jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0))
    return [np.asarray(t) for t in vjp((jnp.asarray(g), jnp.asarray(g_fin)))]


@pytest.mark.parametrize("b,s,r", [(2, 9, 5), (1, 1, 7), (3, 17, 4)])
def test_plain_backward_matches_jax_grad_of_the_oracle(b, s, r):
    a, x, h0, g, g_fin = _inputs(b, s, r)
    h, _ = rglru.rglru_scan_plain(*(torch.from_numpy(t) for t in (a, x, h0)))
    da, dx, dh0 = rglru_bwd.rglru_scan_backward(
        torch.from_numpy(a), h, torch.from_numpy(h0), torch.from_numpy(g), torch.from_numpy(g_fin))
    ref = _jax_vjp(a, x, h0, g, g_fin)
    for got, want in zip((da, dx, dh0), ref):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert _rel(got.numpy(), want) < TOL


def test_autograd_through_rglru_scan_chained_across_calls():
    """Two calls, the first's final state seeding the second (a prefill,
    then the next chunk): ``rglru_scan`` takes ``RGLRUScanFn`` because an
    input requires grad, and the gradients of a, x and h0 of both calls
    equal jax.grad of the oracle chained the same way."""
    a, x, h0, g, g_fin = _inputs(2, 12, 6, seed=1)
    cut = 7

    def ref_chain(a_, x_, h0_):
        h1, f1 = rglru_scan_ref(a_[:, :cut], x_[:, :cut], h0_)
        h2, f2 = rglru_scan_ref(a_[:, cut:], x_[:, cut:], f1)
        return jnp.concatenate([h1, h2], axis=1), f2

    _, vjp = jax.vjp(ref_chain, jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0))
    ref = [np.asarray(t) for t in vjp((jnp.asarray(g), jnp.asarray(g_fin)))]

    ta, tx, th = (torch.from_numpy(t).requires_grad_(True) for t in (a, x, h0))
    h1, f1 = rglru.rglru_scan(ta[:, :cut], tx[:, :cut], th)
    h2, f2 = rglru.rglru_scan(ta[:, cut:], tx[:, cut:], f1)
    assert h1.grad_fn is not None and "RGLRUScanFn" in type(h2.grad_fn).__name__
    out = torch.cat([h1, h2], dim=1)
    torch.autograd.backward((out, f2), (torch.from_numpy(g), torch.from_numpy(g_fin)))
    for got, want in zip((ta.grad, tx.grad, th.grad), ref):
        assert _rel(got.numpy(), want) < TOL


def test_gradients_come_back_in_the_input_dtypes():
    a, x, h0, g, _ = _inputs(1, 5, 4, seed=2)
    ta = torch.from_numpy(a).double().requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    h, _ = rglru.rglru_scan(ta, tx)                       # h0 defaults to zeros
    assert h.dtype == torch.float32
    (h * torch.from_numpy(g)).sum().backward()
    assert ta.grad.dtype == torch.float64 and tx.grad.dtype == torch.float32
    np.testing.assert_allclose(tx.grad.numpy(), _jax_vjp(a, x, np.zeros((1, 4), np.float32), g,
                                                          np.zeros((1, 4), np.float32))[1],
                               rtol=TOL, atol=TOL)


def test_serving_calls_record_nothing_and_count_apart():
    """Without autograd (no input requires grad, or no_grad) ``rglru_scan``
    runs the forward alone: no graph; the backward's counter lives in its
    own module, and resetting one kernel's count leaves the other's."""
    a, x, h0, _, _ = _inputs(1, 4, 3)
    ta = torch.from_numpy(a).requires_grad_(True)
    with torch.no_grad():
        h, _ = rglru.rglru_scan(ta, torch.from_numpy(x), torch.from_numpy(h0))
    assert h.grad_fn is None
    h, _ = rglru.rglru_scan(*(torch.from_numpy(t) for t in (a, x, h0)))
    assert h.grad_fn is None
    rglru.launch_count, rglru_bwd.launch_count = 2, 3
    rglru.reset_launch_count()
    assert (rglru.launch_count, rglru_bwd.launch_count) == (0, 3)
    rglru_bwd.reset_launch_count()
    assert rglru_bwd.launch_count == 0


def test_backward_checks_its_inputs():
    a, x, h0, g, g_fin = (torch.from_numpy(t) for t in _inputs(2, 5, 4))
    with pytest.raises(ValueError, match="one shape"):
        rglru_bwd.rglru_scan_backward(a, a[:, :-1], h0, g, g_fin)
    with pytest.raises(ValueError, match="h0 and g_fin"):
        rglru_bwd.rglru_scan_backward(a, a, h0[:1], g, g_fin)
