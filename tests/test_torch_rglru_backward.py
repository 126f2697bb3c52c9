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


# --------------------------------------------------------------------------- #
# The chunked plan of the CUDA kernel, and the plain scan in its order        #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("b,s,r", [
    (1, 4096, 4096),    # RecurrentGemma-9B's training shape: 32 chunks of 128
    (1, 40, 256),       # S below the shortest chunk: one chunk
    (1, 64, 256),       # S at the shortest chunk
    (1, 128, 256),      # S a whole number of chunks
    (1, 200, 256),      # S not a multiple of the chunk
    (2, 257, 100),      # one step past a whole number of chunks
    (1, 1, 4096),       # one step
    (32, 4096, 4096),   # B x R fills the card: one chunk
    (8, 128, 4096),
    (2, 0, 8),          # no step
])
def test_scan_plan_covers_every_step_once(b, s, r):
    """The chunks [c L, min(S, (c + 1) L)) cover 0..S-1 once, none empty;
    one chunk where B x R alone reaches the thread target or S is short;
    the kernels in order with their grids, and the chunk maps' scratch."""
    p = rglru_bwd.scan_plan(b, s, r)
    steps = [t for c in range(p.n_chunks) for t in range(c * p.chunk, min(s, (c + 1) * p.chunk))]
    assert steps == list(range(s))
    assert all(c * p.chunk < s for c in range(p.n_chunks)) or s == 0
    lanes = b * r
    if lanes >= rglru_bwd._SCAN_THREADS or s <= rglru_bwd._MIN_CHUNK:
        assert p.n_chunks == 1
    else:
        # as many chunks as reach the thread target, unless the shortest chunk stops them
        assert p.chunk >= rglru_bwd._MIN_CHUNK
        assert lanes * p.n_chunks >= rglru_bwd._SCAN_THREADS or p.chunk == rglru_bwd._MIN_CHUNK
    blocks = -(-r // 128)
    if p.n_chunks > 1:
        assert p.kernels == ("rglru_bwd_chunk_kernel", "rglru_bwd_kernel")
        assert p.grids == ((blocks, p.n_chunks - 1, b), (blocks, p.n_chunks, b))
        assert p.scratch_bytes == 2 * p.n_chunks * b * r * 4
    else:
        assert p.kernels == ("rglru_bwd_kernel",) and p.grids == ((blocks, 1, b),) and p.scratch_bytes == 0
    if (b, s, r) == (1, 4096, 4096):
        assert (p.chunk, p.n_chunks) == (128, 32)


@pytest.mark.parametrize("b,r", [(0, 4096), (2, 0)])
def test_scan_plan_launches_nothing_without_a_lane(b, r):
    """No batch or no channel: the launcher returns before any kernel, and
    the plan lists none (what chip_smoke.py holds the device trace to)."""
    p = rglru_bwd.scan_plan(b, 4096, r)
    assert p.kernels == () and p.grids == ()


@pytest.mark.parametrize("b,s,r,chunk", [(2, 9, 5, 4), (1, 17, 7, 1), (3, 40, 4, 7), (2, 64, 3, 64),
                                         (1, 65, 6, 64), (2, 33, 5, 100)])
def test_chunked_plain_matches_jax_grad_of_the_oracle(b, s, r, chunk):
    """The reverse scan in the kernel's chunk order (each chunk's carry map,
    then each chunk from the carry the later maps give) against jax.grad
    of the oracle, float32 within TOL, and against the sequential plain
    version."""
    a, x, h0, g, g_fin = _inputs(b, s, r, seed=chunk)
    h, _ = rglru.rglru_scan_plain(*(torch.from_numpy(t) for t in (a, x, h0)))
    args = (torch.from_numpy(a), h, torch.from_numpy(h0), torch.from_numpy(g), torch.from_numpy(g_fin))
    got = rglru_bwd.rglru_scan_backward_chunked_plain(*args, chunk)
    ref = _jax_vjp(a, x, h0, g, g_fin)
    seq = rglru_bwd.rglru_scan_backward_plain(*args)
    for u, want, w in zip(got, ref, seq):
        assert u.dtype == torch.float32 and u.shape == want.shape
        assert _rel(u.numpy(), want) < TOL and _rel(u.numpy(), w.numpy()) < TOL


def test_chunked_plain_chained_across_calls():
    """Two calls in the kernel's chunk order, the first's final state
    seeding the second and the second's dh0 the first's g_fin, equal
    jax.grad of the oracle chained the same way."""
    a, x, h0, g, g_fin = _inputs(2, 150, 6, seed=4)
    cut = 70

    def ref_chain(a_, x_, h0_):
        h1, f1 = rglru_scan_ref(a_[:, :cut], x_[:, :cut], h0_)
        h2, f2 = rglru_scan_ref(a_[:, cut:], x_[:, cut:], f1)
        return jnp.concatenate([h1, h2], axis=1), f2

    _, vjp = jax.vjp(ref_chain, jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0))
    ref = [np.asarray(t) for t in vjp((jnp.asarray(g), jnp.asarray(g_fin)))]
    ta, tx, th, tg, tf = (torch.from_numpy(t) for t in (a, x, h0, g, g_fin))
    h1, f1 = rglru.rglru_scan_plain(ta[:, :cut], tx[:, :cut], th)
    h2, _ = rglru.rglru_scan_plain(ta[:, cut:], tx[:, cut:], f1)
    da2, dx2, dh2 = rglru_bwd.rglru_scan_backward_chunked_plain(ta[:, cut:], h2, f1, tg[:, cut:], tf, 16)
    da1, dx1, dh0 = rglru_bwd.rglru_scan_backward_chunked_plain(ta[:, :cut], h1, th, tg[:, :cut], dh2, 16)
    for got, want in zip((torch.cat([da1, da2], 1), torch.cat([dx1, dx2], 1), dh0), ref):
        assert _rel(got.numpy(), want) < TOL


@pytest.mark.parametrize("lo,hi", [(0.9, 0.999), (0.999, 0.9999)])
def test_chunked_plain_carries_across_many_chunks(lo, hi):
    """32 chunks of 64 at decays in RecurrentGemma's trained range (a_t =
    base^{r_t}, base uniform in [lo, hi] a channel, r_t = sigmoid(N(0, 1));
    Griffin's init is [0.9, 0.999]), where the carry reaches the first
    chunk at leading order: g_fin's share of dh0 is 100 times TOL, and the
    chunk order still matches jax.grad of the oracle within TOL."""
    b, s, r, chunk = 1, 2048, 8, 64
    rng = np.random.default_rng(5)
    base = rng.uniform(lo, hi, (1, 1, r))
    gate = 1 / (1 + np.exp(-rng.standard_normal((b, s, r))))
    _, x, h0, g, g_fin = _inputs(b, s, r, seed=6)
    a = (base ** gate).astype(np.float32)
    h, _ = rglru.rglru_scan_plain(*(torch.from_numpy(t) for t in (a, x, h0)))
    args = (torch.from_numpy(a), h, torch.from_numpy(h0), torch.from_numpy(g))
    got = rglru_bwd.rglru_scan_backward_chunked_plain(*args, torch.from_numpy(g_fin), chunk)
    no_fin = rglru_bwd.rglru_scan_backward_plain(*args, torch.zeros(b, r))[2]
    ref = _jax_vjp(a, x, h0, g, g_fin)
    assert _rel(got[2].numpy() - no_fin.numpy(), ref[2]) > 100 * TOL
    for u, want in zip(got, ref):
        assert _rel(u.numpy(), want) < TOL
