"""Port parity, RG-LRU recurrence (kernel 4). On the CPU the wrapper runs
``rglru_scan_plain``; it is held against the reference's Pallas kernel
(interpret mode, as tests/test_kernels.py runs it) and its oracle on the
cases of tests/test_kernels.py, within 1e-5, and the ragged freeze the port's
model uses (a = 1, x = 0 past a slot's length) against the ``where`` of the
reference model's scan. The scan in the chunked kernel's order
(``rglru_scan_chunked_plain``) is held against the plain version, the
oracle and the Pallas kernel at RecurrentGemma's decays over many chunks,
and ``scan_plan`` is checked at the model's shapes. The CUDA kernel is held
against both plain versions on the card in tests/test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import rglru_scan as ref_rglru
from repro.kernels.ref import rglru_scan_ref
from repro_torch.kernels import rglru, rglru_bwd
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
    assert set(rglru.launch_count_by_kernel.values()) == {0}
    _, hf0 = rglru.rglru_scan(a[:, :0], x[:, :0], h0)        # no time steps: the state as given
    assert torch.equal(hf0, h0) and hf0.data_ptr() != h0.data_ptr()
    rglru.launch_count, rglru.launch_count_by_kernel["rglru_chunked_kernel"] = 2, 3
    rglru.reset_launch_count()
    assert rglru.launch_count == 0 and set(rglru.launch_count_by_kernel.values()) == {0}


# --------------------------------------------------------------------------- #
# The plan of the CUDA kernel, and the plain scan in its chunked order        #
# --------------------------------------------------------------------------- #
def _model_inputs(rng, b, s, r):
    """Decays in RecurrentGemma's trained range, numpy's counterpart of
    chip_smoke.py's ``model_decays``: a_t = base^{g_t}, base uniform in
    [0.9, 0.999] a channel (Griffin's init), g_t = sigmoid(N(0, 1)). A
    chunk of 64 steps passes on up to ~0.97 of its carry, so the state
    that enters the last chunk still carries h0 at leading order."""
    base = rng.uniform(0.9, 0.999, (1, 1, r))
    a = (base ** (1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, r)))))).astype(np.float32)
    x = rng.standard_normal((b, s, r)).astype(np.float32)
    h0 = rng.standard_normal((b, r)).astype(np.float32)
    return a, x, h0


def _scaled_tol(ref):
    """1e-5 of (1 + the largest |h|): float32 rounds a state in proportion
    to its size, and at these decays the states grow to ~1 / (1 - a), tens
    of times the inputs; the chunked order multiplies the carry through up
    to a chunk's product of decays and adds the maps, so it rounds apart
    from the sequential order by a few ulps of the largest state, not of
    each small one."""
    return TOL * (1 + float(np.abs(to_np(ref)).max()))


@pytest.mark.parametrize("b,s,r,chunk,block_s", [
    (1, 1000, 8, 64, 200),      # a ragged last chunk (15 of 64, then 40)
    (2, 512, 16, 64, 256),      # whole chunks, B > 1
    (3, 300, 128, 64, 100),     # 128 channels
    (2, 129, 5, 64, 129),       # one step past two chunks, R not a multiple of 128
    (1, 200, 4, 7, 200),        # a chunk that divides nothing, 29 chunks
])
def test_chunked_plain_matches_plain_oracle_and_pallas(b, s, r, chunk, block_s):
    """The scan in the chunked kernel's order (each chunk's map from a zero
    carry, then the earlier chunks' maps folded from h0 in chunk order)
    against the sequential plain version, the reference's oracle and its
    Pallas kernel (interpret mode), at the model's decays over several
    chunks, within ``_scaled_tol``. h0 still moves the state that enters the
    last chunk by 100 times the tolerance, so a fold that dropped or
    reordered a map would show."""
    a, x, h0 = _model_inputs(np.random.default_rng(b * s + r), b, s, r)
    ta, tx, th = (torch.from_numpy(t) for t in (a, x, h0))
    out, hf = rglru.rglru_scan_chunked_plain(ta, tx, th, chunk)
    assert out.shape == (b, s, r) and out.dtype == hf.dtype == torch.float32 and hf.shape == (b, r)
    seq = rglru.rglru_scan_plain(ta, tx, th)
    tol = _scaled_tol(seq[0])
    no_h0, _ = rglru.rglru_scan_plain(ta, tx, torch.zeros_like(th))
    last = (s - 1) // chunk * chunk
    assert float((seq[0] - no_h0)[:, last].abs().max()) > 100 * tol
    pallas = ref_rglru(jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0), block_s=block_s, block_r=128)
    oracle = rglru_scan_ref(jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0))
    for ref_out, ref_hf in (seq, pallas, oracle):
        np.testing.assert_allclose(to_np(out), to_np(ref_out), rtol=0, atol=tol)
        np.testing.assert_allclose(to_np(hf), to_np(ref_hf), rtol=0, atol=tol)


@pytest.mark.parametrize("cut,chunk", [(517, 64), (512, 64), (300, 7)])
def test_chunked_plain_chained_across_calls(cut, chunk):
    """Two calls in the chunked order, the first's final state seeding the
    second, the cut inside a chunk or at its edge: equal to one sequential
    call and to the oracle chained the same way, within ``_scaled_tol``."""
    a, x, h0 = _model_inputs(np.random.default_rng(cut), 2, 1000, 8)
    ta, tx, th = (torch.from_numpy(t) for t in (a, x, h0))
    h1, f1 = rglru.rglru_scan_chunked_plain(ta[:, :cut], tx[:, :cut], th, chunk)
    h2, f2 = rglru.rglru_scan_chunked_plain(ta[:, cut:], tx[:, cut:], f1, chunk)
    full, f_full = rglru.rglru_scan_plain(ta, tx, th)
    r1, g1 = rglru_scan_ref(jnp.asarray(a[:, :cut]), jnp.asarray(x[:, :cut]), jnp.asarray(h0))
    r2, g2 = rglru_scan_ref(jnp.asarray(a[:, cut:]), jnp.asarray(x[:, cut:]), g1)
    tol = _scaled_tol(full)
    got = to_np(torch.cat([h1, h2], 1))
    for want, want_f in ((full, f_full), (np.concatenate([to_np(r1), to_np(r2)], 1), g2)):
        np.testing.assert_allclose(got, to_np(want), rtol=0, atol=tol)
        np.testing.assert_allclose(to_np(f2), to_np(want_f), rtol=0, atol=tol)


@pytest.mark.parametrize("b,s,r", [
    (1, 4096, 4096),    # RecurrentGemma-9B's training shape: 64 chunks of 64, 8 groups
    (8, 128, 4096),     # the wave prefill: 2 chunks
    (8, 1, 4096),       # a decode step: one chunk, as before
    (1, 64, 256),       # S at the chunk: one chunk
    (1, 65, 256),       # one step past it: two chunks
    (2, 1000, 100),     # R not a multiple of 128, a ragged last chunk
    (32, 4096, 4096),   # B x R fills the card: one chunk
    (2, 0, 8),          # no step: one chunk that writes h0
])
def test_scan_plan_covers_every_step_once(b, s, r):
    """The chunks [c L, min(S, (c + 1) L)) cover 0..S-1 once, none empty;
    one chunk (``rglru_kernel``, a thread a channel) where B x R alone
    reaches the backward's thread target or S is at most ``CHUNK``, else
    chunks of ``CHUNK`` (``rglru_chunked_kernel``, a CTA a (batch, 64
    channels, chunk)); the grid, the control buffer (the ticket word, then
    two 64-bit words a chunk map and a group map a (batch, channel)) and
    the tiles' shared memory."""
    p = rglru.scan_plan(b, s, r)
    steps = [t for c in range(p.n_chunks) for t in range(c * p.chunk, min(s, (c + 1) * p.chunk))]
    assert steps == list(range(s))
    assert all(c * p.chunk < s for c in range(p.n_chunks)) or s == 0
    if b * r >= rglru_bwd._SCAN_THREADS or s <= rglru.CHUNK:
        assert p.n_chunks == 1 and p.kernels == ("rglru_kernel",) and p.grids == ((-(-r // 128), b, 1),)
        assert p.scratch_bytes == p.smem_bytes == 0
    else:
        assert p.chunk == rglru.CHUNK and p.n_chunks == -(-s // rglru.CHUNK) > 1
        assert p.kernels == ("rglru_chunked_kernel",)
        assert p.grids == ((p.n_chunks * b * -(-r // 64), 1, 1),)
        groups = -(-p.n_chunks // rglru.GROUP)
        assert p.scratch_bytes == 16 + 16 * (p.n_chunks + groups) * b * r
        assert p.smem_bytes == 2 * rglru.CHUNK * 64 * 4 == 32 * 1024
    want = {(1, 4096, 4096): (64, 4096, 16 + 16 * 72 * 4096), (8, 128, 4096): (2, 1024, 16 + 16 * 3 * 8 * 4096),
            (8, 1, 4096): (1, 256, 0), (2, 1000, 100): (16, 64, 16 + 16 * 18 * 2 * 100)}
    if (b, s, r) in want:
        assert (p.n_chunks, p.grids[0][0] * p.grids[0][1], p.scratch_bytes) == want[(b, s, r)]


@pytest.mark.parametrize("b,r", [(0, 4096), (2, 0)])
def test_scan_plan_launches_nothing_without_a_lane(b, r):
    """No batch or no channel: the launcher returns before any kernel, and
    the plan lists none and no scratch."""
    p = rglru.scan_plan(b, 4096, r)
    assert p.kernels == () and p.grids == () and p.scratch_bytes == 0


def test_scan_plan_forced_chunk():
    """``chunk`` forces the chunk length (what the timing by chunk length
    runs); a chunk of at least S is the one-chunk kernel; tiles past the
    shared memory a CTA may take are refused."""
    assert rglru.scan_plan(1, 4096, 4096, chunk=32)[:2] == (32, 128)
    assert rglru.scan_plan(1, 4096, 4096, chunk=4096).kernels == ("rglru_kernel",)
    assert rglru.scan_plan(8, 1000, 4096, chunk=48).n_chunks == 21
    assert rglru.scan_plan(1, 4096, 4096, chunk=452).smem_bytes <= 232448 - 1024
    with pytest.raises(ValueError, match="shared memory"):
        rglru.scan_plan(1, 4096, 4096, chunk=453)
