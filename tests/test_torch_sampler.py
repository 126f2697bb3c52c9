"""Port parity, sampling: the threefry streams and the top-p sampler against
``jax.random`` and ``repro.serving.sampler`` on seeded numpy inputs.

Keys, random bits and uniforms are integer work and must equal JAX's bit for
bit. Gumbel noise goes through ``log``, whose last bit differs between the
frameworks' math libraries, so it is held to 2e-6. Tokens are compared
exactly: a token could flip only where the two largest ``gumbel + logit``
values lie within that noise, or where the float32 cumulative sum of the
nucleus lands on the other side of ``top_p``; each test states its seeds and
prints any such row with its gap."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import sampler as ref
from repro_torch.serving import sampler as port
from repro_torch.serving import threefry

B, V = 8, 256


def _ref_keys(seed, rids, steps):
    return ref.fold_row_keys(jax.random.key(seed), jnp.asarray(rids), jnp.asarray(steps))


def _port_keys(seed, rids, steps):
    return port.fold_row_keys(threefry.seed_key(seed), torch.from_numpy(rids), torch.from_numpy(steps))


def _key_data(keys):
    return np.asarray(jax.random.key_data(keys)).astype(np.int64)


def _rows(seed, n=B, v=V, scale=2.0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((n, v)) * scale).astype(np.float32)
    rids = rng.integers(0, 2**31 - 1, size=n).astype(np.int32)
    steps = rng.integers(0, 512, size=n).astype(np.int32)
    return logits, rids, steps


def test_jax_runs_threefry_in_its_partitionable_mode():
    """The port implements the partitionable bit layout; should a JAX
    release change its default, this names the cause of every failure
    below."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, -1, 2**33 + 5])
def test_seed_key_matches_jax(seed):
    want = _key_data(jax.random.key(seed))
    assert threefry.seed_key(seed).tolist() == want.tolist()


def test_fold_in_matches_jax():
    # -1 (a pad row) folds in as 0xFFFFFFFF; 2**31 - 1 is the largest rid
    data = np.array([-1, 0, 2**31 - 1, 1, 7, 123456], np.int32)
    base = jax.random.key(7)
    want = _key_data(jax.vmap(lambda d: jax.random.fold_in(base, d))(jnp.asarray(data)))
    got = threefry.fold_in(threefry.seed_key(7), torch.from_numpy(data))
    np.testing.assert_array_equal(got.numpy(), want)
    # fold_row_keys folds the rid, then the step
    _, rids, steps = _rows(0)
    np.testing.assert_array_equal(
        _port_keys(5, rids, steps).numpy(), _key_data(_ref_keys(5, rids, steps))
    )


@pytest.mark.parametrize("shape", [(V,), (B, V), (3, 5, 7)])
def test_random_bits_match_jax_from_one_key(shape):
    want = np.asarray(jax.random.bits(jax.random.key(11), shape)).astype(np.int64)
    got = threefry.random_bits(threefry.seed_key(11), shape)
    assert got.shape == shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_bits_match_jax_one_key_a_row():
    _, rids, steps = _rows(1)
    keys = _ref_keys(3, rids, steps)
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (V,)))(keys)).astype(np.int64)
    got = threefry.random_bits(_port_keys(3, rids, steps), (V,))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bounds", [(0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0), (-2.0, 3.0)])
def test_uniform_matches_jax_bit_for_bit(bounds):
    lo, hi = bounds
    want = np.asarray(jax.random.uniform(jax.random.key(4), (B, V), minval=lo, maxval=hi))
    got = threefry.uniform(threefry.seed_key(4), (B, V), lo, hi).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_gumbel_matches_jax_within_log_rounding():
    want = np.asarray(jax.random.gumbel(jax.random.key(9), (B, 4096)))
    got = threefry.gumbel(threefry.seed_key(9), (B, 4096)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def _report_flips(name, want, got, scores):
    """Print every row whose token differs, with the gap between the two
    largest scores of the reference (what a 1-ulp noise could swap)."""
    for i in np.flatnonzero(want != got):
        top = np.sort(scores[i])[-2:]
        print(f"{name}: row {i} reference {want[i]} port {got[i]} top-2 gap {top[1] - top[0]:.3g}")


def test_categorical_matches_jax():
    logits, rids, steps = _rows(2)
    keys = _ref_keys(0, rids, steps)
    want = np.asarray(jax.vmap(lambda k, row: jax.random.categorical(k, row))(keys, jnp.asarray(logits)))
    got = threefry.categorical(_port_keys(0, rids, steps), torch.from_numpy(logits)).numpy()
    gum = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (V,)))(keys))
    _report_flips("categorical", want, got, gum + logits)
    np.testing.assert_array_equal(got, want)
    # one key over the whole batch: the noise spans (B, V) by linear index
    want = np.asarray(jax.random.categorical(jax.random.key(6), jnp.asarray(logits)))
    got = threefry.categorical(threefry.seed_key(6), torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)


def _nucleus_counts_ref(logits, top_p, temperature):
    x = jnp.asarray(logits) / jnp.maximum(temperature, 1e-6)
    cum = jnp.cumsum(jax.nn.softmax(jnp.sort(x, axis=-1)[:, ::-1], axis=-1), axis=-1)
    return np.asarray(jnp.sum(cum < top_p, axis=-1)), np.asarray(cum)


def _nucleus_counts_port(logits, top_p, temperature):
    x = torch.from_numpy(logits) / float(np.float32(max(temperature, 1e-6)))
    cum = torch.cumsum(torch.softmax(torch.sort(x, dim=-1, descending=True).values, dim=-1), dim=-1)
    return (cum < float(np.float32(top_p))).sum(-1).numpy(), cum.numpy()


@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("top_p", [0.9, 0.95, 1e-6])
def test_top_p_sampler_matches_jax(top_p, temperature):
    """300 rows of width 256 from seed 0: the same nucleus and the same
    token on every row."""
    logits, rids, steps = _rows(0, n=300)
    want = np.asarray(ref.TopPSampler(top_p, temperature)(jnp.asarray(logits), _ref_keys(1, rids, steps)))
    got = port.TopPSampler(top_p, temperature)(torch.from_numpy(logits), _port_keys(1, rids, steps))
    assert got.dtype == torch.int32
    got = got.numpy()
    n_ref, _ = _nucleus_counts_ref(logits, top_p, temperature)
    n_port, _ = _nucleus_counts_port(logits, top_p, temperature)
    np.testing.assert_array_equal(n_port, n_ref)
    _report_flips(f"top_p={top_p} T={temperature}", want, got, logits)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_top_p_one_collapses_to_token_zero_where_the_sum_ends_under_one(temperature):
    """At top_p = 1.0 the reference counts ``cum < 1.0``; when its float32
    cumulative sum ends just under 1.0 the count is V, the cutoff reads NaN
    past the end and the row draws token 0. Which rows those are is decided
    by the last bits of two different float32 sums (the frameworks' ``exp``
    and summation orders differ), so the port reproduces the mechanism, not
    the reference's rounding: on every row where both sides count the same
    nucleus the tokens are equal, and every row where the counts differ is
    shown to be a rounding edge — both sums end within 1e-6 of 1.0."""
    logits, rids, steps = _rows(0, n=300, v=64)
    want = np.asarray(ref.TopPSampler(1.0, temperature)(jnp.asarray(logits), _ref_keys(1, rids, steps)))
    got = port.TopPSampler(1.0, temperature)(torch.from_numpy(logits), _port_keys(1, rids, steps)).numpy()
    n_ref, cum_ref = _nucleus_counts_ref(logits, 1.0, temperature)
    n_port, cum_port = _nucleus_counts_port(logits, 1.0, temperature)
    # the quirk is reproduced: an all-NaN cutoff gives token 0 on both sides
    assert (want[n_ref == 64] == 0).all() and (got[n_port == 64] == 0).all()
    assert ((n_ref == 64) & (n_port == 64)).sum() > 0
    same = n_ref == n_port
    _report_flips(f"top_p=1 T={temperature}", want[same], got[same], logits[same])
    np.testing.assert_array_equal(got[same], want[same])
    edge = np.flatnonzero(~same)
    print(f"top_p=1 T={temperature}: {len(edge)} of 300 rows count a different nucleus; "
          f"largest |sum - 1|: reference {np.abs(cum_ref[edge, -1] - 1).max(initial=0):.3g}, "
          f"port {np.abs(cum_port[edge, -1] - 1).max(initial=0):.3g}")
    assert (np.abs(cum_ref[edge, -1] - 1.0) <= 1e-6).all()
    assert (np.abs(cum_port[edge, -1] - 1.0) <= 1e-6).all()


@pytest.mark.parametrize("top_p", [0.8, 1e-6])
def test_sample_top_p_one_key_matches_jax(top_p):
    logits, _, _ = _rows(3)
    want = np.asarray(ref.sample_top_p(jnp.asarray(logits), jax.random.key(1), top_p=top_p))
    got = port.sample_top_p(torch.from_numpy(logits), threefry.seed_key(1), top_p=top_p)
    np.testing.assert_array_equal(got.numpy(), want)
    assert ((got >= 0) & (got < V)).all()


def test_sampler_objects_and_key_threading():
    """The port of the reference's sampler-object test: greedy is argmax,
    threaded keys give the reference's draws (the same through the fused
    loop's integer dtypes), a stochastic sampler refuses to run without
    keys, and a near-empty nucleus is the argmax token."""
    logits = (np.random.default_rng(0).normal(size=(3, 32)) * 3).astype(np.float32)
    t_logits = torch.from_numpy(logits)
    np.testing.assert_array_equal(port.GreedySampler()(t_logits).numpy(), np.argmax(logits, -1))
    rids = np.asarray([7, 7, 9], np.int32)
    steps = np.asarray([0, 1, 0], np.int32)
    keys = _port_keys(0, rids, steps)
    t = port.TopPSampler(top_p=0.9)
    want = np.asarray(ref.TopPSampler(top_p=0.9)(jnp.asarray(logits), _ref_keys(0, rids, steps)))
    np.testing.assert_array_equal(t(t_logits, keys).numpy(), want)
    keys64 = port.fold_row_keys(threefry.seed_key(0), torch.from_numpy(rids).long(), torch.from_numpy(steps).long())
    np.testing.assert_array_equal(keys64.numpy(), keys.numpy())
    assert t.stochastic and not port.greedy.stochastic
    with pytest.raises(ValueError, match="per-row PRNG keys"):
        t(t_logits)
    tiny = port.TopPSampler(top_p=1e-6)
    np.testing.assert_array_equal(tiny(t_logits, keys).numpy(), np.argmax(logits, -1))
