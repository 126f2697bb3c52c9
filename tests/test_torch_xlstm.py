"""Port parity, xLSTM: the float32 smoke configuration (4 layers: two
mLSTM / sLSTM pairs, d_model 64, 4 heads of 16, vocab 256) on the
reference's parameters, every leaf perturbed off its init, carried through
``params_from_numpy``.

* ``forward``, ``loss`` and every gradient leaf against
  ``jax.value_and_grad`` of the reference's ``loss``, with and without
  remat; remat over several time chunks against no remat;
* ``prefill`` then three ``decode_step``s against the reference's, and
  against the port's own full forward on the extended sequences (the
  reference's ``tests/test_models.py`` consistency check);
* the ragged prefill (lengths 12, 9, 7): the frozen states and the last
  real token's logits against the reference's, then decode steps;
* the wave server (two waves of 3 slots) against the same loop on the
  reference model: the same tokens for every request.

Tolerances: the loss within 1e-5, each gradient leaf within 5e-4 of the
leaf's largest magnitude, logits and states within 1e-4 (float32; the
exponential gates pass each framework's rounding on through the
recurrence)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import gsm8k_like_workload
from repro_torch.launch.generate import generate_waves
from repro_torch.launch.serve import workload_spec
from repro_torch.models.layers import _leaves, tree_map
from repro_torch.models.registry import get_model
from repro_torch.models.xlstm import XLSTM
from torch_port_arrays import to_np
from torch_port_helpers import (
    port_loss_and_grads,
    ref_loss_and_grads,
    reference_waves,
    seq_models,
    worst_grad_error,
)

LOSS_TOL, GRAD_TOL, TOL = 1e-5, 5e-4, 1e-4
B, S = 2, 16
LENGTHS = np.array([12, 9, 7], np.int32)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}


@pytest.fixture(scope="module")
def models():
    return seq_models("xlstm_350m")


@pytest.fixture(scope="module")
def reference(models):
    ref_model, ref_params, model, _ = models
    batch = _batch(model.cfg)
    return (batch,) + ref_loss_and_grads(ref_model, ref_params, batch)


def test_registry_config_and_parameter_tree(models):
    ref_model, ref_params, model, params = models
    assert isinstance(get_model(get_smoke_config("xlstm_350m"), device="cpu"), XLSTM)
    full = XLSTM(get_config("xlstm_350m"), device="cpu")
    assert (full.n_pairs, full.hd) == (12, 256)
    for (path, t), (_, ref) in zip(_leaves(params),
                                   _leaves(jax.tree_util.tree_map(np.asarray, ref_params))):
        np.testing.assert_array_equal(to_np(t), ref, err_msg=str(path))


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_loss_and_every_gradient_match_jax(models, reference, remat):
    _, _, model, params = models
    batch, ref_loss, ref_grads = reference
    loss, grads = port_loss_and_grads(model, params, batch, remat)
    assert abs(loss - ref_loss) <= LOSS_TOL
    err, leaf = worst_grad_error(grads, ref_grads)
    assert err < GRAD_TOL, (leaf, err)


def test_remat_over_time_chunks_equals_no_remat(models):
    """Four chunks of 4 tokens, each checkpointed: the logits and the
    gradients of every leaf equal the unchunked forward's (the same
    arithmetic, recomputed)."""
    _, _, model, params = models
    tokens = torch.from_numpy(_batch(model.cfg)["tokens"])
    w = torch.from_numpy(np.random.default_rng(1).standard_normal((B, S, model.cfg.vocab_size))
                         .astype(np.float32))
    outs = []
    for remat, chunk in ((False, 64), (True, 4)):
        tree = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
        logits, _ = model.forward(tree, tokens, remat=remat, time_chunk=chunk)
        (logits * w).sum().backward()
        outs.append((logits.detach(), tree))
    (l0, t0), (l1, t1) = outs
    np.testing.assert_allclose(to_np(l1), to_np(l0), rtol=1e-6, atol=1e-6)
    for (_, a), (_, b) in zip(_leaves(t0), _leaves(t1)):
        np.testing.assert_allclose(b.grad.numpy(), a.grad.numpy(), rtol=1e-5, atol=1e-6)


def test_prefill_then_decode_match_the_reference_and_the_forward(models):
    ref_model, ref_params, model, params = models
    tokens = _batch(model.cfg, seed=2)["tokens"]
    cache = model.cache_init(B)
    lp, _ = model.prefill(params, torch.from_numpy(tokens[:, :12]), cache)
    ref_lp, ref_cache = ref_model.prefill(ref_params, jnp.asarray(tokens[:, :12]), ref_model.cache_init(B))
    np.testing.assert_allclose(to_np(lp), np.asarray(ref_lp), rtol=TOL, atol=TOL)
    decode = jax.jit(ref_model.decode_step)
    seq = tokens[:, :12]
    for t in range(3):
        nxt = np.array(jnp.argmax(ref_lp, -1), np.int32)
        lp, _ = model.decode_step(params, torch.from_numpy(nxt), cache)
        ref_lp, ref_cache = decode(ref_params, jnp.asarray(nxt), ref_cache)
        np.testing.assert_allclose(to_np(lp), np.asarray(ref_lp), rtol=TOL, atol=TOL)
        seq = np.concatenate([seq, nxt[:, None]], axis=1)
        with torch.no_grad():
            full, _ = model.forward(params, torch.from_numpy(seq))
        np.testing.assert_allclose(to_np(lp), to_np(full[:, -1]), rtol=TOL, atol=TOL)
    assert cache["length"].tolist() == [15, 15]
    for k in ("m_C", "m_n", "m_m", "s_c", "s_n", "s_h", "s_m"):
        np.testing.assert_allclose(to_np(cache[k]), np.asarray(ref_cache[k]), rtol=TOL, atol=TOL,
                                   err_msg=k)


def test_ragged_prefill_freezes_each_slot_past_its_length(models):
    ref_model, ref_params, model, params = models
    rng = np.random.default_rng(3)
    tok = rng.integers(1, model.cfg.vocab_size, size=(3, 12)).astype(np.int32)
    tok[np.arange(12)[None, :] >= LENGTHS[:, None]] = 0
    cache = model.cache_init(3)
    lp, _ = model.prefill(params, torch.from_numpy(tok), cache, lengths=torch.from_numpy(LENGTHS))
    ref_lp, ref_cache = ref_model.prefill(ref_params, jnp.asarray(tok), ref_model.cache_init(3),
                                          lengths=jnp.asarray(LENGTHS))
    np.testing.assert_allclose(to_np(lp), np.asarray(ref_lp), rtol=TOL, atol=TOL)
    for k in ("m_C", "m_n", "s_h", "s_m"):
        np.testing.assert_allclose(to_np(cache[k]), np.asarray(ref_cache[k]), rtol=TOL, atol=TOL,
                                   err_msg=k)
    assert cache["length"].tolist() == LENGTHS.tolist()
    for b in range(3):
        with torch.no_grad():
            full, _ = model.forward(params, torch.from_numpy(tok[b:b + 1, :LENGTHS[b]]))
        np.testing.assert_allclose(to_np(lp[b]), to_np(full[0, -1]), rtol=TOL, atol=TOL)
    nxt = torch.argmax(lp, -1).to(torch.int32)
    ld, _ = model.decode_step(params, nxt, cache)
    ref_ld, _ = ref_model.decode_step(ref_params, jnp.asarray(nxt.numpy()), ref_cache)
    np.testing.assert_allclose(to_np(ld), np.asarray(ref_ld), rtol=TOL, atol=TOL)


def test_two_wave_serve_matches_the_same_loop_on_the_reference(models):
    ref_model, ref_params, model, params = models
    reqs = gsm8k_like_workload(workload_spec(6), seed=3, known_lengths=True)
    width = max(r.n_prefill for r in reqs)
    res = generate_waves(model, params, reqs, n_slots=3, max_len=0, prefill_len=width)
    want, steps = reference_waves(ref_model, ref_params, reqs, 3, 0, width)
    assert res.generated == want
    assert (res.prefills, res.decode_steps) == (2, steps)
