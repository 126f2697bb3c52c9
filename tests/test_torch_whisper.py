"""Port parity, Whisper: the float32 smoke configuration (2 encoder and 2
decoder layers, d_model 64, 4 heads of 16, vocab 256, layernorm and
biases, tied embeddings) on the reference's parameters, every leaf
perturbed off its init (so the zero biases and unit scales leave their
init), carried through ``params_from_numpy``.

* ``forward`` (dict and tokens + ``patch_embeds`` forms), ``loss`` and every
  gradient leaf against ``jax.value_and_grad`` of the reference's
  ``loss``, with and without remat;
* ``prefill`` (24 frames, a 12-token prompt) then three ``decode_step``s
  against the reference's, and against the port's own full forward on the
  extended sequences (the reference's ``tests/test_models.py`` check); the
  caches (self rows, cross K/V) against the reference's;
* the sinusoid table and its closed form at a decode position;
* the wave server (two waves of 3 slots, equal-length prompts, each
  request's seeded frames) against the same loop on the reference model,
  and a wave of ragged prompts refused.

Tolerances: the loss within 1e-5, each gradient leaf within 5e-4 of the
leaf's largest magnitude, logits and caches within 1e-4 (float32)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import sinusoidal_positions as ref_sinusoid
from repro_torch.configs import get_smoke_config
from repro_torch.data import gsm8k_like_workload
from repro_torch.launch.generate import generate_waves
from repro_torch.launch.serve import workload_spec
from repro_torch.models.layers import sinusoid_at, sinusoidal_positions
from repro_torch.models.registry import get_model
from repro_torch.models.whisper import Whisper
from torch_port_arrays import to_np
from torch_port_helpers import (
    port_loss_and_grads,
    ref_loss_and_grads,
    reference_waves,
    seq_models,
    worst_grad_error,
)

LOSS_TOL, GRAD_TOL, TOL = 1e-5, 5e-4, 1e-4
B, S, ENC = 2, 16, 24


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    frames = rng.standard_normal((B, ENC, cfg.d_model)).astype(np.float32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1), "frames": frames}


@pytest.fixture(scope="module")
def models():
    return seq_models("whisper_small")


@pytest.fixture(scope="module")
def reference(models):
    ref_model, ref_params, model, _ = models
    batch = _batch(model.cfg)
    return (batch,) + ref_loss_and_grads(ref_model, ref_params, batch)


def test_registry_and_sinusoid():
    assert isinstance(get_model(get_smoke_config("whisper_small"), device="cpu"), Whisper)
    np.testing.assert_allclose(sinusoidal_positions(40, 64).numpy(), np.asarray(ref_sinusoid(40, 64)),
                               rtol=1e-6, atol=1e-6)
    at = sinusoid_at(torch.tensor([[5.0], [33.0]]), 64)
    np.testing.assert_array_equal(at.numpy(), sinusoidal_positions(40, 64).numpy()[[5, 33]])


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_loss_and_every_gradient_match_jax(models, reference, remat):
    _, _, model, params = models
    batch, ref_loss, ref_grads = reference
    loss, grads = port_loss_and_grads(model, params, batch, remat)
    assert abs(loss - ref_loss) <= LOSS_TOL
    err, leaf = worst_grad_error(grads, ref_grads)
    assert err < GRAD_TOL, (leaf, err)


def test_forward_takes_the_dict_or_tokens_with_frames(models):
    ref_model, ref_params, model, params = models
    batch = _batch(model.cfg, seed=1)
    ref_logits, _ = ref_model.forward(ref_params, {k: jnp.asarray(v) for k, v in batch.items()},
                                      remat=False)
    with torch.no_grad():
        a, aux = model.forward(params, {k: torch.from_numpy(v) for k, v in batch.items()})
        b, _ = model.forward(params, torch.from_numpy(batch["tokens"]), torch.from_numpy(batch["frames"]))
    assert float(aux) == 0.0 and torch.equal(a, b)
    np.testing.assert_allclose(to_np(a), np.asarray(ref_logits), rtol=TOL, atol=TOL)


def test_prefill_then_decode_match_the_reference_and_the_forward(models):
    ref_model, ref_params, model, params = models
    batch = _batch(model.cfg, seed=2)
    tokens, frames = batch["tokens"], batch["frames"]
    cache = model.cache_init(B, 32, enc_len=ENC)
    lp, _ = model.prefill(params, torch.from_numpy(tokens[:, :12]), cache, torch.from_numpy(frames))
    ref_lp, ref_cache = ref_model.prefill(ref_params, jnp.asarray(tokens[:, :12]),
                                          ref_model.cache_init(B, 32, enc_len=ENC), jnp.asarray(frames))
    np.testing.assert_allclose(to_np(lp), np.asarray(ref_lp), rtol=TOL, atol=TOL)
    for k in ("cross_k", "cross_v"):
        np.testing.assert_allclose(to_np(cache[k]), np.asarray(ref_cache[k]), rtol=TOL, atol=TOL)
    decode = jax.jit(ref_model.decode_step)
    seq = tokens[:, :12]
    for _ in range(3):
        nxt = np.array(jnp.argmax(ref_lp, -1), np.int32)
        lp, _ = model.decode_step(params, torch.from_numpy(nxt), cache)
        ref_lp, ref_cache = decode(ref_params, jnp.asarray(nxt), ref_cache)
        np.testing.assert_allclose(to_np(lp), np.asarray(ref_lp), rtol=TOL, atol=TOL)
        seq = np.concatenate([seq, nxt[:, None]], axis=1)
        with torch.no_grad():
            full, _ = model.forward(params, torch.from_numpy(seq), torch.from_numpy(frames))
        np.testing.assert_allclose(to_np(lp), to_np(full[:, -1]), rtol=TOL, atol=TOL)
    assert cache["self"]["length"].tolist() == [15, 15]
    for k in ("k", "v"):
        np.testing.assert_allclose(to_np(cache["self"][k][:, :, :15]),
                                   np.asarray(ref_cache["self"][k])[:, :, :15], rtol=TOL, atol=TOL)


def _equal_length_requests(n, length=9):
    reqs = gsm8k_like_workload(workload_spec(n), seed=4, known_lengths=True)
    return [dataclasses.replace(r, n_prefill=length) for r in reqs]


def test_two_wave_serve_matches_the_same_loop_on_the_reference(models):
    ref_model, ref_params, model, params = models
    reqs = _equal_length_requests(6)
    res = generate_waves(model, params, reqs, n_slots=3, max_len=64, prefill_len=9, enc_len=ENC)
    want, steps = reference_waves(ref_model, ref_params, reqs, 3, 64, 9, enc_len=ENC)
    assert res.generated == want
    assert (res.prefills, res.decode_steps) == (2, steps)


def test_a_wave_of_ragged_prompts_is_refused(models):
    _, _, model, params = models
    reqs = _equal_length_requests(2)
    reqs[1] = dataclasses.replace(reqs[1], n_prefill=7)
    with pytest.raises(ValueError, match="one length"):
        generate_waves(model, params, reqs, n_slots=2, max_len=64, prefill_len=9, enc_len=ENC)
