"""RecurrentGemma training on the CPU against the reference: ``loss`` and
every gradient leaf against ``jax.value_and_grad`` of the reference's
``loss`` (the float32 smoke config, every parameter perturbed off its init,
a sequence of 16 past the window of 8), with and without remat; one
``make_train_step`` step against the reference's step; and the serving
views after an in-place optimizer step: the port's ``prefill`` and
``forward`` after its own train step equal the reference's on the updated
parameters, and a bf16 model (RecurrentGemma, a TransformerLM, xLSTM and
Whisper) serves after ``adamw_update`` exactly as a fresh model on the
updated tree does.

Tolerances: the loss within 1e-5; each gradient leaf within 5e-4 of the
leaf's largest magnitude (float32; the recurrence and the gates' sigmoid
and exp pass rounding differences on through every layer); logits within
1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as ref_opt
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.models.layers import _leaves, tree_map
from repro_torch.models.registry import get_model
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step
from torch_port_arrays import serve_update_serve, to_np
from torch_port_helpers import port_loss_and_grads, ref_loss_and_grads, seq_models, worst_grad_error

ARCH = "recurrentgemma_9b"
LOSS_TOL, GRAD_TOL, TOL = 1e-5, 5e-4, 1e-4
B, S = 2, 16
LENGTHS = np.array([12, 9], np.int32)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}


@pytest.fixture(scope="module")
def models():
    return seq_models(ARCH)


@pytest.fixture(scope="module")
def reference(models):
    ref_model, ref_params, model, _ = models
    batch = _batch(model.cfg)
    return (batch,) + ref_loss_and_grads(ref_model, ref_params, batch)


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_loss_and_every_gradient_match_jax(models, reference, remat):
    _, _, model, params = models
    batch, ref_loss, ref_grads = reference
    loss, grads = port_loss_and_grads(model, params, batch, remat)
    assert abs(loss - ref_loss) <= LOSS_TOL
    err, leaf = worst_grad_error(grads, ref_grads)
    assert err < GRAD_TOL, (leaf, err)


def test_forward_records_a_graph_only_under_autograd(models):
    """The training forward has no ``no_grad``: with leaves that require
    grad it returns a graph (and a zero aux loss); the serving methods keep
    theirs."""
    _, _, model, params = models
    tokens = torch.from_numpy(_batch(model.cfg)["tokens"])
    tree = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    logits, aux = model.forward(tree, tokens, remat=False)
    assert logits.grad_fn is not None and float(aux) == 0.0
    served, _ = model.prefill(tree, tokens, model.cache_init(B, 32))
    assert served.grad_fn is None
    np.testing.assert_allclose(to_np(served), to_np(logits[:, -1]), rtol=TOL, atol=TOL)


def _numpy_tree(params):
    return jax.tree_util.tree_map(jnp.asarray, tree_map(lambda t: t.detach().numpy().copy(), params))


def test_train_step_matches_the_reference_step(models):
    """One step of ``make_train_step`` (two microbatches, float32
    accumulation, AdamW) on the port's tree, one of the reference's on its
    own: the same loss and gradient norm; the port's parameters move in
    place."""
    ref_model, ref_params, model, params = models
    params = tree_map(torch.clone, params)
    batch = _batch(model.cfg, seed=1)
    cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1)
    ref_step = jax.jit(ref_make_train_step(ref_model, ref_opt.AdamWConfig(lr=1e-3, warmup_steps=1),
                                           microbatches=2, accum_dtype=jnp.float32))
    _, _, ref_m = ref_step(ref_params, ref_opt.adamw_init(ref_params),
                           {k: jnp.asarray(v) for k, v in batch.items()})
    before = params["rec_a"]["w_x"].clone()
    step = make_train_step(model, cfg, microbatches=2, accum_dtype=torch.float32)
    new, state, m = step(params, opt.adamw_init(params), {k: torch.from_numpy(v) for k, v in batch.items()})
    assert new is params and int(state["count"]) == 1
    assert not torch.equal(params["rec_a"]["w_x"], before)
    assert abs(float(m["loss"]) - float(ref_m["loss"])) <= LOSS_TOL
    assert abs(float(m["grad_norm"]) / float(ref_m["grad_norm"]) - 1) < 1e-4


def test_serving_after_an_in_place_train_step_matches_the_reference(models):
    """The serving views are built by a first prefill, then a train step
    updates the leaves in place: ``prefill`` (ragged) and ``forward`` then
    equal the reference's on the updated parameters, not the old ones."""
    ref_model, _, model, params = models
    params = tree_map(torch.clone, params)
    tokens = _batch(model.cfg, seed=2)["tokens"]
    tokens[np.arange(S)[None, :] >= LENGTHS[:, None]] = 0
    lens = torch.from_numpy(LENGTHS)
    first, _ = model.prefill(params, torch.from_numpy(tokens), model.cache_init(B, 32), lengths=lens)
    step = make_train_step(model, opt.AdamWConfig(lr=1e-2, warmup_steps=1), remat=False)
    step(params, opt.adamw_init(params), {k: torch.from_numpy(v) for k, v in _batch(model.cfg).items()})
    ref_params = _numpy_tree(params)
    ref_logits, _ = ref_model.prefill(ref_params, jnp.asarray(tokens), ref_model.cache_init(B, 32),
                                      lengths=jnp.asarray(LENGTHS))
    got, _ = model.prefill(params, torch.from_numpy(tokens), model.cache_init(B, 32), lengths=lens)
    assert np.abs(to_np(first) - np.asarray(ref_logits)).max() > 100 * TOL    # the step moved them
    np.testing.assert_allclose(to_np(got), np.asarray(ref_logits), rtol=TOL, atol=TOL)
    ref_full, _ = ref_model.forward(ref_params, jnp.asarray(tokens), remat=False)
    with torch.no_grad():
        full, _ = model.forward(params, torch.from_numpy(tokens))
    np.testing.assert_allclose(to_np(full), np.asarray(ref_full), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "qwen3_8b", "xlstm_350m", "whisper_small"])
def test_bf16_serving_views_follow_an_in_place_update(arch):
    """bf16 smoke model: prefill (its float32 views of bf16 leaves are
    cached), one in-place ``adamw_update``, prefill again: the logits and the
    cache equal a fresh model's on the updated tree, bit for bit."""
    cfg = get_smoke_config(arch)
    model = get_model(cfg, device="cpu")
    params = model.init_params(0)
    tokens = torch.from_numpy(_batch(cfg, seed=3)["tokens"])
    frames = torch.from_numpy(np.random.default_rng(5).standard_normal((B, 8, cfg.d_model))
                              .astype(np.float32)).to(torch.bfloat16)
    extra = {"patch_embeds": frames} if cfg.family == "audio" else {}

    def prefill(m):
        cache = m.cache_init(B, 32, enc_len=8) if cfg.family == "audio" else m.cache_init(B, 32)
        return m.prefill(params, tokens, cache, **extra)

    prefill(model)
    rng = np.random.default_rng(4)
    grads = tree_map(lambda t: torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)).to(t.dtype),
                     params)
    opt.adamw_update(grads, opt.adamw_init(params), params, opt.AdamWConfig(lr=1e-1, warmup_steps=1))
    got, cache = prefill(model)
    want, want_cache = prefill(get_model(cfg, device="cpu"))
    assert torch.equal(got, want)
    for (_, a), (_, b) in zip(_leaves(cache), _leaves(want_cache)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "qwen3_8b", "xlstm_350m", "whisper_small"])
def test_replayed_serves_follow_an_in_place_update(arch):
    """bf16 smoke model served through its dispatches (the Engine, or
    waves), one in-place ``adamw_update``, served again on the same
    dispatches: the tokens moved, and equal a fresh model's on the updated
    tree (each replay refreshes the views first; on the card the same drive
    runs in ``test_torch_cuda.py``)."""
    before, after, fresh = serve_update_serve(arch, "cpu")
    assert after != before
    assert after == fresh
