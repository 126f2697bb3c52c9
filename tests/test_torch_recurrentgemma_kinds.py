"""RecurrentGemma's other norm and MLP kinds on the port against the
reference: the float32 smoke config with ``norm_kind="layernorm"`` and
``mlp_kind="gelu"``, and separately with ``use_bias=True`` (accepted and
ignored by both packages: no block of the model has a bias), every parameter
perturbed off the reference's ``init_params`` (so the layernorm biases are
not zero).

* ``forward`` logits within 1e-4;
* the loss within 1e-5 and every gradient leaf within 5e-4 of the leaf's
  largest magnitude (the tolerances of ``test_torch_recurrentgemma_train``);
* two waves of 3 slots served by ``launch.generate.generate_waves`` give the
  tokens of the same wave loop on the reference model.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models.layers import init_params
from repro.models.registry import get_model as ref_get_model
from repro_torch.configs.base import ArchConfig
from repro_torch.data import gsm8k_like_workload
from repro_torch.launch.generate import generate_waves
from repro_torch.launch.serve import workload_spec
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import get_model
from torch_port_arrays import to_np
from torch_port_helpers import (
    perturbed,
    port_loss_and_grads,
    ref_loss_and_grads,
    reference_waves,
    worst_grad_error,
)

TOL, LOSS_TOL, GRAD_TOL = 1e-4, 1e-5, 5e-4
B, S, MAX_LEN = 2, 16, 32
KINDS = {
    "layernorm_gelu": dict(norm_kind="layernorm", mlp_kind="gelu"),
    "use_bias": dict(use_bias=True),
}


@pytest.fixture(scope="module", params=sorted(KINDS))
def models(request):
    ref_cfg = dataclasses.replace(ref_smoke_config("recurrentgemma_9b"), dtype="float32",
                                  **KINDS[request.param])
    cfg = ArchConfig(**dataclasses.asdict(ref_cfg))
    ref_model = ref_get_model(ref_cfg)
    tree = perturbed(jax.tree_util.tree_map(
        np.asarray, init_params(jax.random.key(0), ref_model.param_defs())))
    return (ref_model, jax.tree_util.tree_map(jnp.asarray, tree),
            get_model(cfg, device="cpu"), params_from_numpy(tree, cfg, "cpu"))


def _batch(cfg):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}


def test_config_builds_its_kinds(models):
    _, _, model, params = models
    cfg = model.cfg
    assert ("bias" in params["norm_final"]) == (cfg.norm_kind == "layernorm")
    assert ("w_gate" in params["rec_a"]["mlp"]) == (cfg.mlp_kind == "swiglu")
    assert "b_up" not in params["rec_a"]["mlp"]


def test_forward_logits_match_reference(models):
    ref_model, ref_params, model, params = models
    tok = _batch(model.cfg)["tokens"]
    jl, _ = ref_model.forward(ref_params, jnp.asarray(tok), remat=False)
    tl, _ = model.forward(params, torch.from_numpy(tok), remat=False)
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_loss_and_every_gradient_match_jax(models, remat):
    ref_model, ref_params, model, params = models
    batch = _batch(model.cfg)
    ref_loss, ref_grads = ref_loss_and_grads(ref_model, ref_params, batch)
    loss, grads = port_loss_and_grads(model, params, batch, remat)
    assert abs(loss - ref_loss) <= LOSS_TOL
    err, leaf = worst_grad_error(grads, ref_grads)
    assert err < GRAD_TOL, (leaf, err)


def test_served_waves_match_the_reference_loop(models):
    ref_model, ref_params, model, params = models
    reqs = gsm8k_like_workload(workload_spec(6), seed=3, known_lengths=True)
    width = max(r.n_prefill for r in reqs)
    res = generate_waves(model, params, reqs, n_slots=3, max_len=MAX_LEN, prefill_len=width)
    want, steps = reference_waves(ref_model, ref_params, reqs, 3, MAX_LEN, width)
    assert res.generated == want
    assert res.decode_steps == steps
