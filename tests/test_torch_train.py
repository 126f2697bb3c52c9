"""The port's training loss against the reference's: ``TransformerLM.loss``
and every gradient leaf against ``jax.value_and_grad`` of the reference's
``loss``, for each TransformerLM arch the port registers (float32 smoke
configs, every parameter perturbed off its init: ``family_models``), with
and without remat. The reference is computed once per arch.

Tolerances: the loss within 1e-5; each gradient leaf within 1e-4 relative
to the leaf's largest magnitude (float32; sums run in another order in each
framework, and an MoE's router gradient passes through its top-k gates)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.models.layers import _leaves
from torch_port_helpers import FAMILY_ARCHS, family_models

ARCHS = ("qwen3_8b",) + FAMILY_ARCHS
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
B, S = 2, 16


def batch_for(cfg, seed=0, masked=False):
    """numpy batch: tokens, next-token labels, a VLM's patch embeddings and,
    where ``masked``, a 0/1 loss mask."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if cfg.num_patch_tokens:
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
    if masked:
        batch["mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def reference(arch):
    """(port model, port params, numpy batch, reference loss, reference
    gradient leaves by path)."""
    ref_model, ref_params, model, params = family_models(arch)
    batch = batch_for(model.cfg, masked=ARCHS.index(arch) % 2 == 1)
    fn = jax.jit(jax.value_and_grad(lambda p, b: ref_model.loss(p, b, remat=False)))
    loss, grads = fn(ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    grads = {path: np.asarray(g) for path, g in _leaves(jax.tree_util.tree_map(np.asarray, grads))}
    return model, params, batch, float(loss), grads


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch, remat):
    model, params, batch, ref_loss, ref_grads = reference(arch)
    leaves = {path: t.detach().clone().requires_grad_(True) for path, t in _leaves(params)}
    tree = {}
    for path, t in leaves.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    loss = model.loss(tree, {k: torch.from_numpy(v) for k, v in batch.items()}, remat=remat)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(loss.item() - ref_loss) <= LOSS_TOL, (loss.item(), ref_loss)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert set(leaves) == set(ref_grads)
    for path, g in zip(leaves, grads):
        ref = ref_grads[path]
        assert g.shape == ref.shape, path
        err = float(np.abs(g.numpy() - ref).max() / max(np.abs(ref).max(), 1e-30))
        assert err <= GRAD_TOL, f"{'/'.join(path)}: {err:.3g}"


def test_forward_returns_float32_logits_and_moe_aux():
    """``forward``'s logits are float32 of (B, S, V); an MoE config's aux is
    the sum over its layers (positive), a dense config's is 0."""
    for arch in ("qwen3_8b", "olmoe_1b_7b"):
        model, params, batch, _, _ = reference(arch)
        logits, aux = model.forward(params, torch.from_numpy(batch["tokens"]), remat=False)
        assert logits.dtype == torch.float32 and logits.shape == (B, S, model.cfg.vocab_size)
        assert aux.dtype == torch.float32 and aux.shape == ()
        assert (float(aux) > 0) == model.cfg.is_moe


def test_serving_methods_record_no_graph():
    """The serving methods keep ``no_grad``: on leaves that require grad they
    return tensors without a graph, and the training forward has one."""
    model, params, batch, _, _ = reference("qwen3_8b")
    tree = {k: v for k, v in params.items()}
    for _, t in _leaves(params):
        t.requires_grad_(True)
    try:
        tokens = torch.from_numpy(batch["tokens"])
        logits, _ = model.prefill(params, tokens, model.cache_init(B, S))
        assert logits.grad_fn is None
        assert model.forward(tree, tokens, remat=False)[0].grad_fn is not None
    finally:
        for _, t in _leaves(params):
            t.requires_grad_(False)


def _card_check_inputs(arch):
    """The inputs of ``chip_smoke.py``'s card-vs-CPU training check
    (``run_train_parity``): the port's float32 smoke model drawn from seed 0
    on the CPU, every leaf plus 0.1 x its spread of noise from a CPU
    generator seeded 1, and the first synthetic batch of 4 x 32."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.layers import tree_map
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.train.train_loop import TrainConfig, synthetic_batches

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = TransformerLM(cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)

    def bump(x):
        spread = float(x.float().std()) if x.numel() > 1 else 0.0
        return (x.float() + 0.1 * (spread or 1.0) * torch.randn(x.shape, generator=gen)).to(x.dtype)

    params = tree_map(bump, model.init_params(seed=0))
    batch = next(synthetic_batches(cfg, TrainConfig(batch=4, seq=32)))
    return cfg, model, params, batch


@pytest.mark.parametrize("arch", ["qwen3_8b", "olmoe_1b_7b", "qwen2_vl_7b", "mixtral_8x22b"])
def test_float32_disagreement_on_the_card_checks_inputs(arch):
    """On the inputs of chip_smoke.py's card-vs-CPU training check, the
    reference and the port's CPU path agree on the loss within 1e-5 and on
    every gradient leaf within the card check's TRAIN_GRAD_TOL (5e-4 of the
    leaf's largest magnitude). The configs without qk-norm are ill-
    conditioned there: two correct float32 implementations disagree by up
    to ~1e-4 (printed), so the card cannot be held tighter than that."""
    import dataclasses

    from repro.configs import get_smoke_config as ref_smoke_config
    from repro.models.transformer import TransformerLM as RefLM
    from repro_torch.models.layers import tree_map

    cfg, model, params, batch = _card_check_inputs(arch)
    leaves = {path: t.detach().clone().requires_grad_(True) for path, t in _leaves(params)}
    tree = {}
    for path, t in leaves.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    loss = model.loss(tree, batch, remat=False)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    ref_model = RefLM(dataclasses.replace(ref_smoke_config(arch), dtype="float32"))
    jb = {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16) if v.dtype == torch.bfloat16
          else jnp.asarray(v.numpy()) for k, v in batch.items()}
    jp = tree_map(lambda t: jnp.asarray(t.detach().numpy()), params)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(lambda p, b: ref_model.loss(p, b, remat=False)))(jp, jb)
    ref_grads = dict(_leaves(jax.tree_util.tree_map(np.asarray, ref_grads)))
    assert abs(loss.item() - float(ref_loss)) <= LOSS_TOL
    worst = max(float(np.abs(g.numpy() - ref_grads[p]).max() / np.abs(ref_grads[p]).max())
                for p, g in grads.items())
    print(f"{arch}: reference vs port CPU, worst gradient leaf {worst:.3g}")
    assert worst <= 5e-4
