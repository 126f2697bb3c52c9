"""Port parity, layers: the PyTorch layer primitives against the reference's
on the same float32 inputs (allclose 1e-5), and the parameter carry-over."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref_layers
from repro_torch.models import layers
from repro_torch.models.convert import params_from_numpy
from torch_port_arrays import to_np
from torch_port_helpers import CFG, REF_CFG, port_model_and_params, ref_model_and_params

TOL = 1e-5


@pytest.fixture(scope="module")
def both():
    ref_model, ref_params = ref_model_and_params()
    model, params = port_model_and_params(ref_params)
    return ref_params, params


def _rng(seed):
    return np.random.default_rng(seed)


def test_rms_norm_matches_reference():
    x = _rng(0).standard_normal((3, 5, 64)).astype(np.float32)
    w = _rng(1).standard_normal(64).astype(np.float32)
    ref = ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    out = layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), rtol=TOL, atol=TOL)
    out2 = layers.apply_norm(torch.from_numpy(x), {"scale": torch.from_numpy(w)}, "rmsnorm", 1e-6)
    np.testing.assert_array_equal(to_np(out2), to_np(out))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches_reference(theta):
    x = _rng(2).standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = _rng(3).integers(0, 600, size=(2, 7)).astype(np.int32)
    ref = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    out = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), rtol=TOL, atol=TOL)


def test_mlp_embed_unembed_match_reference(both):
    ref_params, params = both
    lp_ref = jax.tree_util.tree_map(lambda a: a[0], ref_params["blocks"]["mlp"])
    lp = {k: v[0] for k, v in params["blocks"]["mlp"].items()}
    x = _rng(4).standard_normal((2, 3, 64)).astype(np.float32)
    ref = ref_layers.mlp_apply(jnp.asarray(x), lp_ref, "swiglu")
    out = layers.mlp_apply(torch.from_numpy(x), lp, "swiglu")
    np.testing.assert_allclose(to_np(out), np.asarray(ref), rtol=TOL, atol=TOL)

    tok = _rng(5).integers(0, CFG.vocab_size, size=(2, 6)).astype(np.int32)
    ref_h = ref_layers.embed_tokens(jnp.asarray(tok), ref_params["embed"])
    h = layers.embed_tokens(torch.from_numpy(tok), params["embed"])
    np.testing.assert_array_equal(to_np(h), np.asarray(ref_h))

    ref_logits = ref_layers.unembed(ref_h, ref_params["embed"])
    logits = layers.unembed(h, params["embed"])
    np.testing.assert_allclose(to_np(logits), np.asarray(ref_logits), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_carries_every_leaf_bit_for_bit(dtype):
    ref_cfg = dataclasses.replace(REF_CFG, dtype=dtype)
    cfg = dataclasses.replace(CFG, dtype=dtype)
    _, ref_params = ref_model_and_params(ref_cfg)
    tree = jax.tree_util.tree_map(np.asarray, ref_params)
    params = params_from_numpy(tree, cfg, "cpu")
    ref_leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert len(ref_leaves) == len(list(layers._leaves(params)))
    for path, leaf in ref_leaves:
        node = params
        for k in path:
            node = node[k.key]
        assert node.dtype == layers.DTYPES[dtype]
        np.testing.assert_array_equal(to_np(node), np.asarray(leaf, np.float32))


def test_params_from_numpy_rejects_a_mismatched_tree():
    _, ref_params = ref_model_and_params()
    tree = jax.tree_util.tree_map(np.asarray, ref_params)
    del tree["blocks"]["q_norm"]
    with pytest.raises(ValueError, match="q_norm"):
        params_from_numpy(tree, CFG, "cpu")


def test_init_params_mirrors_reference_shapes_and_scales():
    """The port's seeded initialiser has the reference's tree, shapes and
    dtypes; draws scale by 1/sqrt(fan_in) (0.02 for the embeddings)."""
    ref_model, ref_params = ref_model_and_params()
    from repro_torch.models.transformer import TransformerLM

    params = TransformerLM(CFG, device="cpu").init_params(seed=0)
    ref_shapes = {
        tuple(k.key for k in p): tuple(v.shape)
        for p, v in jax.tree_util.tree_leaves_with_path(ref_params)
    }
    shapes = {p: tuple(v.shape) for p, v in layers._leaves(params)}
    assert shapes == ref_shapes
    # fan-in is the second-to-last axis, as in the reference (heads for wq)
    wq = params["blocks"]["wq"]
    assert abs(float(wq.float().std()) - CFG.n_heads ** -0.5) < 0.02
    w_up = params["blocks"]["mlp"]["w_up"]
    assert abs(float(w_up.float().std()) - CFG.d_model ** -0.5) < 0.01
    assert abs(float(params["embed"]["embedding"].float().std()) - 0.02) < 0.005
    assert torch.equal(params["blocks"]["q_norm"], torch.ones_like(params["blocks"]["q_norm"]))
    again = TransformerLM(CFG, device="cpu").init_params(seed=0)
    assert torch.equal(again["blocks"]["wq"], wq)
