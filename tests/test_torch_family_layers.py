"""Port parity, the layer options of the other decoders: layernorm (with and
without its bias), the squared-ReLU and GELU MLPs with their biases, and
M-RoPE on distinct (t, h, w) triples, against the reference's layers on the
same float32 inputs (allclose 1e-5); the parameter declarations they add;
``prefill`` with ``patch_embeds`` (the VLM stub's prefix) against the
reference's; the float32 router leaf of a bf16 MoE tree through
``params_from_numpy``; and the kernels' wrappers on CPU tensors at a
head_dim no kernel has a variant for (the smoke StarCoder2's 12)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import layers as ref_layers
from repro.models.transformer import TransformerLM as RefLM
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_decode_attention as pda
from repro_torch.models import layers
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import _leaves
from repro_torch.models.transformer import TransformerLM
from torch_port_arrays import to_np
from torch_port_helpers import family_models

TOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("with_bias", [True, False])
def test_layer_norm_matches_reference(with_bias):
    x = (3.0 + 2.0 * _rng(0).standard_normal((3, 5, 72))).astype(np.float32)
    w = _rng(1).standard_normal(72).astype(np.float32)
    b = _rng(2).standard_normal(72).astype(np.float32) if with_bias else None
    ref = ref_layers.layer_norm(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b), 1e-5)
    out = layers.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                            None if b is None else torch.from_numpy(b), 1e-5)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), rtol=TOL, atol=TOL)
    p = {"scale": torch.from_numpy(w)} | ({} if b is None else {"bias": torch.from_numpy(b)})
    np.testing.assert_array_equal(to_np(layers.apply_norm(torch.from_numpy(x), p, "layernorm", 1e-5)),
                                  to_np(out))


def test_layer_norm_bf16_matches_reference():
    x = _rng(3).standard_normal((2, 4, 64)).astype(np.float32)
    w, b = (_rng(s).standard_normal(64).astype(np.float32) for s in (4, 5))
    ref = ref_layers.layer_norm(*(jnp.asarray(a, jnp.bfloat16) for a in (x, w, b)), 1e-5)
    out = layers.layer_norm(*(torch.from_numpy(a).bfloat16() for a in (x, w, b)), 1e-5)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(to_np(out.float()), np.asarray(ref.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("kind", ["gelu", "squared_relu"])
@pytest.mark.parametrize("use_bias", [True, False])
def test_mlp_kinds_match_reference(kind, use_bias):
    d, f = 24, 40
    rng = _rng(6)
    p = {"w_up": rng.standard_normal((d, f)) / np.sqrt(d), "w_down": rng.standard_normal((f, d)) / np.sqrt(f)}
    if use_bias:
        p |= {"b_up": rng.standard_normal(f), "b_down": rng.standard_normal(d)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 3, d)).astype(np.float32) * 2
    ref = ref_layers.mlp_apply(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, kind)
    out = layers.mlp_apply(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()}, kind)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), rtol=TOL, atol=TOL)


def test_gelu_is_the_tanh_form():
    """``jax.nn.gelu`` defaults to the tanh approximation; the erf form
    differs from it by up to ~5e-4, which the 1e-5 parity would catch."""
    h = torch.linspace(-4, 4, 101)
    ours = layers.mlp_activation(h, "gelu", torch.float32)
    np.testing.assert_allclose(to_np(ours), np.asarray(jax.nn.gelu(jnp.asarray(to_np(h)))),
                               rtol=TOL, atol=TOL)
    assert float((ours - torch.nn.functional.gelu(h)).abs().max()) > 1e-4


def test_param_defs_of_the_options():
    """layernorm adds a zero bias to each norm; biases add bq/bk/bv/bo and
    the MLP's b_up/b_down; MoE puts a float32 router and stacked experts in
    place of the MLP: the same tree as the reference's, leaf for leaf."""
    for arch in ("starcoder2_7b", "nemotron_4_15b", "olmoe_1b_7b", "qwen2_vl_7b"):
        ref = dict(_leaves(jax.tree_util.tree_map(
            lambda d: (d.shape, jnp.dtype(d.dtype).name), RefLM(ref_smoke_config(arch)).param_defs(),
            is_leaf=lambda x: isinstance(x, ref_layers.ParamDef))))
        ours = {path: (d.shape, str(d.dtype).split(".")[1])
                for path, d in _leaves(TransformerLM(get_smoke_config(arch), device="cpu").param_defs())}
        assert ours == ref, arch
    defs = TransformerLM(get_smoke_config("starcoder2_7b"), device="cpu").param_defs()
    assert defs["blocks"]["norm_attn"]["bias"].init == "zeros"
    assert {"bq", "bk", "bv", "bo"} <= set(defs["blocks"]) and "b_up" in defs["blocks"]["mlp"]


def test_router_stays_float32_in_a_bf16_tree():
    cfg = get_smoke_config("olmoe_1b_7b")
    assert cfg.dtype == "bfloat16"
    ref_model = RefLM(ref_smoke_config("olmoe_1b_7b"))
    from repro.models.layers import init_params

    tree = jax.tree_util.tree_map(np.asarray, init_params(jax.random.key(1), ref_model.param_defs()))
    params = params_from_numpy(tree, cfg, "cpu")
    moe = params["blocks"]["moe"]
    assert moe["router"].dtype == torch.float32 and moe["w_up"].dtype == torch.bfloat16
    np.testing.assert_array_equal(to_np(moe["router"]), tree["blocks"]["moe"]["router"])
    assert torch.equal(moe["w_down"].view(torch.int16),
                       torch.from_numpy(tree["blocks"]["moe"]["w_down"].view(np.int16).copy()))


@pytest.mark.parametrize("sections,hd", [((16, 24, 24), 128), ((2, 3, 3), 16)])
def test_apply_m_rope_matches_reference_on_distinct_triples(sections, hd):
    """Distinct (t, h, w) positions: each section rotates by its own stream,
    so a wrong split shows (equal streams would reduce M-RoPE to RoPE)."""
    x = _rng(7).standard_normal((2, 5, 3, hd)).astype(np.float32)
    pos = _rng(8).integers(0, 500, size=(2, 5, 3)).astype(np.int32)
    assert (pos[..., 0] != pos[..., 1]).any() and (pos[..., 1] != pos[..., 2]).any()
    for theta in (10_000.0, 1_000_000.0):
        ref = ref_layers.apply_m_rope(jnp.asarray(x), jnp.asarray(pos), sections, theta)
        out = layers.apply_m_rope(torch.from_numpy(x), torch.from_numpy(pos), sections, theta)
        np.testing.assert_allclose(to_np(out), np.asarray(ref), rtol=TOL, atol=TOL)
    # a wrong section split gives another rotation
    wrong = (sections[1], sections[0], sections[2])
    out_wrong = layers.apply_m_rope(torch.from_numpy(x), torch.from_numpy(pos), wrong, theta)
    assert float((out_wrong - out).abs().max()) > 1e-3
    # equal streams: M-RoPE is RoPE
    same = np.repeat(pos[..., :1], 3, axis=-1)
    np.testing.assert_array_equal(
        to_np(layers.apply_m_rope(torch.from_numpy(x), torch.from_numpy(same), sections, theta)),
        to_np(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(same[..., 0]), theta)))
    with pytest.raises(ValueError, match="sections"):
        layers.apply_m_rope(torch.from_numpy(x), torch.from_numpy(pos), (1, 1, 1), theta)


def test_prefill_with_patch_embeds_matches_reference():
    """The VLM stub's prefix: ``patch_embeds`` replace the first P token
    embeddings in the port's prefill as in the reference's."""
    ref_model, ref_params, model, params = family_models("qwen2_vl_7b")
    b, s, p = 2, 12, model.cfg.num_patch_tokens
    tok = _rng(9).integers(1, 256, size=(b, s)).astype(np.int32)
    lengths = np.array([12, 9], np.int32)
    patches = _rng(10).standard_normal((b, p, model.cfg.d_model)).astype(np.float32)
    jc = ref_model.cache_init(b, 16)
    jl, jc = ref_model.prefill(ref_params, jnp.asarray(tok), jc, jnp.asarray(patches),
                               lengths=jnp.asarray(lengths))
    tc = model.cache_init(b, 16)
    tl, tc = model.prefill(params, torch.from_numpy(tok), tc, torch.from_numpy(patches),
                           lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to_np(tc["k"]), np.asarray(jc["k"]), rtol=1e-4, atol=1e-4)
    plain, _ = model.prefill(params, torch.from_numpy(tok), model.cache_init(b, 16),
                             lengths=torch.from_numpy(lengths))
    assert float((plain - tl).abs().max()) > 1e-3          # the patches changed the result


def test_wrappers_run_their_plain_versions_at_any_head_dim_on_the_cpu():
    """The smoke StarCoder2's head_dim of 12: CPU tensors take each kernel's
    plain version; the kernels (CUDA tensors) have no such variant."""
    d = get_smoke_config("starcoder2_7b").resolved_head_dim
    assert d == 12
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 6, d, generator=g)
    k = torch.randn(2, 2, 8, d, generator=g)
    lens = torch.tensor([8, 3], dtype=torch.int32)
    assert torch.equal(da.decode_attention(q, k, k, lens), da.decode_attention_plain(q, k, k, lens))
    pool = torch.randn(2, 4, 4, d, generator=g)
    tables = torch.tensor([[0, 1], [2, -1]], dtype=torch.int32)
    assert torch.equal(pda.paged_decode_attention(q[:, None], pool, pool, tables, lens),
                       pda.paged_decode_attention_plain(q[:, None], pool, pool, tables, lens))
    qd = torch.randn(2, 6, 8, d, generator=g)
    assert torch.equal(fa.flash_attention(qd, k, k), fa.flash_attention_plain(qd, k, k))
    for mod in (da, pda, fa):
        with pytest.raises(ValueError, match="head_dim 12"):
            fa.check_head_dim(mod.__name__, d, mod._HEAD_DIMS)
