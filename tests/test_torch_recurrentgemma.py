"""Port parity, RecurrentGemma: the float32 smoke configuration (8 layers:
2 periods of (rec, rec, attn) and a 2-layer rec tail, d_model 64, 4 query
heads on 1 KV head, window 8) on parameters carried from the reference's
``init_params`` through ``params_from_numpy``.

* ``prefill`` of ragged prompts (lengths 12, 9, 7 in a width of 12, so the
  window-8 ring wraps) against the reference: logits within 1e-4, and the
  cache's ``rnn_h``, ``conv_buf`` and valid ring entries within 1e-4
  (``pos`` and ``length`` exact). The states are held to the logits'
  tolerance, not tighter: on this random model a one-ulp change of the
  embedding alone moves the deepest layers' states by more than 1e-5 (the
  last test here measures it), and the two frameworks round differently at
  every matmul;
* then 12 greedy ``decode_step``s that wrap the ring again: identical
  tokens, logits within 1e-4, and the final states within 1e-3 (the same
  one-ulp change moves them further over those steps);
* ``forward``, the recurrent block on ragged prompts, and the wave loop
  ``chip_smoke.py`` serves with (``launch.generate.generate_waves``) against
  the same loop on the reference model;
* kernels 2 and 3 at the full model's attention shape (16 query heads on one
  KV head, head_dim 256) on CPU tensors against the reference's oracles on
  live rows.

Only real rows are compared: the reference masks pad keys by position -1,
the port's dense flash entry only causally, so pad query rows differ (they
are never read). The reference results are computed once per module."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import recurrentgemma_9b as ref_rg
from repro.kernels.ref import decode_attention_ref, flash_attention_ref
from repro.models.layers import init_params
from repro.models.recurrentgemma import RecurrentGemma as RefRG
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.data import gsm8k_like_workload
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.generate import generate_waves
from repro_torch.launch.serve import workload_spec
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import prompt_tokens
from repro_torch.models.recurrentgemma import RecurrentGemma
from repro_torch.models.registry import get_model
from repro_torch.serving.sampler import greedy
from torch_port_arrays import to_np

TOL = STATE_TOL = 1e-4
FINAL_STATE_TOL = 1e-3
REF_CFG = dataclasses.replace(ref_rg.SMOKE_CONFIG, dtype="float32")
CFG = ArchConfig(**dataclasses.asdict(REF_CFG))
LENGTHS = np.array([12, 9, 7], np.int32)
S, MAX_LEN, STEPS = 12, 32, 12


def _prompts():
    rng = np.random.default_rng(1)
    tok = rng.integers(1, CFG.vocab_size, size=(len(LENGTHS), S)).astype(np.int32)
    tok[np.arange(S)[None, :] >= LENGTHS[:, None]] = 0              # right padding
    return tok


@pytest.fixture(scope="module")
def models():
    ref_model = RefRG(REF_CFG)
    ref_params = init_params(jax.random.key(0), ref_model.param_defs())
    tree = jax.tree_util.tree_map(np.asarray, ref_params)
    return ref_model, ref_params, RecurrentGemma(CFG, device="cpu"), params_from_numpy(tree, CFG, "cpu")


@pytest.fixture(scope="module")
def runs(models):
    """Prefill then STEPS greedy decode steps on both models: (logits,
    tokens, cache after prefill) per step, each side in its own types."""
    ref_model, ref_params, model, params = models
    tok = _prompts()
    prefill = jax.jit(lambda p, t, c, l: ref_model.prefill(p, t, c, lengths=l))
    decode = jax.jit(ref_model.decode_step)
    jl, jc = prefill(ref_params, jnp.asarray(tok), ref_model.cache_init(len(LENGTHS), MAX_LEN),
                     jnp.asarray(LENGTHS))
    tl, tc = model.prefill(params, torch.from_numpy(tok), model.cache_init(len(LENGTHS), MAX_LEN),
                           lengths=torch.from_numpy(LENGTHS))
    j_pre = jax.tree_util.tree_map(np.asarray, jc)
    t_pre = jax.tree_util.tree_map(lambda x: to_np(x).copy(), tc)   # decode updates tc in place
    jsteps, tsteps = [np.asarray(jl)], [to_np(tl)]
    jt, tt = jnp.argmax(jl, -1).astype(jnp.int32), greedy(tl)
    for _ in range(STEPS):
        jl, jc = decode(ref_params, jt, jc)
        tl, tc = model.decode_step(params, tt, tc)
        jt, tt = jnp.argmax(jl, -1).astype(jnp.int32), greedy(tl)
        jsteps.append(np.asarray(jl))
        tsteps.append(to_np(tl))
    return dict(j_pre=j_pre, t_pre=t_pre, jl=jsteps, tl=tsteps,
                j_final=jax.tree_util.tree_map(np.asarray, jc), t_final=tc)


def _assert_states_close(jc, tc, tol=STATE_TOL):
    np.testing.assert_allclose(to_np(tc["rnn_h"]), jc["rnn_h"], rtol=tol, atol=tol)
    np.testing.assert_allclose(to_np(tc["conv_buf"]), jc["conv_buf"], rtol=tol, atol=tol)
    pos = np.asarray(jc["attn"]["pos"])
    np.testing.assert_array_equal(to_np(tc["attn"]["pos"]), pos)
    valid = pos >= 0                                                   # (B, W)
    for key in ("k", "v"):
        np.testing.assert_allclose(to_np(tc["attn"][key])[:, valid], np.asarray(jc["attn"][key])[:, valid],
                                   rtol=tol, atol=tol)
    for key in ("length",):
        np.testing.assert_array_equal(to_np(tc[key]), jc[key])
        np.testing.assert_array_equal(to_np(tc["attn"][key]), jc["attn"][key])


def test_param_tree_converts_bit_for_bit_with_float32_lam():
    ref_model = RefRG(ref_rg.SMOKE_CONFIG)                             # bf16
    ref_params = init_params(jax.random.key(0), ref_model.param_defs())
    cfg = ArchConfig(**dataclasses.asdict(ref_rg.SMOKE_CONFIG))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    assert set(params) == {"rec_a", "rec_b", "attn", "rec_tail", "embed", "norm_final"}
    assert params["rec_a"]["lam"].dtype == torch.float32
    assert params["rec_a"]["w_rgate"].dtype == torch.bfloat16
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref_params):
        node = params
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(to_np(node), np.asarray(leaf, np.float32))
    defs = RecurrentGemma(cfg, device="cpu").param_defs()
    assert defs["rec_tail"]["lam"].shape == (2, 64) and defs["attn"]["wq"].shape == (2, 64, 4, 16)


def test_full_size_config_and_parameter_count():
    """The full config: 38 layers (12 periods and a 2-layer tail), MQA at
    head_dim 256, 10.44 B parameters (counted from param_defs)."""
    cfg = get_config("recurrentgemma_9b")
    model = RecurrentGemma(cfg, device="cpu")
    assert (model.n_periods, model.n_tail_rec, model.n_rec, model.hd) == (12, 2, 26, 256)
    n = 0
    stack = [model.param_defs()]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        else:
            n += int(np.prod(node.shape))
    assert round(n / 1e9, 2) == 10.44
    shape = model.cache_shape(8, 640)
    assert shape["attn"]["k"] == (12, 8, 640, 1, 256) and shape["rnn_h"] == (26, 8, 4096)


def test_registry_maps_families():
    """hybrid → RecurrentGemma; dense, moe and vlm → TransformerLM; ssm →
    XLSTM; audio → Whisper, as in the reference; an unknown family raises."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.models.whisper import Whisper
    from repro_torch.models.xlstm import XLSTM

    assert isinstance(get_model(CFG, device="cpu"), RecurrentGemma)
    for arch in ("qwen3_8b", "olmoe_1b_7b", "qwen2_vl_7b"):
        assert isinstance(get_model(get_smoke_config(arch), device="cpu"), TransformerLM)
    assert isinstance(get_model(get_smoke_config("xlstm_350m"), device="cpu"), XLSTM)
    assert isinstance(get_model(get_smoke_config("whisper_small"), device="cpu"), Whisper)
    with pytest.raises(KeyError, match="family"):
        get_model(dataclasses.replace(CFG, family="diffusion"), device="cpu")


def test_prefill_matches_reference(runs):
    np.testing.assert_allclose(runs["tl"][0], runs["jl"][0], rtol=TOL, atol=TOL)
    assert (runs["tl"][0].argmax(-1) == runs["jl"][0].argmax(-1)).all()
    _assert_states_close(runs["j_pre"], runs["t_pre"])
    # the ring of W = 8 wrapped for the 12- and 9-token prompts
    assert (runs["t_pre"]["attn"]["pos"].max(axis=1) == LENGTHS - 1).all()


def test_decode_steps_match_reference_across_ring_wraps(runs):
    for jl, tl in zip(runs["jl"], runs["tl"]):
        np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
        np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    _assert_states_close(runs["j_final"], runs["t_final"], FINAL_STATE_TOL)
    assert to_np(runs["t_final"]["length"]).tolist() == (LENGTHS + STEPS).tolist()


def test_forward_matches_reference(models):
    ref_model, ref_params, model, params = models
    tok = _prompts()[:1]
    jl, _ = ref_model.forward(ref_params, jnp.asarray(tok), remat=False)
    tl, aux = model.forward(params, torch.from_numpy(tok), remat=False)
    assert float(aux) == 0.0
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=TOL, atol=TOL)


def test_ragged_rec_block_matches_reference(models):
    """One recurrent block on ragged prompts from a non-zero state: output on
    real rows, the frozen final state and the conv buffer of the last real
    inputs."""
    ref_model, ref_params, model, params = models
    rng = np.random.default_rng(5)
    h = rng.standard_normal((3, S, CFG.d_model)).astype(np.float32)
    h0 = rng.standard_normal((3, CFG.d_model)).astype(np.float32)
    buf = rng.standard_normal((3, CFG.conv1d_width - 1, CFG.d_model)).astype(np.float32)
    lp = jax.tree_util.tree_map(lambda a: a[1], ref_params["rec_b"])
    jo, jh, jb = ref_model._rec_block_seq(jnp.asarray(h), lp, jnp.asarray(h0), jnp.asarray(buf),
                                          jnp.asarray(LENGTHS))
    to, th, tb = model._rec_block_seq(torch.from_numpy(h), model._layer_views(params)["rec_b"][1],
                                      torch.from_numpy(h0), torch.from_numpy(buf),
                                      torch.from_numpy(LENGTHS))
    live = np.arange(S)[None, :] < LENGTHS[:, None]
    np.testing.assert_allclose(to_np(to)[live], np.asarray(jo)[live], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(to_np(th), np.asarray(jh), rtol=STATE_TOL, atol=STATE_TOL)
    np.testing.assert_allclose(to_np(tb), np.asarray(jb), rtol=STATE_TOL, atol=STATE_TOL)


def test_two_wave_generation_matches_the_same_loop_on_the_reference(models):
    """The wave loop chip_smoke.py serves RecurrentGemma with: two waves of 3
    slots, each a ragged prefill then greedy decode steps until every
    request of the wave has its budget; the same loop on the reference model
    gives the same tokens for every request."""
    ref_model, ref_params, model, params = models
    reqs = gsm8k_like_workload(workload_spec(6), seed=3, known_lengths=True)
    width = max(r.n_prefill for r in reqs)
    res = generate_waves(model, params, reqs, n_slots=3, max_len=MAX_LEN, prefill_len=width)
    prefill = jax.jit(lambda p, t, c, l: ref_model.prefill(p, t, c, lengths=l))
    decode = jax.jit(ref_model.decode_step)
    steps = 0
    for w0 in (0, 3):
        wave = reqs[w0 : w0 + 3]
        tok = np.zeros((3, width), np.int32)
        for i, r in enumerate(wave):
            tok[i, : r.n_prefill] = prompt_tokens(r, CFG.vocab_size)
        lens = jnp.asarray([r.n_prefill for r in wave], jnp.int32)
        logits, cache = prefill(ref_params, jnp.asarray(tok), ref_model.cache_init(3, MAX_LEN), lens)
        cur = jnp.argmax(logits, -1).astype(jnp.int32)
        out = [np.asarray(cur)]
        for _ in range(max(r.n_decode for r in wave) - 1):
            logits, cache = decode(ref_params, cur, cache)
            cur = jnp.argmax(logits, -1).astype(jnp.int32)
            out.append(np.asarray(cur))
        steps += len(out) - 1
        for i, r in enumerate(wave):
            assert res.generated[r.rid] == [int(t[i]) for t in out[: r.n_decode]], r.rid
    assert (res.prefills, res.decode_steps) == (2, steps)
    assert res.tokens == sum(r.n_decode for r in reqs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_wrappers_at_mqa_head_dim_256_match_the_oracles(dtype):
    """Kernels 2 (dense entry) and 3 at recurrentgemma's attention shape on
    CPU tensors: 16 query heads on one KV head, head_dim 256; ragged decode
    lengths compared on live rows (the oracle gives the mean of V on the
    empty one, the kernels 0)."""
    tol = 2e-5 if dtype == "float32" else 2e-2
    tdt, jdt = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    rng = np.random.default_rng(256)
    b, h, kv, d, s = 3, 16, 1, 256, 40
    mk = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    q, k, v = mk(b, h, s, d), mk(b, kv, s, d), mk(b, kv, s, d)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    for window in (2048, 8):
        out = fa.flash_attention(tq, tk, tv, causal=True, window=window)
        ref = flash_attention_ref(jq, jk, jv, causal=True, window=window)
        np.testing.assert_allclose(to_np(out), to_np(ref), rtol=tol, atol=tol)
    lengths = np.array([40, 17, 0], np.int32)
    out = da.decode_attention(tq[:, :, 0], tk, tv, torch.from_numpy(lengths))
    ref = decode_attention_ref(jq[:, :, 0], jk, jv, jnp.asarray(lengths))
    np.testing.assert_allclose(to_np(out)[:2], to_np(ref)[:2], rtol=tol, atol=tol)
    assert not to_np(out)[2].any()


def test_state_tolerances_sit_above_the_models_own_conditioning(models):
    """Why the states are held to 1e-4 after the prefill and 1e-3 after the
    decode steps: perturbing the embedding table by one float32 ulp (relative
    1.2e-7, seeded) moves the port's own deepest states by more than 1e-5 —
    a tighter tolerance would test rounding, not the port — and by less than
    the tolerances used above (in allclose's terms, atol = rtol = tol)."""
    _, _, model, params = models
    noisy = dict(params, embed=dict(params["embed"]))
    emb = params["embed"]["embedding"]
    g = torch.Generator().manual_seed(0)
    noisy["embed"]["embedding"] = emb * (1 + 1.2e-7 * torch.randn(emb.shape, generator=g))
    states = []
    for p in (params, noisy):
        cache = model.cache_init(len(LENGTHS), MAX_LEN)
        logits, cache = model.prefill(p, torch.from_numpy(_prompts()), cache,
                                      lengths=torch.from_numpy(LENGTHS))
        pre = {k: cache[k].clone() for k in ("rnn_h", "conv_buf")}
        cur = greedy(logits)
        for _ in range(STEPS):
            logits, cache = model.decode_step(p, cur, cache)
            cur = greedy(logits)
        states.append((pre, cache))
    def shift(i, scaled):
        return max(float(((states[0][i][k] - states[1][i][k]).abs()
                          / (1 + states[0][i][k].abs() if scaled else 1)).max())
                   for k in ("rnn_h", "conv_buf"))

    assert shift(0, scaled=False) > 1e-5
    assert shift(0, scaled=True) < STATE_TOL and shift(1, scaled=True) < FINAL_STATE_TOL
