"""The port's optimizer, train step and train loop against the reference's
(``repro.train``), on the CPU: AdamW on identical numpy gradients (clip and
warmup included), the ports of the reference's optimizer tests, microbatch
accumulation in bf16 and float32 against the reference's step, the
synthetic batches, loss decrease, resume, and one train step per smoke arch
(the port of ``test_models.py::test_smoke_forward_and_train_step``).

AdamW's first steps are sign-like (m̂/√v̂ ≈ ±1): where a gradient element is
near 0, two frameworks whose gradients differ in the last bits can step in
opposite directions by 2·lr. So the optimizer is compared on identical
gradients, tightly, and the gradients are compared on their own; no test
compares parameters after a step on gradients each framework computed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models.layers import init_params as ref_init_params
from repro.models.registry import get_model as ref_get_model
from repro.train import optimizer as ref_opt
from repro.train import train_loop as ref_loop
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ArchConfig
from repro_torch.models.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.models.layers import _leaves, tree_map
from repro_torch.models.registry import get_model
from repro_torch.train import optimizer as opt
from repro_torch.train import train_loop
from repro_torch.train.train_step import make_train_step
from torch_port_helpers import FAMILY_ARCHS


def _np(tree):
    return {path: np.asarray(x, np.float32) for path, x in _leaves(
        jax.tree_util.tree_map(np.asarray, tree))}


def _t(tree):
    return {path: x.detach().float().numpy() for path, x in _leaves(tree)}


def _tree_from(flat, conv):
    out = {}
    for path, x in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = conv(x)
    return out


# --------------------------------------------------------------------------- #
# AdamW                                                                       #
# --------------------------------------------------------------------------- #
def test_adamw_on_identical_gradients_matches_the_reference():
    """Four steps on the same numpy gradients (large enough that the first
    two are clipped, near-zero elements included, warmup over three steps):
    float32 params, moments, count, grad_norm and lr within 2e-6 relative
    (float32 rounding: pow, sqrt and the norm's summation order)."""
    rng = np.random.default_rng(0)
    shapes = {("a",): (3, 5), ("blocks", "w"): (2, 4, 3), ("blocks", "n", "scale"): (2, 7)}
    params = {p: rng.standard_normal(s).astype(np.float32) for p, s in shapes.items()}
    cfg = dict(lr=0.05, weight_decay=0.1, grad_clip_norm=1.0, warmup_steps=3)
    ref_p = _tree_from(params, jnp.asarray)
    ref_state = ref_opt.adamw_init(ref_p)
    p = _tree_from(params, torch.from_numpy)
    state = opt.adamw_init(p)
    for step in range(4):
        scale = 10.0 if step < 2 else 0.1
        grads = {k: (scale * rng.standard_normal(s) * (rng.random(s) > 0.2)).astype(np.float32)
                 for k, s in shapes.items()}
        ref_p, ref_state, ref_m = ref_opt.adamw_update(
            _tree_from(grads, jnp.asarray), ref_state, ref_p, ref_opt.AdamWConfig(**cfg))
        p, state, m = opt.adamw_update(_tree_from(grads, torch.from_numpy), state, p,
                                       opt.AdamWConfig(**cfg))
        assert int(state["count"]) == int(ref_state["count"]) == step + 1
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(ref_m[key]), rtol=2e-6)
        for got, ref in ((p, ref_p), (state["m"], ref_state["m"]), (state["v"], ref_state["v"])):
            ref = _np(ref)
            for path, x in _t(got).items():
                np.testing.assert_allclose(x, ref[path], rtol=2e-6, atol=1e-7, err_msg=str(path))


def test_adamw_bf16_params_keep_float32_moments():
    """bf16 parameters: float32 moments, the update in float32, cast back;
    equal to the reference's on the same gradients within one bf16 step."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    g = rng.standard_normal((4, 6)).astype(np.float32)
    cfg = dict(lr=0.01, warmup_steps=1)
    ref_p, _, _ = ref_opt.adamw_update({"w": jnp.asarray(g)}, ref_opt.adamw_init(
        {"w": jnp.asarray(w, jnp.bfloat16)}), {"w": jnp.asarray(w, jnp.bfloat16)},
        ref_opt.AdamWConfig(**cfg))
    p = {"w": torch.from_numpy(w).bfloat16()}
    state = opt.adamw_init(p)
    assert state["m"]["w"].dtype == torch.float32 and state["count"].dtype == torch.int32
    p, state, _ = opt.adamw_update({"w": torch.from_numpy(g)}, state, p, opt.AdamWConfig(**cfg))
    assert p["w"].dtype == torch.bfloat16
    np.testing.assert_allclose(p["w"].float().numpy(), np.asarray(ref_p["w"], np.float32),
                               rtol=2 ** -7, atol=0)


def test_adamw_updates_in_slices_equal_to_whole(monkeypatch):
    """A leaf updated slice by slice (a stacked layer at a time) gets the
    values of a whole-leaf update: the arithmetic is elementwise."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((6, 5, 4)).astype(np.float32)
    g = rng.standard_normal((6, 5, 4)).astype(np.float32)
    out = []
    for slice_elems in (1 << 26, 20):
        monkeypatch.setattr(opt, "_SLICE", slice_elems)
        p = {"w": torch.from_numpy(w.copy())}
        p, state, m = opt.adamw_update({"w": torch.from_numpy(g)}, opt.adamw_init(p), p,
                                       opt.AdamWConfig(warmup_steps=1))
        out.append((p["w"], state["m"]["w"], state["v"]["w"], m["grad_norm"]))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


def test_adamw_moves_toward_minimum():
    params = {"w": torch.tensor([4.0, -2.0])}
    state = opt.adamw_init(params)
    cfg = opt.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}  # d/dw ||w||²
        params, state, _ = opt.adamw_update(grads, state, params, cfg)
    assert float(params["w"].abs().max()) < 0.05


def test_grad_clip_bounds_update():
    params = {"w": torch.zeros(4)}
    state = opt.adamw_init(params)
    cfg = opt.AdamWConfig(lr=1.0, grad_clip_norm=1.0, weight_decay=0.0, warmup_steps=1)
    huge = {"w": torch.full((4,), 1e9)}
    params2, _, metrics = opt.adamw_update(huge, state, params, cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(2e9, rel=1e-5)
    assert float(params2["w"].abs().max()) <= 1.001  # lr * normalized step


# --------------------------------------------------------------------------- #
# The train step                                                              #
# --------------------------------------------------------------------------- #
def _granite(dtype):
    ref_cfg = dataclasses.replace(ref_smoke_config("granite_3_8b"), dtype=dtype)
    ref_model = ref_get_model(ref_cfg)
    ref_params = ref_init_params(jax.random.key(0), ref_model.param_defs())
    cfg = ArchConfig(**dataclasses.asdict(ref_cfg))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, size=(4, 16)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, 1)}
    return ref_model, ref_params, get_model(cfg, device="cpu"), params, batch


def _reference_accumulated_grads(ref_model, params, batch, microbatches, accum_dtype):
    """The reference step's gradient (``repro/train/train_step.py``: each
    microbatch's gradient / n, cast to ``accum_dtype``, summed from zeros in
    that dtype), with its own ``value_and_grad``."""
    vg = jax.jit(jax.value_and_grad(lambda p, mb: ref_model.loss(p, mb, remat=False)))
    gsum = jax.tree_util.tree_map(lambda p: jnp.zeros(p.shape, accum_dtype), params)
    n = batch["tokens"].shape[0] // microbatches
    for i in range(microbatches):
        mb = {k: jnp.asarray(v[i * n:(i + 1) * n]) for k, v in batch.items()}
        _, g = vg(params, mb)
        gsum = jax.tree_util.tree_map(lambda a, x: a + (x / microbatches).astype(accum_dtype),
                                      gsum, g)
    return _np(gsum)


@pytest.mark.parametrize("accum", ["float32", "bfloat16"])
def test_microbatch_accumulation_matches_the_reference(accum, monkeypatch):
    """Four microbatches of the float32 smoke Granite: the accumulated
    gradient AdamW receives equals the reference's (float32 sum: 1e-4 of
    each leaf's largest magnitude; bf16 sum: each term rounds to bf16 on
    both sides, so 2e-2, the bf16 tolerance), and the step's loss and
    grad_norm equal the reference step's."""
    ref_model, ref_params, model, params, batch = _granite("float32")
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[accum]
    ref_grads = _reference_accumulated_grads(ref_model, ref_params, batch, 4, jdt)
    ref_step = jax.jit(ref_make_train_step(ref_model, ref_opt.AdamWConfig(warmup_steps=1),
                                           microbatches=4, remat=False, accum_dtype=jdt))
    _, _, ref_m = ref_step(ref_params, ref_opt.adamw_init(ref_params),
                           {k: jnp.asarray(v) for k, v in batch.items()})

    seen = {}
    real = opt.adamw_update
    monkeypatch.setattr("repro_torch.train.train_step.adamw_update",
                        lambda g, *a: seen.setdefault("g", tree_map(torch.clone, g)) and real(g, *a))
    step = make_train_step(model, opt.AdamWConfig(warmup_steps=1), microbatches=4, remat=False,
                           accum_dtype=tdt)
    _, state, m = step(params, opt.adamw_init(params),
                       {k: torch.from_numpy(v) for k, v in batch.items()})
    tol = 1e-4 if accum == "float32" else 2e-2
    for path, g in _leaves(seen["g"]):
        assert g.dtype == tdt
        ref = ref_grads[path]
        err = float(np.abs(g.float().numpy() - ref).max() / max(np.abs(ref).max(), 1e-30))
        assert err <= tol, f"{path}: {err:.3g}"
    assert int(state["count"]) == 1
    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(ref_m["grad_norm"]), rtol=tol)


def test_microbatch_accumulation_matches_single_batch():
    """The port of the reference's test: a float32-accumulated 4-microbatch
    step ≈ the single-batch step (bf16 smoke Granite)."""
    _, _, model, params, batch = _granite("bfloat16")
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    s1 = make_train_step(model, opt.AdamWConfig(warmup_steps=1), microbatches=1)
    s4 = make_train_step(model, opt.AdamWConfig(warmup_steps=1), microbatches=4,
                         accum_dtype=torch.float32)
    p1, _, m1 = s1(tree_map(torch.clone, params), opt.adamw_init(params), batch)
    p4, _, m4 = s4(tree_map(torch.clone, params), opt.adamw_init(params), batch)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=2e-2)
    l1 = [x for _, x in _leaves(p1)][3]
    l4 = [x for _, x in _leaves(p4)][3]
    np.testing.assert_allclose(l1.float().numpy(), l4.float().numpy(), rtol=0.1, atol=5e-3)


def test_batch_must_divide_into_microbatches():
    _, _, model, params, batch = _granite("float32")
    step = make_train_step(model, microbatches=3)
    with pytest.raises(ValueError, match="not divisible by 3 microbatches"):
        step(params, opt.adamw_init(params), {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("arch", ("qwen3_8b",) + FAMILY_ARCHS)
def test_smoke_forward_and_train_step(arch):
    """One forward and one full train step (two microbatches, AdamW) per
    smoke arch, bf16 as configured: finite, count 1, parameters changed."""
    cfg = get_smoke_config(arch)
    model = get_model(cfg, device="cpu")
    params = model.init_params(0)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(np.roll(tokens, -1, 1))}
    if cfg.num_patch_tokens:
        batch["patch_embeds"] = torch.from_numpy(
            rng.normal(size=(2, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32))
    assert torch.isfinite(model.loss(params, batch, remat=False))
    before = tree_map(torch.clone, params)
    step = make_train_step(model, opt.AdamWConfig(lr=1e-3, warmup_steps=1), microbatches=2)
    new_params, state, m = step(params, opt.adamw_init(params), batch)
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"]) and float(m["grad_norm"]) > 0
    assert int(state["count"]) == 1
    changed = [not torch.equal(a, b) for (_, a), (_, b) in zip(_leaves(before), _leaves(new_params))]
    assert any(changed)
    assert all(a.shape == b.shape for (_, a), (_, b) in zip(_leaves(before), _leaves(new_params)))


# --------------------------------------------------------------------------- #
# The train loop                                                              #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["qwen3_8b", "qwen2_vl_7b", "whisper_small"])
def test_synthetic_batches_equal_the_reference(arch):
    tc = train_loop.TrainConfig(batch=3, seq=12, seed=5)
    ref = ref_loop.synthetic_batches(ref_smoke_config(arch),
                                     ref_loop.TrainConfig(batch=3, seq=12, seed=5))
    port = train_loop.synthetic_batches(get_smoke_config(arch), tc)
    for _ in range(3):
        a, b = next(ref), next(port)
        assert set(a) == set(b)
        for k in a:
            assert b[k].dtype == {"int32": torch.int32, "bfloat16": torch.bfloat16}[str(a[k].dtype)]
            np.testing.assert_array_equal(b[k].float().numpy(), np.asarray(a[k], np.float32))


def test_train_loss_decreases():
    cfg = get_smoke_config("qwen3_8b")
    out = train_loop.train(cfg, train_loop.TrainConfig(steps=60, batch=4, seq=32, log_every=0),
                           opt.AdamWConfig(lr=5e-3, warmup_steps=5), device="cpu")
    assert out["last_loss"] < out["first_loss"] - 0.3


def test_resumed_run_equals_an_uninterrupted_one(tmp_path):
    """6 steps, a checkpoint, a resume for 3 more: the same losses and
    parameters as 9 steps in one run (bit for bit on the CPU)."""
    cfg = dataclasses.replace(get_smoke_config("granite_3_8b"), dtype="float32")
    kw = dict(batch=2, seq=16, save_every=3, log_every=0)
    whole = train_loop.train(cfg, train_loop.TrainConfig(steps=9, **kw), device="cpu")
    first = train_loop.train(cfg, train_loop.TrainConfig(steps=6, checkpoint_dir=str(tmp_path), **kw),
                             device="cpu")
    rest = train_loop.train(cfg, train_loop.TrainConfig(steps=9, checkpoint_dir=str(tmp_path), **kw),
                            device="cpu")
    assert (first["steps_run"], rest["start_step"], rest["steps_run"]) == (6, 6, 3)
    assert first["losses"] + rest["losses"] == whole["losses"]
    for (_, a), (_, b) in zip(_leaves(whole["params"]), _leaves(rest["params"])):
        assert torch.equal(a, b)
    assert int(rest["opt_state"]["count"]) == 9


def test_opt_state_from_numpy_carries_the_reference_state():
    ref_model, ref_params, _, _, _ = _granite("bfloat16")
    state = ref_opt.adamw_init(ref_params)
    state = dict(state, count=jnp.asarray(7, jnp.int32))
    cfg = ArchConfig(**dataclasses.asdict(ref_model.cfg))
    port = opt_state_from_numpy(jax.tree_util.tree_map(np.asarray, state), cfg, "cpu")
    assert int(port["count"]) == 7 and port["count"].dtype == torch.int32
    for tree in (port["m"], port["v"]):
        for _, x in _leaves(tree):
            assert x.dtype == torch.float32 and not x.any()
