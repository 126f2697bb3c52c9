"""The port's checkpoints in the reference's on-disk format: the reference's
three checkpoint tests ported, a checkpoint the reference writes restored by
the port bit for bit (bf16 included) and the reverse, and a reference
training run stopped at step 6 and resumed by the port's ``train()``, whose
steps 7-9 give the reference's own resumed losses (1e-5: float32 smoke
Granite; the two frameworks' gradients differ in the last bits)."""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.checkpoint import restore_checkpoint as ref_restore
from repro.checkpoint import save_checkpoint as ref_save
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models.layers import init_params as ref_init_params
from repro.models.registry import get_model as ref_get_model
from repro.train import optimizer as ref_opt
from repro.train import train_loop as ref_loop
from repro_torch.checkpoint import (
    CheckpointManager,
    latest_step,
    latest_steps,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.configs.base import ArchConfig
from repro_torch.models.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.models.layers import _leaves
from repro_torch.train import train_loop


def _tree():
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "nested": {"b": torch.ones((2, 2), dtype=torch.bfloat16) * 1.5},
        "c": torch.tensor(7, dtype=torch.int32),
    }


def test_checkpoint_roundtrip_bf16_exact(tmp_path):
    tree = _tree()
    save_checkpoint(tmp_path, 5, tree, metadata={"note": "x"})
    restored, meta = restore_checkpoint(tmp_path, target=tree)
    assert meta["note"] == "x"
    for (_, a), (_, b) in zip(_leaves(tree), _leaves(restored)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_checkpoint_atomicity_ignores_incomplete(tmp_path):
    tree = _tree()
    save_checkpoint(tmp_path, 1, tree)
    # fake a crashed step-2: directory without COMPLETE marker
    (tmp_path / "step_00000002").mkdir()
    (tmp_path / "step_00000002" / "arrays.npz").write_bytes(b"garbage")
    assert latest_step(tmp_path) == 1
    restored, _ = restore_checkpoint(tmp_path, target=tree)
    assert torch.equal(restored["a"], tree["a"])


def test_checkpoint_prune_keeps_latest(tmp_path):
    tree = {"x": torch.zeros(3)}
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(tmp_path, s, tree, keep=2)
    assert latest_steps(tmp_path) == [4, 5]


def _reference_state():
    """The bf16 smoke Granite's parameters and an AdamW state after one
    update, from the reference."""
    ref_cfg = ref_smoke_config("granite_3_8b")
    model = ref_get_model(ref_cfg)
    params = ref_init_params(jax.random.key(0), model.param_defs())
    grads = jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    params, state, _ = ref_opt.adamw_update(grads, ref_opt.adamw_init(params), params,
                                            ref_opt.AdamWConfig(warmup_steps=1))
    return ArchConfig(**dataclasses.asdict(ref_cfg)), {"params": params, "opt": state}


def _bits(x):
    """Raw bits of a leaf as numpy, from either package."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def test_reference_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    cfg, ref_tree = _reference_state()
    ref_save(tmp_path, 3, ref_tree, metadata={"step": 3})
    np_tree = jax.tree_util.tree_map(np.asarray, ref_tree)
    zeros = lambda t: torch.zeros_like(t)
    target = {"params": params_from_numpy(np_tree["params"], cfg, "cpu"),
              "opt": opt_state_from_numpy(np_tree["opt"], cfg, "cpu")}
    target = jax.tree_util.tree_map(zeros, target)
    restored, meta = restore_checkpoint(tmp_path, target=target)
    assert meta == {"step": 3}
    ref_flat = dict(_leaves(np_tree))
    got = dict(_leaves(restored))
    assert set(got) == set(ref_flat)
    for path, x in got.items():
        assert str(x.dtype).split(".")[1] == ref_flat[path].dtype.name, path
        np.testing.assert_array_equal(_bits(x), _bits(ref_flat[path]), err_msg=str(path))


def test_port_checkpoint_restores_in_the_reference_bit_for_bit(tmp_path):
    cfg, ref_tree = _reference_state()
    np_tree = jax.tree_util.tree_map(np.asarray, ref_tree)
    port_tree = {"params": params_from_numpy(np_tree["params"], cfg, "cpu"),
                 "opt": opt_state_from_numpy(np_tree["opt"], cfg, "cpu")}
    save_checkpoint(tmp_path, 4, port_tree, metadata={"step": 4})
    target = jax.tree_util.tree_map(jnp.zeros_like, ref_tree)
    restored, meta = ref_restore(tmp_path, target=target)
    assert meta == {"step": 4}
    want = dict(_leaves(port_tree))
    for path, x in _leaves(jax.tree_util.tree_map(np.asarray, restored)):
        assert x.dtype.name == str(want[path].dtype).split(".")[1], path
        np.testing.assert_array_equal(_bits(x), _bits(want[path]), err_msg=str(path))


def test_reference_run_resumed_by_the_port(tmp_path):
    """The reference trains 6 steps (a checkpoint every 3); the port's
    train() resumes from that checkpoint for steps 7-9, and so does the
    reference from a copy of it: the same first and last losses."""
    ref_cfg = dataclasses.replace(ref_smoke_config("granite_3_8b"), dtype="float32")
    cfg = ArchConfig(**dataclasses.asdict(ref_cfg))
    kw = dict(batch=2, seq=16, save_every=3, log_every=0)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_loop.train(ref_cfg, ref_loop.TrainConfig(steps=6, checkpoint_dir=str(ref_dir), **kw))
    shutil.copytree(ref_dir, port_dir)
    ref = ref_loop.train(ref_cfg, ref_loop.TrainConfig(steps=9, checkpoint_dir=str(ref_dir), **kw))
    port = train_loop.train(cfg, train_loop.TrainConfig(steps=9, checkpoint_dir=str(port_dir), **kw),
                            device="cpu")
    assert (port["start_step"], port["steps_run"]) == (ref["start_step"], ref["steps_run"]) == (6, 3)
    assert abs(port["losses"][0] - ref["first_loss"]) <= 1e-5
    assert abs(port["losses"][-1] - ref["last_loss"]) <= 1e-5
    assert int(port["opt_state"]["count"]) == 9
    # the port's step-9 checkpoint restores in the reference
    restored, meta = ref_restore(port_dir, target=jax.tree_util.tree_map(
        jnp.zeros_like, {"params": ref["params"], "opt": ref["opt_state"]}))
    assert meta["step"] == 9 and int(restored["opt"]["count"]) == 9


def test_manager_saves_every_n_and_resumes(tmp_path):
    mgr = CheckpointManager(tmp_path, save_every=2, keep=2)
    tree = _tree()
    assert mgr.resume(tree) == (None, 0, {})
    for step in range(1, 6):
        mgr.maybe_save(step, tree, {"step": step})
    assert latest_steps(tmp_path) == [2, 4]
    restored, step, meta = mgr.resume(tree)
    assert step == 4 and meta == {"step": 4} and torch.equal(restored["nested"]["b"], tree["nested"]["b"])
