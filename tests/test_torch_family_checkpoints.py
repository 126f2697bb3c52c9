"""Checkpoints of the families trained without the Engine (RecurrentGemma,
xLSTM, Whisper), in the reference's on-disk format: a checkpoint the
reference writes of the bf16 smoke tree (parameters and an AdamW state after
one update) restores in the port bit for bit, and the reverse; and a
launcher run stopped at its checkpoint and rerun with ``--checkpoint-dir``
resumes there and ends with the losses and parameters of an uninterrupted
run (bit for bit on the CPU)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as ref_restore
from repro.checkpoint import save_checkpoint as ref_save
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models.layers import init_params as ref_init_params
from repro.models.registry import get_model as ref_get_model
from repro.train import optimizer as ref_opt
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import train as train_launcher
from repro_torch.models.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.models.layers import _leaves
from repro_torch.train import train_loop

ARCHS = ("recurrentgemma_9b", "xlstm_350m", "whisper_small")


@functools.lru_cache(maxsize=None)
def _reference_state(arch):
    ref_cfg = ref_smoke_config(arch)
    model = ref_get_model(ref_cfg)
    params = ref_init_params(jax.random.key(0), model.param_defs())
    grads = jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    update = jax.jit(ref_opt.adamw_update, static_argnums=3)
    params, state, _ = update(grads, ref_opt.adamw_init(params), params,
                              ref_opt.AdamWConfig(warmup_steps=1))
    return ArchConfig(**dataclasses.asdict(ref_cfg)), {"params": params, "opt": state}


def _bits(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _port_tree(cfg, np_tree):
    return {"params": params_from_numpy(np_tree["params"], cfg, "cpu"),
            "opt": opt_state_from_numpy(np_tree["opt"], cfg, "cpu")}


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_checkpoint_restores_in_the_port_bit_for_bit(tmp_path, arch):
    cfg, ref_tree = _reference_state(arch)
    ref_save(tmp_path, 3, ref_tree, metadata={"step": 3})
    np_tree = jax.tree_util.tree_map(np.asarray, ref_tree)
    target = jax.tree_util.tree_map(torch.zeros_like, _port_tree(cfg, np_tree))
    restored, meta = restore_checkpoint(tmp_path, target=target)
    assert meta == {"step": 3}
    want = dict(_leaves(np_tree))
    got = dict(_leaves(restored))
    assert set(got) == set(want)
    for path, x in got.items():
        assert str(x.dtype).split(".")[1] == want[path].dtype.name, path
        np.testing.assert_array_equal(_bits(x), _bits(want[path]), err_msg=str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_in_the_reference_bit_for_bit(tmp_path, arch):
    cfg, ref_tree = _reference_state(arch)
    port_tree = _port_tree(cfg, jax.tree_util.tree_map(np.asarray, ref_tree))
    save_checkpoint(tmp_path, 4, port_tree, metadata={"step": 4})
    restored, meta = ref_restore(tmp_path, target=jax.tree_util.tree_map(jnp.zeros_like, ref_tree))
    assert meta == {"step": 4}
    want = dict(_leaves(port_tree))
    for path, x in _leaves(jax.tree_util.tree_map(np.asarray, restored)):
        assert x.dtype.name == str(want[path].dtype).split(".")[1], path
        np.testing.assert_array_equal(_bits(x), _bits(want[path]), err_msg=str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_run_stopped_and_rerun_resumes(tmp_path, monkeypatch, arch):
    """A launcher run of 2 steps that checkpoints every 2 (the launcher's
    interval of 20, shortened here), then a rerun to 3 with the same
    ``--checkpoint-dir``, resumes at 2 and gives the losses and the
    parameters of one 3-step run."""
    monkeypatch.setattr(train_launcher, "TrainConfig",
                        functools.partial(train_loop.TrainConfig, save_every=2))
    args = ["--arch", arch, "--smoke", "--batch", "2", "--seq", "8", "--device", "cpu",
            "--checkpoint-dir", str(tmp_path)]
    first = train_launcher.main(args + ["--steps", "2"])
    rest = train_launcher.main(args + ["--steps", "3"])
    assert (first["steps_run"], rest["start_step"], rest["steps_run"]) == (2, 2, 1)
    whole = train_loop.train(get_smoke_config(arch),
                             train_loop.TrainConfig(steps=3, batch=2, seq=8, log_every=0),
                             train_launcher.AdamWConfig(lr=3e-3, warmup_steps=10), device="cpu")
    assert first["losses"] + rest["losses"] == whole["losses"]
    for (_, a), (_, b) in zip(_leaves(whole["params"]), _leaves(rest["params"])):
        assert torch.equal(a, b)
    assert int(rest["opt_state"]["count"]) == 3
