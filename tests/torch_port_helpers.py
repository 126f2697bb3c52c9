"""Shared set-up of the PyTorch port's parity tests (``test_torch_*.py``):
the reference model and its parameters and the same parameters carried into
the port (``family_models``: any smoke decoder, every parameter perturbed
off its init). The numpy helpers that feed both sides identical inputs, which need
no JAX, live in ``torch_port_arrays``. ``scripted_clock`` stands in for both
engines' clocks, so the fleet tests' schedules read no wall clock."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.configs import qwen3_8b as ref_qwen3
from repro.models.layers import init_params
from repro.models.transformer import TransformerLM as RefLM
from repro_torch.configs.base import ArchConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import TransformerLM
from torch_port_arrays import ScriptedClock

# The float32 smoke configuration of Qwen3-8B: 2 layers, d_model 64, 4 query
# and 2 KV heads (head_dim 16), qk-norm, vocab 256. Token parity across the
# frameworks is checked in float32; bf16 rounds at other places in each.
REF_CFG = dataclasses.replace(ref_qwen3.SMOKE_CONFIG, dtype="float32")
CFG = ArchConfig(**dataclasses.asdict(REF_CFG))

# TF32 would change float32 matmuls on a GPU; the parity tests state it off
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# one intra-op thread per test worker: the suite runs several workers at
# once, and the reference's fault-detection tests time their faults on the
# wall clock
torch.set_num_threads(1)


def ref_model_and_params(cfg=REF_CFG):
    model = RefLM(cfg)
    return model, init_params(jax.random.key(0), model.param_defs())


def port_model_and_params(ref_params, cfg=CFG, device="cpu"):
    tree = jax.tree_util.tree_map(np.asarray, ref_params)
    return TransformerLM(cfg, device=device), params_from_numpy(tree, cfg, device)


@contextlib.contextmanager
def scripted_clock():
    """Both engines (the reference's and the port's) read a ScriptedClock
    while the context is open."""
    import repro.serving.engine as ref_engine
    import repro_torch.serving.engine as port_engine

    saved = ref_engine.time, port_engine.time
    ref_engine.time, port_engine.time = ScriptedClock(), ScriptedClock()
    try:
        yield
    finally:
        ref_engine.time, port_engine.time = saved


# The decoders the reference's TransformerLM serves beside Qwen3, by smoke
# config, and those of them the paged layout takes (not Mixtral's sliding
# window, which the reference refuses there).
FAMILY_ARCHS = ("granite_3_8b", "llama_65b", "starcoder2_7b", "nemotron_4_15b",
                "olmoe_1b_7b", "mixtral_8x22b", "qwen2_vl_7b")
PAGED_FAMILY_ARCHS = tuple(a for a in FAMILY_ARCHS if a != "mixtral_8x22b")


def perturbed(tree, seed=0):
    """Every leaf of a numpy parameter tree plus seeded noise: 0.1 x its
    spread (0.1 for a constant leaf), so zero biases, zero layernorm biases
    and unit scales leave their init and a misplaced one shows."""
    rng = np.random.default_rng(seed)

    def bump(a):
        spread = float(a.astype(np.float32).std()) or 1.0
        return (a + 0.1 * spread * rng.standard_normal(a.shape)).astype(a.dtype)

    return jax.tree_util.tree_map(bump, tree)


def family_models(arch, seed=0):
    """The float32 smoke config of ``arch`` in both packages on the same
    perturbed parameters: (reference model, its params, port model, its
    params)."""
    ref_cfg = dataclasses.replace(ref_smoke_config(arch), dtype="float32")
    cfg = ArchConfig(**dataclasses.asdict(ref_cfg))
    ref_model = RefLM(ref_cfg)
    tree = jax.tree_util.tree_map(
        np.asarray, init_params(jax.random.key(0), ref_model.param_defs()))
    tree = perturbed(tree, seed)
    return (ref_model, jax.tree_util.tree_map(jnp.asarray, tree),
            TransformerLM(cfg, device="cpu"), params_from_numpy(tree, cfg, "cpu"))
