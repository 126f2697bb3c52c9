"""Shared set-up of the PyTorch port's parity tests (``test_torch_*.py``):
the reference model and its parameters and the same parameters carried into
the port (``family_models``: any smoke decoder, every parameter perturbed
off its init). The numpy helpers that feed both sides identical inputs, which need
no JAX, live in ``torch_port_arrays``. ``scripted_clock`` stands in for both
engines' clocks, so the fleet tests' schedules read no wall clock.
``run_ranks`` runs a function of ``torch_port_ranks`` in the processes of a
gloo group."""
import contextlib
import dataclasses
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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


def seq_models(arch, seed=0, dtype="float32"):
    """The smoke config of a model family without the Engine (RecurrentGemma,
    xLSTM, Whisper) in both packages, in ``dtype``, on the same perturbed
    parameters: (reference model, its params, port model, its params)."""
    from repro.models.registry import get_model as ref_get_model
    from repro_torch.models.registry import get_model

    ref_cfg = dataclasses.replace(ref_smoke_config(arch), dtype=dtype)
    cfg = ArchConfig(**dataclasses.asdict(ref_cfg))
    ref_model = ref_get_model(ref_cfg)
    tree = jax.tree_util.tree_map(
        np.asarray, init_params(jax.random.key(0), ref_model.param_defs()))
    tree = perturbed(tree, seed)
    return (ref_model, jax.tree_util.tree_map(jnp.asarray, tree),
            get_model(cfg, device="cpu"), params_from_numpy(tree, cfg, "cpu"))


def ref_loss_and_grads(ref_model, ref_params, batch):
    """The reference's loss and gradient leaves (numpy, by path) of a numpy
    batch, without remat."""
    from repro_torch.models.layers import _leaves

    fn = jax.jit(jax.value_and_grad(lambda p, b: ref_model.loss(p, b, remat=False)))
    loss, grads = fn(ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), dict(_leaves(jax.tree_util.tree_map(np.asarray, grads)))


def port_loss_and_grads(model, params, batch, remat):
    """The port's loss and gradient leaves (numpy, by path) of a numpy batch,
    every leaf a fresh tensor that requires grad."""
    from repro_torch.models.layers import _leaves

    leaves = {path: t.detach().clone().requires_grad_(True) for path, t in _leaves(params)}
    tree = {}
    for path, t in leaves.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    loss = model.loss(tree, {k: torch.from_numpy(v) for k, v in batch.items()}, remat=remat)
    loss.backward()
    return float(loss.detach()), {path: t.grad.numpy() for path, t in leaves.items()}


def worst_grad_error(grads, ref_grads):
    """The largest gradient error of any leaf, relative to that leaf's
    largest reference magnitude, and the leaf."""
    assert set(grads) == set(ref_grads)
    return max((float(np.abs(grads[p] - ref_grads[p]).max()
                      / max(np.abs(ref_grads[p]).max(), 1e-30)), p) for p in ref_grads)


def reference_waves(ref_model, ref_params, reqs, n_slots, max_len, width, enc_len=None):
    """The wave loop of ``launch.generate.WaveServer`` driven on the
    reference model: each wave one prefill (ragged with its lengths; for an
    encoder-decoder model unpadded, with each request's ``request_frames``)
    then greedy decode steps until every request has its budget. Returns
    (rid → tokens, decode steps)."""
    from repro_torch.launch.generate import request_frames
    from repro_torch.serving.engine import prompt_tokens

    vocab = ref_model.cfg.vocab_size
    decode = jax.jit(ref_model.decode_step)
    generated, steps = {}, 0
    for w0 in range(0, len(reqs), n_slots):
        wave = reqs[w0: w0 + n_slots]
        tok = np.zeros((len(wave), width), np.int32)
        for i, r in enumerate(wave):
            tok[i, : r.n_prefill] = prompt_tokens(r, vocab)
        lens = np.array([r.n_prefill for r in wave], np.int32)
        if enc_len is None:
            cache = ref_model.cache_init(len(wave), max_len)
            logits, cache = ref_model.prefill(ref_params, jnp.asarray(tok), cache,
                                              lengths=jnp.asarray(lens))
        else:
            frames = np.stack([request_frames(r.rid, enc_len, ref_model.cfg.d_model) for r in wave])
            cache = ref_model.cache_init(len(wave), max_len, enc_len=enc_len)
            logits, cache = ref_model.prefill(ref_params, jnp.asarray(tok[:, : lens[0]]), cache,
                                              patch_embeds=jnp.asarray(frames))
        cur = jnp.argmax(logits, -1).astype(jnp.int32)
        out = [np.asarray(cur)]
        for _ in range(max(r.n_decode for r in wave) - 1):
            logits, cache = decode(ref_params, cur, cache)
            cur = jnp.argmax(logits, -1).astype(jnp.int32)
            out.append(np.asarray(cur))
        steps += len(out) - 1
        for i, r in enumerate(wave):
            generated[r.rid] = [int(t[i]) for t in out[: r.n_decode]]
    return generated, steps


#: the longest a group of ranks may run before ``run_ranks`` kills it
RANKS_TIMEOUT_S = 120


def run_ranks(fn, world, workdir, *args, timeout=RANKS_TIMEOUT_S):
    """Run ``fn(rank, world, *args)`` (a function of ``torch_port_ranks``) in
    ``world`` spawned processes of a gloo group that meets through a
    FileStore under ``workdir`` (no TCP port, so parallel test workers never
    collide). A rank that raises fails the test with its traceback; a group
    still running after ``timeout`` seconds is killed and fails it."""
    import torch.multiprocessing as mp
    from torch_port_ranks import rank_main

    store = Path(workdir) / f"filestore_{fn.__name__}"
    ctx = mp.start_processes(rank_main, args=(fn, world, str(store), args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                pytest.fail(f"{fn.__name__} on {world} ranks ran past {timeout} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()
