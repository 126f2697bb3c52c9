"""Shared set-up of the PyTorch port's parity tests (``test_torch_*.py``):
the reference model and its parameters, the same parameters carried into the
port, and numpy helpers that feed both sides identical inputs."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import qwen3_8b as ref_qwen3
from repro.models.layers import init_params
from repro.models.transformer import TransformerLM as RefLM
from repro_torch.configs.base import ArchConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import TransformerLM

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


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32) if np.asarray(x).dtype.name == "bfloat16" else np.asarray(x)


def shuffled_tables(rng, n_rows, mb, n_pages, page_size, lengths):
    """Block tables over a shuffled pool: row i owns just enough pages for
    lengths[i] tokens (-1 past that)."""
    perm = rng.permutation(n_pages)
    tables = np.full((n_rows, mb), -1, np.int32)
    used = 0
    for i in range(n_rows):
        need = -(-int(lengths[i]) // page_size)
        assert used + need <= n_pages, "case under-provisions pages"
        tables[i, :need] = perm[used : used + need]
        used += need
    return tables


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
