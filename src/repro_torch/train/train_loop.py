"""Training loop with checkpoint/restart and synthetic data (counterpart of
``repro.train.train_loop``).

``train(cfg, tc, opt_cfg, device)`` builds the model of ``cfg`` on
``device`` (the CUDA device by default; raises without one unless
``device="cpu"``), draws its parameters from ``tc.seed`` (a seeded
``torch.Generator``: not the reference's ``jax.random`` draws), and trains
with AdamW and gradient accumulation, checkpointing every ``save_every``
steps in the reference's format and resuming from the latest complete
checkpoint (its own, or one the reference wrote) on restart. The batches are
the reference's exactly: the same numpy stream, skipped past the consumed
ones on resume.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from .. import resolve_device
from ..checkpoint import CheckpointManager
from ..configs.base import ArchConfig
from ..models.registry import get_model
from .optimizer import AdamWConfig, adamw_init
from .train_step import make_train_step


@dataclass
class TrainConfig:
    steps: int = 50
    batch: int = 8
    seq: int = 64
    microbatches: int = 1
    remat: bool = False
    seed: int = 0
    checkpoint_dir: Optional[str] = None
    save_every: int = 20
    log_every: int = 10


def synthetic_batches(
    cfg: ArchConfig, tc: TrainConfig, device="cpu"
) -> Iterator[Dict[str, torch.Tensor]]:
    """Deterministic synthetic LM data: modular successor sequences
    (tokens[t+1] = tokens[t] + stride mod V) from numpy's generator seeded
    with ``tc.seed``, as the reference draws them; a VLM config's
    ``patch_embeds`` come from the same stream, rounded to bf16 through
    float32 as the reference's ``jnp.asarray`` rounds them."""
    rng = np.random.default_rng(tc.seed)
    v = max(cfg.vocab_size - 1, 2)
    t = np.arange(tc.seq + 1)[None, :]
    while True:
        start = rng.integers(0, v, size=(tc.batch, 1))
        stride = rng.integers(1, 4, size=(tc.batch, 1))
        seqs = (start + stride * t) % v + 1
        batch = {
            "tokens": torch.from_numpy(seqs[:, :-1].astype(np.int32)).to(device),
            "labels": torch.from_numpy(seqs[:, 1:].astype(np.int32)).to(device),
        }
        if cfg.family == "vlm":
            pe = rng.normal(size=(tc.batch, cfg.num_patch_tokens, cfg.d_model))
            batch["patch_embeds"] = torch.from_numpy(pe.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        yield batch


def train(
    cfg: ArchConfig,
    tc: TrainConfig,
    opt_cfg: Optional[AdamWConfig] = None,
    device="cuda",
) -> Dict[str, Any]:
    """Run the loop; returns summary metrics (resumes if checkpoints exist):
    the reference's keys, plus each step's loss, gradient norm and wall
    seconds (``losses``, ``grad_norms``, ``step_s``)."""
    dev = resolve_device(device)
    opt_cfg = opt_cfg or AdamWConfig(warmup_steps=10)
    model = get_model(cfg, device=dev)
    if not hasattr(model, "loss"):
        raise NotImplementedError(
            f"{cfg.name}: the port has no loss for the {cfg.family!r} family yet (ROADMAP.md)")
    params = model.init_params(tc.seed)
    opt_state = adamw_init(params)
    start_step = 0
    mgr = None
    if tc.checkpoint_dir:
        mgr = CheckpointManager(tc.checkpoint_dir, save_every=tc.save_every)
        restored, start_step, _ = mgr.resume({"params": params, "opt": opt_state})
        if restored is not None:
            params, opt_state = restored["params"], restored["opt"]

    step_fn = make_train_step(model, opt_cfg, microbatches=tc.microbatches, remat=tc.remat)
    data = synthetic_batches(cfg, tc, dev)
    # skip already-consumed batches on resume (deterministic pipeline cursor)
    for _ in range(start_step):
        next(data)

    losses, grad_norms, step_s = [], [], []
    t0 = time.perf_counter()
    for step in range(start_step, tc.steps):
        t_step = time.perf_counter()
        batch = next(data)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        grad_norms.append(float(metrics["grad_norm"]))
        step_s.append(time.perf_counter() - t_step)
        losses.append(loss)
        if mgr is not None:
            mgr.maybe_save(
                step + 1,
                {"params": params, "opt": opt_state},
                metadata={"loss": loss, "step": step + 1},
            )
        if tc.log_every and (step + 1) % tc.log_every == 0:
            print(f"step {step + 1}: loss={loss:.4f}", flush=True)
    wall = time.perf_counter() - t0
    return {
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "steps_run": len(losses),
        "start_step": start_step,
        "wall_s": wall,
        "params": params,
        "opt_state": opt_state,
        "losses": losses,
        "grad_norms": grad_norms,
        "step_s": step_s,
    }
