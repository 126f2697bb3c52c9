"""Offline scheduling for an RLHF-style batch job (the paper's §IV-B use
case): all prompts known upfront, decode lengths well-estimated → the
Minimizing-Makespan Bin Packing assignment + the exact-MILP cross-check at
small scale, and the train-loop integration (sampled completions feeding a
training step with checkpointing), on the PyTorch port.

    PYTHONPATH=src python examples/torch_offline_rlhf.py               # trains on the GPU
    PYTHONPATH=src python examples/torch_offline_rlhf.py --device cpu  # plain PyTorch path

The planning and the simulated serve need no device; the training step runs
on ``--device`` (default ``cuda``, which raises where there is no CUDA
device).
"""
import argparse
import tempfile

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.core import (
    PAPER_COST_MODEL,
    milp_assign,
    simulate,
    solve_offline,
    theoretical_lower_bound,
)
from repro_torch.data import gsm8k_like_workload
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import TrainConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # --- 1. plan the sampling batch ------------------------------------ #
    reqs = gsm8k_like_workload(seed=11, known_lengths=True)
    res = solve_offline(reqs, 200, PAPER_COST_MODEL)
    lb = theoretical_lower_bound(reqs, 200, PAPER_COST_MODEL)
    print(
        f"offline assignment: est makespan={res.makespan_est:.2f}s "
        f"(LP bound {res.lp_lower_bound:.2f}s, gap {res.gap * 100:.2f}%, "
        f"{res.solve_seconds * 1e3:.0f} ms with {res.solver})"
    )

    # exact MILP agrees at small scale
    w = np.asarray([r.est_total_tokens for r in reqs[:12]], float)
    exact = milp_assign(w, 3, time_limit_s=20)
    loads = sorted(sum(w[i] for i in c) for c in exact)
    print(f"HiGHS exact check (12×3): balanced loads {loads}")

    # --- 2. simulate the serve under the assignment -------------------- #
    tr = simulate(reqs, 200, PAPER_COST_MODEL, mode="offline", oracle_estimates=True)
    print(
        f"offline-scheduled sampling run: util={tr.utilization * 100:.2f}% "
        f"total={tr.makespan:.2f}s (LB {lb.total:.2f}s)"
    )

    # --- 3. train on the sampled data with checkpoint/restart ---------- #
    cfg = get_smoke_config("qwen3_8b")
    with tempfile.TemporaryDirectory() as d:
        out = train(cfg, TrainConfig(steps=40, batch=4, seq=32,
                                     checkpoint_dir=d, save_every=10, log_every=0),
                    AdamWConfig(lr=5e-3, warmup_steps=5), device=device)
        print(
            f"policy-model training: loss {out['first_loss']:.3f} → "
            f"{out['last_loss']:.3f} over {out['steps_run']} steps "
            f"(checkpointed every 10)"
        )


if __name__ == "__main__":
    main()
