"""Time a few train steps of a checkout's models on the card.

    python src/repro_torch/launch/time_train_steps.py [--src DIR] [--arch A ...] [--steps N]

Imports ``repro_torch`` from ``--src`` (default: the ``src`` directory of
the checkout this file sits in), so the same command times an older
checkout, such as a parent commit unpacked beside this one; run two
checkouts in turns (parent, this, this, parent) on one card to compare
them. Each arch trains at ``chip_smoke.py``'s phase-train shape (random
bf16 weights from seed 0, remat, AdamW): Whisper-small 8 x 256 and
xLSTM-350M 4 x 128 (both host-paced: the host's launch rate sets their
step), Qwen3-8B at 12 of 36 layers 2 x 2048 in two microbatches,
RecurrentGemma-9B at 8 of 38 layers 1 x 4096. It prints one JSON object
with the checkout, the card (``nvidia-smi`` name and power limit) and each
arch's step ms (every step, the first one warming the allocator and
cuBLAS) and peak GiB (``max_memory_allocated`` over its steps). Needs a
CUDA device and the CUDA toolkit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

#: arch: (layers kept or None for all, batch, seq, microbatches)
SHAPES = {"whisper_small": (None, 8, 256, 1), "xlstm_350m": (None, 4, 128, 1),
          "qwen3_8b": (12, 2, 2048, 2), "recurrentgemma_9b": (8, 1, 4096, 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--arch", nargs="+", default=list(SHAPES), choices=list(SHAPES))
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("time_train_steps: CUDA is not available (it times the card)")
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.train.train_loop import TrainConfig, synthetic_batches
    from repro_torch.models.registry import get_model
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_step import make_train_step

    build.build_all()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    out, peak = {}, {}
    for arch in args.arch:
        layers, batch, seq, mb = SHAPES[arch]
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        model = get_model(cfg, device="cuda")
        params = model.init_params(seed=0)
        opt = adamw_init(params)
        step = make_train_step(model, AdamWConfig(lr=1e-4, warmup_steps=2), microbatches=mb, remat=True)
        data = synthetic_batches(cfg, TrainConfig(steps=args.steps, batch=batch, seq=seq), "cuda")
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(args.steps):
            b = next(data)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, b)
            float(metrics["loss"])
            times.append(1e3 * (time.perf_counter() - t0))
        out[arch] = [round(t, 1) for t in times]
        peak[arch] = round(torch.cuda.max_memory_allocated() / 2**30, 3)
        del model, params, opt, step
        torch.cuda.empty_cache()
    print(json.dumps({"src": str(Path(args.src).resolve()), "card": card, "step_ms": out,
                      "peak_gib": peak}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
