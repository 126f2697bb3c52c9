"""Serve full-size Qwen3-8B with a checkout's engine on the card.

    python src/repro_torch/launch/time_serves.py [--root DIR] [--label NAME]

Imports ``chip_smoke`` and ``repro_torch`` from the checkout at ``--root``
(default: the checkout this file sits in), so the same command serves an
older checkout, such as a parent commit unpacked beside this one. Run two
checkouts in turns (parent, this, this, parent) on one card to compare them.

It builds that checkout's kernels, then serves the 16 GSM8K-shaped requests
of ``chip_smoke.py``'s phase serve with random bf16 weights from seed 0,
greedy, on the paged layout and then the dense one, each through the
checkout's own ``chip_smoke.run_serve`` (its gates included), and prints
one JSON object a layout: the label, the card (``nvidia-smi`` name and
power limit), tok/s, wall, utilization, makespan, decode and mixed rounds,
prefill stages and stall, and the wall ms a decode round. Needs a CUDA
device and the CUDA toolkit.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[3]))
    ap.add_argument("--label", default="this")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("time_serves: CUDA is not available (it serves on the card)")
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.transformer import TransformerLM

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    build.build_all()
    model = TransformerLM(get_config("qwen3_8b"), device="cuda")
    params = model.init_params(seed=0)
    for layout in ("paged", "dense"):
        eng, _, _, stats = chip_smoke.run_serve(torch, model, params, layout)
        stats.pop("graphs", None)
        print(json.dumps({"label": args.label, "root": str(root), "layout": layout, "card": card,
                          **stats}), flush=True)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
