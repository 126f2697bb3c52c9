"""Time the flash-attention backward kernel of a checkout on the card.

    python src/repro_torch/launch/time_flash_backward.py [--src DIR] [--iters N]

Imports ``repro_torch`` from ``--src`` (default: the ``src`` directory of
the checkout this file sits in), so the same command times an older
checkout's kernel, such as a parent commit unpacked beside this one. Run
two checkouts in turns (parent, this, this, parent) on one card to
compare them.

At Qwen3-8B's attention with a causal mask (32/8 heads, head_dim 128, bf16,
strided bshk views; B 2 and B 1 x 2048, the shapes of ``chip_smoke.py``'s
training kernel checks), it runs the dense forward with its log-sum-exp
once, then times ``flash_attention_backward`` on the same inputs: the median
device time of ``--iters`` calls, each after a write that evicts the L2 and
behind a device-side sleep, between CUDA events. It prints one JSON object
with the checkout, the card (``nvidia-smi`` name and power limit) and the
milliseconds by shape. Needs a CUDA device and the CUDA toolkit (the
checkout builds its own kernels).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

SHAPES = {"b2": (2, 32, 8, 2048, 128), "b1": (1, 32, 8, 2048, 128)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("time_flash_backward: CUDA is not available (it times the kernel on the card)")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    ms = {}
    for name, (b, h, kv, s, d) in SHAPES.items():
        g = torch.Generator(device="cuda").manual_seed(7)
        mk = lambda n: torch.randn(b, s, n, d, device="cuda", generator=g).bfloat16().transpose(1, 2)
        q, k, v, do = mk(h), mk(kv), mk(kv), mk(h)
        out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        call = lambda: fb.flash_attention_backward(q, k, v, out, lse, do, causal=True)
        for _ in range(3):
            call()
        times = []
        for _ in range(args.iters):
            flush.zero_()
            torch.cuda._sleep(5_000_000)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms[name] = statistics.median(times)
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    print(json.dumps({"src": str(Path(fb.__file__).resolve().parents[2]), "card": card,
                      "flash_attention_backward_ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
