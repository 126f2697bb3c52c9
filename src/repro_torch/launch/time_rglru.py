"""Time the RG-LRU scan (kernel 4) of a checkout on the card.

    python src/repro_torch/launch/time_rglru.py [--src DIR] [--iters N] [--by-chunk]

Imports ``repro_torch`` from ``--src`` (default: the ``src`` directory of
the checkout this file sits in), so the same command times an older
checkout's kernel, such as a parent commit unpacked beside this one. Run
two checkouts in turns (parent, this, this, parent) on one card to
compare them.

At RecurrentGemma-9B's shapes, float32, decays in the model's range (a =
base^r, base uniform in [0.9, 0.999] a channel, r = sigmoid(N(0, 1))):
its training forward (1, 4096, 4096), the wave prefill (8, 128, 4096) and
a decode step (8, 1, 4096), it times ``rglru_scan``: the median device time
of ``--iters`` calls, each after a write that evicts the L2 and behind a
device-side sleep, between CUDA events (``rglru_scan_ms``, as
``chip_smoke.py`` times every kernel); and the same after a read that
evicts it (``rglru_scan_ms_clean_l2``): the write leaves up to the L2's 50
MB of dirty lines, whose write-back shares HBM with the timed call, the
read leaves clean ones. ``--by-chunk`` also times forced
plans (``scan_plan(..., chunk=)``: chunks of 32, 64, 96 and 128 steps, and one
chunk) at the first two shapes, where the checkout has them. It prints one
JSON object with the checkout, the card (``nvidia-smi`` name and power
limit) and the milliseconds by shape. Needs a CUDA device and the CUDA
toolkit (the checkout builds its own kernels).
"""
from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

#: name: (B, S, R)
SHAPES = {"train": (1, 4096, 4096), "prefill": (8, 128, 4096), "decode": (8, 1, 4096)}
FORCED_CHUNKS = (32, 64, 96, 128)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--by-chunk", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("time_rglru: CUDA is not available (it times the kernel on the card)")
    from repro_torch.kernels import rglru

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    flush = torch.zeros(128 * 2**20, dtype=torch.uint8, device="cuda")

    def timed(call, clean=False):
        for _ in range(3):
            call()
        times = []
        for _ in range(args.iters):
            if clean:
                flush.max()
            else:
                flush.zero_()
            torch.cuda._sleep(2_000_000)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    forced = args.by_chunk and "chunk" in inspect.signature(getattr(rglru, "scan_plan", lambda: 0)).parameters
    ms, clean, by_chunk = {}, {}, {}
    for name, (b, s, r) in SHAPES.items():
        g = torch.Generator(device="cuda").manual_seed(7)
        base = torch.rand((1, 1, r), device="cuda", generator=g) * 0.099 + 0.9
        a = base ** torch.sigmoid(torch.randn((b, s, r), device="cuda", generator=g))
        x = torch.randn((b, s, r), device="cuda", generator=g)
        h0 = torch.randn((b, r), device="cuda", generator=g)
        ms[name] = timed(lambda: rglru.rglru_scan(a, x, h0))
        clean[name] = timed(lambda: rglru.rglru_scan(a, x, h0), clean=True)
        if forced and s > 1:
            by_chunk[name] = {str(c): timed(lambda: rglru._launch(a, x, h0, rglru.scan_plan(b, s, r, chunk=c)))
                              for c in (*FORCED_CHUNKS, s)}
        del a, x, h0
        torch.cuda.empty_cache()
    print(json.dumps({"src": str(Path(rglru.__file__).resolve().parents[2]), "card": card,
                      "rglru_scan_ms": ms, "rglru_scan_ms_clean_l2": clean,
                      **({"rglru_scan_ms_by_chunk": by_chunk} if forced else {})}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
