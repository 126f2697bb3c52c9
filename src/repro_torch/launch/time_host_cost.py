"""Time what each kernel wrapper of a checkout costs the host a call, on the
card.

    python src/repro_torch/launch/time_host_cost.py [--src DIR] [--iters N]

Imports ``repro_torch`` from ``--src`` (default: the ``src`` directory of
the checkout this file sits in), so the same command times an older
checkout's wrappers, such as a parent commit unpacked beside this one; run
two checkouts in turns (parent, this, this, parent) on one card to compare
them. At tiny shapes, where the device runs a call in a few microseconds,
it times each wrapper host-paced: CUDA events around each of ``--iters``
calls issued back to back with nothing queued ahead, so each reading is the
time the host takes to issue a call (the median is printed, in
microseconds), beside a one-element ``add_``. The wrappers: kernel 1
(paged decode), kernel 2's dense and paged-chunk entries, kernel 3 (dense
decode), kernel 4 (the RG-LRU scan), the flash backward and the RG-LRU
backward. It prints one JSON object with the checkout, the card
(``nvidia-smi`` name and power limit) and the microseconds by wrapper.
Needs a CUDA device and the CUDA toolkit (the checkout builds its own
kernels).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def host_paced_us(torch, fn, iters: int) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return 1e3 * statistics.median(a.elapsed_time(b) for a, b in pairs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("time_host_cost: CUDA is not available (it times the wrappers on the card)")
    from repro_torch.kernels import (
        build,
        decode_attention,
        flash_attention,
        flash_attention_bwd,
        paged_decode_attention,
        rglru,
        rglru_bwd,
    )

    build.build_all()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)
    f32 = lambda *s: torch.rand(*s, generator=gen, device="cuda")
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device="cuda")
    h, d = 4, 128
    q, k, v = bf(1, h, 64, d), bf(1, 1, 64, d), bf(1, 1, 64, d)
    out, lse = flash_attention.flash_attention(q, k, v, return_lse=True)
    pages = bf(1, 4, 16, d)
    tables = i32(0, 1, 2, 3).view(1, 4)
    a, x, h0 = f32(1, 1, 64), f32(1, 1, 64), f32(1, 64)
    hs, _ = rglru.rglru_scan(a, x, h0)
    one = torch.zeros(1, device="cuda")
    q1 = bf(1, 1, h, d)                                    # one token, bshk
    qc = bf(1, 16, h, d)                                   # a chunk of 16, bshk
    qd = bf(1, h, d)
    n64, zero, n16 = i32(64), i32(0), i32(16)
    calls = {
        "add_ (one element)": lambda: one.add_(1),
        "paged_decode_attention": lambda: paged_decode_attention.paged_decode_attention(
            q1, pages, pages, tables, n64),
        "flash_attention (dense)": lambda: flash_attention.flash_attention(q, k, v),
        "paged_chunk_attention": lambda: flash_attention.paged_chunk_attention(
            qc, pages, pages, tables, zero, n16),
        "decode_attention": lambda: decode_attention.decode_attention(qd, k, v, n64),
        "rglru_scan": lambda: rglru.rglru_scan(a, x, h0),
        "flash_attention_backward": lambda: flash_attention_bwd.flash_attention_backward(
            q, k, v, out, lse, out),
        "rglru_scan_backward": lambda: rglru_bwd.rglru_scan_backward(a, hs, h0, a, h0),
    }
    us = {name: host_paced_us(torch, fn, args.iters) for name, fn in calls.items()}
    print(json.dumps({"src": str(Path(args.src).resolve()), "card": card, "host_us": us}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
