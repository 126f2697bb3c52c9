"""Where a serving step's time goes on the card.

    python -m repro_torch.launch.profile_step --layers 36 --slots 8 \\
        --context 320 --horizon 8

Builds the Qwen3-8B configuration (depth cut by ``--layers``) with random
bf16 weights, fills ``--slots`` slots of a paged pool with ``--context``
tokens each, then measures on the CUDA device:

* a fused decode stage (``decode_steps`` with K = ``--horizon``) and a mixed
  round (``mixed_step``: every slot decoding plus ``--chunk-rows`` prefill
  chunks of 32 tokens): host wall time per call, each ending in a device
  synchronise;
* one ``torch.profiler`` trace of each: device time summed over kernels, the
  device's busy share of the wall time, kernels launched per call, and the
  kernels that take the most device time.

Prints one JSON object per measured call. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..configs import get_config
from ..models.transformer import TransformerLM
from ..serving.sampler import greedy


def _fill_pool(model, params, n_slots, context, page_size, max_len, device):
    mb = -(-max_len // page_size)
    cache = model.paged_cache_init(n_slots * mb, page_size, n_slots, mb)
    rng = np.random.default_rng(0)
    tables = rng.permutation(n_slots * mb).astype(np.int32).reshape(n_slots, mb)
    cache["block_tables"].copy_(torch.from_numpy(tables))
    t = lambda x: torch.from_numpy(np.asarray(x, np.int32)).to(device)
    for start in range(0, context, 32):
        n = min(32, context - start)
        toks = rng.integers(1, model.cfg.vocab_size, size=(n_slots, 32))
        model.prefill_chunk(params, t(toks), cache, t(np.arange(n_slots)),
                            t(np.full(n_slots, start)), t(np.full(n_slots, n)))
    torch.cuda.synchronize()
    return cache


def _measure(name, fn, iters):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    # device-side events are the kernels (and copies) themselves
    kernels = [e for e in prof.events() if getattr(e.device_type, "name", "") == "CUDA"]
    by_name: dict = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    device_us = sum(t for _, t in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "call": name,
        "wall_ms_median": float(np.median(walls)) * 1e3,
        "traced_wall_ms": traced_wall * 1e3,
        "device_ms": device_us / 1e3,
        "device_busy_share": device_us / 1e3 / (traced_wall * 1e3),
        "kernels_launched": len(kernels),
        "top_kernels": [(k[:70], n, t / 1e3) for k, (n, t) in top],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--layers", type=int, default=36)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--context", type=int, default=320)
    ap.add_argument("--horizon", type=int, default=8)
    ap.add_argument("--chunk-rows", type=int, default=4)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step measures the CUDA device; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False

    import dataclasses

    cfg = dataclasses.replace(get_config("qwen3_8b"), n_layers=args.layers)
    model = TransformerLM(cfg, device="cuda")
    params = model.init_params(seed=0)
    j, dev = args.slots, "cuda"
    cache = _fill_pool(model, params, j, args.context, 16, 640, dev)
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device=dev)

    # each call grows the live slots (decode) or rewrites the first chunk of
    # the chunk rows' slots; the measured calls stay inside the 640-token pool
    def decode():
        model.decode_steps(
            params, z(j), cache, num_steps=args.horizon, sampler=greedy,
            active=torch.ones(j, dtype=torch.bool, device=dev),
            budgets=torch.full((j,), 10**6, dtype=torch.int32, device=dev),
            rids=z(j), token_idx0=z(j),
        )

    r = args.chunk_rows

    def mixed():
        model.mixed_step(
            params, z(j), cache, z(r, 32), torch.arange(r, dtype=torch.int32, device=dev),
            z(r), torch.full((r,), 32, dtype=torch.int32, device=dev), sampler=greedy,
            dec_active=torch.arange(j, device=dev) >= r, rids=z(j + r),
            token_idx=z(j + r), sample_rows=torch.ones(j + r, dtype=torch.bool, device=dev),
        )

    head = {
        "device": torch.cuda.get_device_name(0), "layers": args.layers,
        "slots": j, "context": args.context, "horizon": args.horizon,
        "chunk_rows": r,
    }
    for name, fn in (("decode_steps", decode), ("mixed_step", mixed)):
        print(json.dumps({**head, **_measure(name, fn, args.iters)}), flush=True)


if __name__ == "__main__":
    main()
