#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, each printing its seconds on a line of its own:

1. device  — find the CUDA device (exit non-zero without one) and print its
             name and power limit as nvidia-smi reports them;
2. build   — compile the hand-written kernels from src/repro_torch/kernels/csrc
             with nvcc for sm_90a (one nvcc per source, all at once);
3. kernels — hold each kernel against its plain PyTorch version on the card in
             bf16, at the serving shapes of Qwen3-8B (8 slots, 32 query and 8 KV
             heads, head_dim 128, pages of 16, up to 640 tokens a slot,
             shuffled pages and -1 table entries) and at the smoke shapes
             (head_dim 16); time the kernel, the plain version and one
             PyTorch library call (scaled_dot_product_attention on the
             gathered K/V, timed here only) and compute the kernel's bound;
4. parity  — the smoke model in float32 on the card (kernels) against the
             same model on the CPU (plain versions): prefill and decode logits;
5. serve   — full-size Qwen3-8B (36 layers, bf16, random weights from a seed)
             behind the port's Engine: paged KV, mixed steps, hybrid
             scheduling, 16 GSM8K-shaped requests (outputs capped at 128);
             checks the trace, the budgets, the token ids and that both
             kernels ran exactly as often as the schedule implies.

Then one JSON line naming every ported kernel with its launches in the serve
and its times, and, last, {"ok": true, "device": {...}}. Any failed check
raises, so the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak
TOL = {"bfloat16": 2e-2, "float32": 1e-4}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def phase(name, t0):
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)


# --------------------------------------------------------------------------- #
# Timing                                                                      #
# --------------------------------------------------------------------------- #
def time_ms(torch, fn, flush, iters=30, warmup=5):
    """Median device time of ``fn`` in ms over ``iters`` calls, each after an
    L2-evicting write (the serving path finds a layer's pages cold: the
    other layers' weights pass through the cache in between). A device-side
    sleep ahead of the start event lets the host queue the whole call, so
    the events bracket device work only, not the host's launch latency."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(5_000_000)          # a few ms of device-side spin
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(torch, out, ref, tol):
    out, ref = out.float(), ref.float()
    live = torch.isfinite(ref)
    err = (out - ref).abs()[live]
    bad = err > tol + tol * ref.abs()[live]
    check(bool(torch.isfinite(out).all()), "kernel output is not finite")
    check(not bool(bad.any()), f"kernel disagrees with its plain version (max err {float(err.max()):.3g})")
    return float(err.max())


# --------------------------------------------------------------------------- #
# Kernel cases                                                                #
# --------------------------------------------------------------------------- #
def decode_case(torch, np, h, kv, d, b=8, bs=16, mb=40, seed=0):
    rng = np.random.default_rng(seed)
    p = b * mb
    lengths = rng.integers(1, mb * bs + 1, size=b).astype(np.int32)
    perm = rng.permutation(p)
    tables = np.full((b, mb), -1, np.int32)        # -1 past each slot's pages
    used = 0
    for i in range(b):
        need = -(-int(lengths[i]) // bs)
        tables[i, :need] = perm[used : used + need]
        used += need
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = torch.bfloat16
    q = torch.randn(b, 1, h, d, device="cuda", generator=g).to(dt)
    k = torch.randn(kv, p, bs, d, device="cuda", generator=g).to(dt)
    v = torch.randn(kv, p, bs, d, device="cuda", generator=g).to(dt)
    return q, k, v, torch.from_numpy(tables).cuda(), torch.from_numpy(lengths).cuda()


def chunk_case(torch, np, h, kv, d, r=8, c=32, bs=16, mb=40, seed=1):
    rng = np.random.default_rng(seed)
    p = r * mb
    chunk_lens = rng.integers(1, c + 1, size=r).astype(np.int32)
    starts = (rng.integers(0, (mb * bs - c) // c + 1, size=r) * c).astype(np.int32)
    chunk_lens[-1], starts[-1] = 0, 0              # a pad row, as the engine pads
    valid = starts + chunk_lens
    perm = rng.permutation(p)
    tables = np.full((r, mb), -1, np.int32)
    used = 0
    for i in range(r - 1):
        need = -(-int(valid[i]) // bs)
        tables[i, :need] = perm[used : used + need]
        used += need
    tables[-1] = tables[-2]                        # pad rows read the last slot's row
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = torch.bfloat16
    q = torch.randn(r, c, h, d, device="cuda", generator=g).to(dt)
    k = torch.randn(kv, p, bs, d, device="cuda", generator=g).to(dt)
    v = torch.randn(kv, p, bs, d, device="cuda", generator=g).to(dt)
    t = lambda x: torch.from_numpy(x).cuda()
    return q, k, v, t(tables), t(starts), t(valid), chunk_lens


def decode_bound(q, k, tables, lengths):
    b, _, h, d = q.shape
    kv = k.shape[0]
    toks = int(lengths.sum())
    nbytes = 2 * q.numel() * q.element_size() + tables.numel() * 4 + lengths.numel() * 4
    nbytes += 2 * toks * kv * d * k.element_size()          # K and V of live tokens
    flops = 4 * d * h * toks
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def chunk_bound(q, k, tables, starts, valid, chunk_lens):
    r, c, h, d = q.shape
    kv = k.shape[0]
    nbytes = 2 * q.numel() * q.element_size() + tables.numel() * 4 + 8 * r
    nbytes += 2 * int(valid.sum()) * kv * d * k.element_size()
    s = starts.cpu().tolist()
    pairs = sum(s[i] + j + 1 for i in range(r) for j in range(int(chunk_lens[i])))
    flops = 4 * d * h * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def sdpa_inputs(q, k_pages, v_pages, tables):
    """The library yardstick's inputs: q as (B, H, S, D) and each row's pages
    gathered into (B, H, T, D) K/V with the KV heads repeated per query head
    (prepared outside the timed call)."""
    from repro_torch.models.cache import paged_gather_kv

    g = q.shape[2] // k_pages.shape[0]
    kc, vc = paged_gather_kv(k_pages, v_pages, tables)
    expand = lambda x: x.transpose(1, 2).repeat_interleave(g, dim=1).contiguous()
    return q.transpose(1, 2), expand(kc), expand(vc)


def run_kernel_checks(torch, np):
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.models.cache import paged_key_positions

    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    results = {}
    for label, (h, kv, d) in (("qwen3-8b", (32, 8, 128)), ("smoke", (4, 2, 16))):
        # kernel 1: paged decode attention
        q, k, v, tables, lengths = decode_case(torch, np, h, kv, d)
        out = pda.paged_decode_attention(q, k, v, tables, lengths)
        torch.cuda.synchronize()
        err = max_err(torch, out, pda.paged_decode_attention_plain(q, k, v, tables, lengths),
                      TOL["bfloat16"])
        mask = (paged_key_positions(tables, lengths, k.shape[2]) >= 0)[:, None, None, :]
        qs, ks, vs = sdpa_inputs(q, k, v, tables)
        ms = time_ms(torch, lambda: pda.paged_decode_attention(q, k, v, tables, lengths), flush)
        plain_ms = time_ms(torch, lambda: pda.paged_decode_attention_plain(q, k, v, tables, lengths), flush)
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask), flush)
        bound_ms, bound_by = decode_bound(q, k, tables, lengths)
        results[("paged_decode_attention", label)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bound_ms, bound_by=bound_by,
        )
        # kernel 2: flash attention, paged chunk entry
        q, k, v, tables, starts, valid, chunk_lens = chunk_case(torch, np, h, kv, d)
        out = fa.paged_chunk_attention(q, k, v, tables, starts, valid)
        torch.cuda.synchronize()
        ref = fa.paged_chunk_attention_plain(q, k, v, tables, starts, valid)
        err = max_err(torch, out, ref, TOL["bfloat16"])
        check(bool((out[-1] == 0).all()), "pad chunk row is not zero")
        kpos = paged_key_positions(tables, valid, k.shape[2])
        qpos = starts.long()[:, None] + torch.arange(q.shape[1], device="cuda")[None, :]
        mask = ((kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qpos[:, :, None]))[:, None]
        qs, ks, vs = sdpa_inputs(q, k, v, tables)
        ms = time_ms(torch, lambda: fa.paged_chunk_attention(q, k, v, tables, starts, valid), flush)
        plain_ms = time_ms(torch, lambda: fa.paged_chunk_attention_plain(
            q, k, v, tables, starts, valid), flush)
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask), flush)
        bound_ms, bound_by = chunk_bound(q, k, tables, starts, valid, chunk_lens)
        results[("flash_attention", label)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bound_ms, bound_by=bound_by,
        )
        # the dense entry of kernel 2, against its plain version
        g = torch.Generator(device="cuda").manual_seed(2)
        dq = torch.randn(2, h, 256, d, device="cuda", generator=g).bfloat16()
        dk = torch.randn(2, kv, 256, d, device="cuda", generator=g).bfloat16()
        dv = torch.randn(2, kv, 256, d, device="cuda", generator=g).bfloat16()
        for causal, window in ((True, 0), (True, 64), (False, 0)):
            out = fa.flash_attention(dq, dk, dv, causal=causal, window=window)
            torch.cuda.synchronize()
            derr = max_err(torch, out, fa.flash_attention_plain(
                dq, dk, dv, causal=causal, window=window), TOL["bfloat16"])
            print(f"  flash_attention dense {label} causal={causal} window={window}: "
                  f"max_abs_err={derr:.3g}")
    for (name, label), r in results.items():
        print(f"  {name} [{label}] bf16: max_abs_err={r['max_abs_err']:.4g} "
              f"kernel={r['ms']:.4f} ms plain={r['plain_ms']:.4f} ms "
              f"sdpa={r['library_ms']:.4f} ms bound={r['bound_ms']:.4f} ms ({r['bound_by']})",
              flush=True)
    return results


# --------------------------------------------------------------------------- #
# Small-model parity: kernels on the card against plain versions on the CPU   #
# --------------------------------------------------------------------------- #
def run_parity(torch, np):
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.layers import tree_map
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving.sampler import greedy

    cfg = dataclasses.replace(get_smoke_config("qwen3_8b"), dtype="float32")
    cpu = TransformerLM(cfg, device="cpu")
    params_cpu = cpu.init_params(seed=0)
    gpu = TransformerLM(cfg, device="cuda")
    params_gpu = tree_map(lambda x: x.cuda(), params_cpu)
    n_slots, page, mb = 4, 16, 8
    rng = np.random.default_rng(0)
    tables = rng.permutation(n_slots * mb).astype(np.int32).reshape(n_slots, mb)
    pools = []
    for m in (cpu, gpu):
        pool = m.paged_cache_init(n_slots * mb, page, n_slots, mb)
        pool["block_tables"].copy_(torch.from_numpy(tables))
        pools.append(pool)
    tokens = rng.integers(1, cfg.vocab_size, size=(4, 32)).astype(np.int32)
    slots = np.array([0, 1, 2, n_slots], np.int32)
    starts = np.zeros(4, np.int32)
    lens = np.array([32, 17, 5, 0], np.int32)
    outs = []
    for m, p, pool, dev in ((cpu, params_cpu, pools[0], "cpu"), (gpu, params_gpu, pools[1], "cuda")):
        t = lambda x: torch.from_numpy(x).to(dev)
        logits, _ = m.prefill_chunk(p, t(tokens), pool, t(slots), t(starts), t(lens))
        dec, _ = m.decode_step(p, t(np.array([5, 6, 7, 8], np.int32)), pool,
                               t(np.array([True, True, True, False])))
        block = m.decode_steps(p, greedy(dec), pool, num_steps=4, sampler=greedy,
                               active=t(np.array([True, True, True, False])),
                               budgets=t(np.full(4, 4, np.int32)), rids=t(np.arange(4, dtype=np.int32)),
                               token_idx0=t(np.zeros(4, np.int32)))[0]
        outs.append((logits[:3].cpu(), dec[:3].cpu(), block[:, :3].cpu()))
    for a, b, what in zip(outs[0][:2], outs[1][:2], ("prefill", "decode")):
        err = float((a - b).abs().max())
        check(err <= TOL["float32"], f"{what} logits: card vs CPU max err {err:.3g}")
        print(f"  smoke float32 {what} logits card vs CPU: max_abs_err={err:.3g}")
    same = bool(torch.equal(outs[0][2], outs[1][2]))
    print(f"  smoke float32 fused decode tokens card == CPU: {same}")


# --------------------------------------------------------------------------- #
# Serve                                                                       #
# --------------------------------------------------------------------------- #
def warm(torch, model, params, eng, device):
    """One all-pad call of each serving entry (every write dropped, every
    lane inactive) so cuBLAS and the kernels are initialised before the
    measured serve."""
    from repro_torch.serving.sampler import greedy

    cfg = eng.cfg
    j, c = cfg.n_slots, cfg.prefill_chunk
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
    off = lambda n: torch.zeros(n, dtype=torch.bool, device=device)
    pad = torch.full((8,), j, dtype=torch.int32, device=device)
    cache = eng.slots.cache
    model.prefill_chunk(params, z(8, c), cache, pad, z(8), z(8))
    model.mixed_step(params, z(j), cache, z(8, c), pad, z(8), z(8), sampler=greedy,
                     dec_active=off(j), rids=z(j + 8), token_idx=z(j + 8),
                     sample_rows=off(j + 8))
    model.decode_steps(params, z(j), cache, num_steps=1, sampler=greedy,
                       active=off(j), budgets=z(j), rids=z(j), token_idx0=z(j))
    if device == "cuda":
        torch.cuda.synchronize()


def run_serve(torch, cfg, device="cuda", n_requests=16, output_max=128, max_len=640):
    """Serve a GSM8K-shaped closed-loop workload through the port's Engine
    (paged, mixed steps, hybrid scheduling as launch/serve.py sets it up) and
    check the result. Returns (launches per kernel, launches the schedule
    implies)."""
    from repro_torch.core import (
        CostModel,
        LagrangianPolicy,
        SortingPreemptiveScheduler,
        StageKind,
        build_clients,
        solve_offline,
    )
    from repro_torch.data import WorkloadSpec, gsm8k_like_workload
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving.engine import Engine, EngineConfig

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    model = TransformerLM(cfg, device=device)
    params = model.init_params(seed=0)
    sync()
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"  model {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B parameters ({cfg.dtype}), init "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    reqs = gsm8k_like_workload(WorkloadSpec(n_requests=n_requests, output_max=output_max),
                               seed=0, known_lengths=True)
    cm = CostModel(level_caps=(32, 64, 128, 256))
    asn = solve_offline(reqs, 8, cm).assignment
    clients = build_clients(8, reqs, asn)
    eng = Engine(model, params, EngineConfig(n_slots=8, max_len=max_len, kv_layout="paged",
                                             mixed_schedule=True), device=device)
    eng.profiler.cost_model = cm
    warm(torch, model, params, eng, device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    pda.reset_launch_count()
    fa.reset_launch_count()
    t0 = time.perf_counter()
    trace = eng.serve(reqs, clients, SortingPreemptiveScheduler(clients), LagrangianPolicy(),
                      policy_name="hybrid")
    sync()
    wall = time.perf_counter() - t0
    launches = {"paged_decode_attention": pda.launch_count, "flash_attention": fa.launch_count}

    trace.validate()
    for r in reqs:
        got = eng.generated.get(r.rid, [])
        check(len(got) == r.n_decode, f"request {r.rid} emitted {len(got)} of {r.n_decode}")
        check(all(0 <= t < cfg.vocab_size for t in got), f"request {r.rid}: invalid token id")
    kinds = [s.kind for s in trace.stages]
    decode_rounds = sum(s.rounds for s in trace.stages if s.kind is StageKind.DECODE)
    mixed = kinds.count(StageKind.MIXED)
    chunk_rounds = kinds.count(StageKind.PREFILL)
    expect = {
        "paged_decode_attention": cfg.n_layers * (decode_rounds + mixed),
        "flash_attention": cfg.n_layers * (mixed + chunk_rounds),
    }
    s = trace.summary()
    print(f"  serve: {len(reqs)} requests, {sum(len(v) for v in eng.generated.values())} "
          f"output tokens, utilization {s['utilization']}, makespan {s['makespan_s']} s, "
          f"{s['generation_speed_tok_s']} tok/s, wall {wall:.4f} s", flush=True)
    print(f"  stages: {mixed} mixed rounds, {chunk_rounds} chunk rounds, "
          f"{kinds.count(StageKind.DECODE)} fused decode stages ({decode_rounds} rounds), "
          f"decode dispatches {trace.meta['decode_dispatches']}, "
          f"prefill stall {trace.meta['prefill_stall_time_s']} s")
    if device == "cuda":
        print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  launches: {json.dumps(launches)} (expected {json.dumps(expect)})", flush=True)
    return launches, expect


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    t0 = time.perf_counter()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, {name}")
    phase("device", t0)

    t0 = time.perf_counter()
    build.build_all()
    for src, log in build.ptxas_log.items():
        regs = [l.strip() for l in log.splitlines() if "registers" in l]
        print(f"  {src}: {len(regs)} kernel variants; e.g. {regs[-1] if regs else log.strip()[:200]}")
    phase("build", t0)

    t0 = time.perf_counter()
    kres = run_kernel_checks(torch, np)
    phase("kernels", t0)

    t0 = time.perf_counter()
    run_parity(torch, np)
    phase("parity", t0)

    t0 = time.perf_counter()
    from repro_torch.configs import get_config

    launches, expect = run_serve(torch, get_config("qwen3_8b"))
    for kname, n in launches.items():
        check(n > 0, f"{kname} was never launched on the main path")
        check(n == expect[kname], f"{kname}: {n} launches, the schedule implies {expect[kname]}")
    phase("serve", t0)

    info = {
        "paged_decode_attention": ("src/repro_torch/kernels/csrc/paged_decode_attention.cu",
                                   "src/repro/kernels/paged_decode_attention.py:86"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:98"),
    }
    kernels = []
    for kname, (source, replaces) in info.items():
        r = kres[(kname, "qwen3-8b")]
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
