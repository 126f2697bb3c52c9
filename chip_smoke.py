#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py            # the smoke run below
    python3 chip_smoke.py --sweep    # kernel plans and L2 states, timed

Phases, each printing its seconds on a line of its own:

1. device  — find the CUDA device (exit non-zero without one) and print its
             name and power limit as nvidia-smi reports them;
2. build   — compile the hand-written kernels from src/repro_torch/kernels/csrc
             with nvcc for sm_90a (one nvcc per source, all at once), print
             each variant's registers and spills for kernels 1, 2 and 3, and
             check that flash's tensor-core variants issue HGMMA (cuobjdump);
3. kernels — hold each kernel against its plain PyTorch version on the card,
             at the serving shapes of Qwen3-8B (8 slots, 32 query and 8 KV
             heads, head_dim 128, up to 640 tokens a slot: paged decode and
             paged chunk flash over shuffled pages and -1 table entries in
             bf16; dense decode over the strided (B, S, KV, D) cache view with
             ragged lengths including 0, in bf16 and float32; dense flash at
             the dense prefill's shape), at the smoke shapes (head_dim 16) and
             at RecurrentGemma-9B's (16 query heads on one KV head, head_dim
             256: dense decode in bf16 and float32, dense flash with its window
             of 2048; the RG-LRU scan at the prefill's (8, 128, 4096), at the
             reference's test cases, at one token and chained across two
             calls); time the kernel, the plain version and one PyTorch
             library call (scaled_dot_product_attention on the same inputs,
             timed here only; no single call computes the scan) and compute
             the kernel's bound; time flash's tensor-core body at each CTA
             tile; check that one call of paged decode, and of dense decode
             at each shape and dtype, runs one device kernel (the splits
             merge in the same launch) and that two calls give the same
             bits;
4. parity  — float32 smoke models on the card (kernels) against the same
             models on the CPU (plain versions): the paged path (chunked
             prefill, decode, fused decode) and the dense path (whole-prompt
             prefill, fused decode) of the smoke Qwen3, the dense path of a
             sliding-window config whose ring wraps, and the smoke
             RecurrentGemma (ragged prefill, then decode steps that wrap its
             window-8 ring); logits within 1e-4, identical greedy tokens;
             and three smoke Qwen3 fleets under a scripted clock (a hard
             kill, a 2-speed fleet with stealing, a migrate_slot), with the
             same assignment, streams, steals, migrations and faults;
5. serve   — full-size Qwen3-8B (36 layers, bf16, random weights from a seed)
             behind the port's Engine, twice on the same weights and the same
             16 GSM8K-shaped requests (outputs capped at 128) under hybrid
             scheduling: the paged layout with mixed steps, then the dense
             layout with whole-prompt prefill stages and fused decode; checks
             the trace, the budgets, the token ids and that each kernel ran
             exactly as often as each schedule implies, every flash launch
             on the tensor-core body. Then the fleet on the same weights: two
             replicas of 8 slots (paged, mixed) over one weight set (the
             memory Fleet(...) adds must be the two pools), 32 GSM8K-shaped
             requests under the offline LPT partition, least-load dispatch
             and queued and running work stealing, every request exactly
             once, the makespan printed beside its lower bound (the paper
             prior's flat-pool bound, a model number: not a gate), launches exact
             summed over the replicas; then 8 requests
             with replica 0 drained mid-decode by page-copy (zero drops,
             zero recomputed tokens, each import's landed pages holding the
             export's CRC32), page-copy times printed. Then, Qwen3 freed,
             full-size RecurrentGemma-9B (38 layers, bf16, random weights)
             on the same 16 requests in two waves of 8 slots through its own
             prefill and decode_step (launch.generate; the Engine does not
             take it); checks the budgets, the token ids and that the scan
             ran in each of the 26 recurrent layers and kernels 2 and 3 in
             each of the 12 attention layers of every prefill and step.

Then one JSON line naming every ported kernel (kernel 2 once per entry, and
kernels 2 and 3 again at RecurrentGemma's shapes) with its launches on each
path (flash's also by device body) and this run's times, and, last,
{"ok": true, "device": {...}}.
Any failed check raises, so the script exits non-zero and prints no result.

``--sweep`` builds the kernels and times, each checked against its plain
version: paged decode attention at the Qwen3-8B serving shape at every
split count from 1 to 20; dense decode attention on each body at every split
count from 1 to 20 at Qwen3-8B's and RecurrentGemma-9B's decode shapes
(RecurrentGemma's also with the serve's lengths, at most 256 keys) and
inside the models' decode (Qwen3-8B cut to 8 layers, RecurrentGemma-9B to
6) at three context lengths under several plans; and
kernels 1, 2 and 3 (at both shapes) with the L2 cold (as above), warm (calls
back to back behind a device-side sleep) and host-paced (events around each
call, no sleep ahead: what a loop of calls reads when the host launches
slower than the device runs), beside a one-element ``add_``; it ends with
one JSON line of those times.
"""
from __future__ import annotations

import contextlib
import dataclasses
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
F32_FLOPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
RGLRU_TOL = 1e-5                 # the scan vs its plain version (float32)
LOGITS_TOL = 1e-4                                   # float32 model logits, card vs CPU
KERNEL_TOL = {"bfloat16": 2e-2, "float32": 2e-5}    # a kernel vs its plain version
# The serve (slot length, dense prefill buckets, requests) is defined once, in
# repro_torch.launch.profile_step, which profiles its stages.


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


def time_warm_ms(torch, fn, batch=20, reps=10):
    """Median device time of ``fn`` in ms with a warm L2: ``batch`` calls
    back to back between one pair of events, queued behind a device-side
    sleep so that the host's launch time between calls does not show."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(20_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def time_host_paced_ms(torch, fn, iters=30):
    """Median ms between events recorded around each call, the calls back to
    back with no sleep ahead: where the host takes longer to launch a call
    than the device takes to run the last, the start event fires on an idle
    device and the reading is the host's launch time."""
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
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def max_err(torch, out, ref, tol):
    out, ref = out.float(), ref.float()
    live = torch.isfinite(ref)
    err = (out - ref).abs()[live]
    bad = err > tol + tol * ref.abs()[live]
    check(bool(torch.isfinite(out).all()), "kernel output is not finite")
    check(not bool(bad.any()), f"kernel disagrees with its plain version (max err {float(err.max()):.3g})")
    return float(err.max())


def device_kernels(torch, fn, attempts=3):
    """Names of the device kernels one call of ``fn`` runs (torch.profiler).
    A trace that holds no device event at all missed the call (on the card
    a process's later traces now and then come back empty), so the call
    is traced again, up to ``attempts`` times; every retry is printed."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
        if events:
            break
        print(f"  device_kernels: trace {attempt} of {attempts} held no device event", flush=True)
    return [n for n in events if "emcpy" not in n and "emset" not in n]


def check_one_kernel_and_repeat(torch, what, call, out):
    """One call of ``call`` runs one device kernel (split keys merge in the
    same launch), and a second call gives the same bits as ``out``."""
    names = device_kernels(torch, call)
    check(len(names) == 1, f"{what}: one call ran {len(names)} device kernels: {names}")
    check(bool(torch.equal(out, call())), f"{what}: two calls differ")
    return names[0]


def time_tiles(torch, flush, launch, d):
    """The tensor-core body's CTA tiles (``flash_attention.TILES``; the key
    split only at head_dim <= 128) on the same inputs: ``launch(tile)`` runs
    one; ms by tile name."""
    from repro_torch.kernels import flash_attention as fa

    return {fa.TILES[t]: time_ms(torch, lambda: launch(t), flush) for t in range(3 if d <= 128 else 2)}


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


def n_sms(torch):
    return torch.cuda.get_device_properties(0).multi_processor_count


def dense_plan(torch, da, q, k):
    """Kernel 3's plan for these inputs, printed with its body's name."""
    p = da.plan(q.dtype, q.shape[0], q.shape[1], k.shape[1], k.shape[2], q.shape[2], n_sms(torch))
    return f"{da.BODIES[p.body]} {p.split}"


def dense_decode_case(torch, np, h, kv, d, dtype, s, b=8, seed=3, max_len=None):
    """q (B, H, D) and the (B, S, KV, D) layer slice of a dense cache seen as
    (B, KV, S, D), as the model passes it; ragged lengths up to ``max_len``
    (default S), the last 0."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, (max_len or s) + 1, size=b).astype(np.int32)
    lengths[-1] = 0                                # an idle decode lane
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, h, d, device="cuda", generator=g).to(dtype)
    k = torch.randn(b, s, kv, d, device="cuda", generator=g).to(dtype).transpose(1, 2)
    v = torch.randn(b, s, kv, d, device="cuda", generator=g).to(dtype).transpose(1, 2)
    return q, k, v, torch.from_numpy(lengths).cuda()


def dense_prefill_case(torch, h, kv, d, b, s, seed=4):
    """Bucket-padded prompts as the dense prefill holds them: bshk q/k/v seen
    as (B, H, S, D) / (B, KV, S, D) views."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda heads: torch.randn(b, s, heads, d, device="cuda", generator=g).bfloat16().transpose(1, 2)
    return mk(h), mk(kv), mk(kv)


def dense_decode_bound(q, k, lengths):
    b, h, d = q.shape
    kv = k.shape[1]
    toks = int(lengths.sum())
    nbytes = 2 * q.numel() * q.element_size() + lengths.numel() * 4
    nbytes += 2 * toks * kv * d * k.element_size()          # K and V of live tokens
    flops = 4 * d * h * toks
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def dense_flash_bound(q, k):
    b, h, s, d = q.shape
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()   # q, out, k, v
    flops = 4 * d * h * b * s * (s + 1) // 2                      # causal pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def rglru_bound(a):
    """Read a and x and h0 once, write h and h_final once; one multiply and
    one add an element, in float32 on the CUDA cores."""
    b, s, r = a.shape
    nbytes = (3 * b * s * r + 2 * b * r) * 4
    flops = 2 * b * s * r
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


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

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.launch.profile_step import SERVE_LEN, dense_prefill_len
    from repro_torch.models.cache import paged_key_positions

    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    results = {}
    for label, (h, kv, d) in (("qwen3-8b", (32, 8, 128)), ("smoke", (4, 2, 16))):
        # kernel 3: dense decode attention, both dtypes; timed in bf16
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, lengths = dense_decode_case(torch, np, h, kv, d, dt, SERVE_LEN)
            check(not k.is_contiguous(), "decode case must be the strided cache view")
            out = da.decode_attention(q, k, v, lengths)
            torch.cuda.synchronize()
            name = str(dt).split(".")[1]
            err = max_err(torch, out, da.decode_attention_plain(q, k, v, lengths), KERNEL_TOL[name])
            check(bool((out[-1] == 0).all()), "decode_attention: a zero-length row is not 0")
            kname = check_one_kernel_and_repeat(
                torch, f"decode_attention [{label}] {name}", lambda: da.decode_attention(q, k, v, lengths), out)
            print(f"  decode_attention [{label}] {name}: max_abs_err={err:.4g}, {dense_plan(torch, da, q, k)}, "
                  f"one call, one device kernel ({kname[:60]}), two calls equal", flush=True)
        g = h // kv
        qs = q[:, :, None]
        ks, vs = (x.repeat_interleave(g, dim=1).contiguous() for x in (k, v))
        mask = (torch.arange(k.shape[2], device="cuda")[None, :] < lengths[:, None])[:, None, None]
        ms = time_ms(torch, lambda: da.decode_attention(q, k, v, lengths), flush)
        plain_ms = time_ms(torch, lambda: da.decode_attention_plain(q, k, v, lengths), flush)
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask), flush)
        bound_ms, bound_by = dense_decode_bound(q, k, lengths)
        results[("decode_attention", label)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bound_ms, bound_by=bound_by,
        )
        # kernel 2, dense entry, at the dense prefill's shape: 8 prompts of
        # the largest bucket the serve uses, causal
        q, k, v = dense_prefill_case(torch, h, kv, d, 8, dense_prefill_len())
        out = fa.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = max_err(torch, out, fa.flash_attention_plain(q, k, v, causal=True), KERNEL_TOL["bfloat16"])
        qs = q.contiguous()
        ks, vs = (x.repeat_interleave(g, dim=1).contiguous() for x in (k, v))
        ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True), flush)
        plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, causal=True), flush)
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True), flush)
        bound_ms, bound_by = dense_flash_bound(q, k)
        results[("flash_attention_dense", label)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bound_ms, bound_by=bound_by,
            ms_by_tile=time_tiles(torch, flush, lambda t: fa._launch_dense(
                q, k, v, True, 0, d ** -0.5, t), d) if d >= 64 else None,
        )
        # kernel 1: paged decode attention
        q, k, v, tables, lengths = decode_case(torch, np, h, kv, d)
        out = pda.paged_decode_attention(q, k, v, tables, lengths)
        torch.cuda.synchronize()
        err = max_err(torch, out, pda.paged_decode_attention_plain(q, k, v, tables, lengths),
                      KERNEL_TOL["bfloat16"])
        mask = (paged_key_positions(tables, lengths, k.shape[2]) >= 0)[:, None, None, :]
        qs, ks, vs = sdpa_inputs(q, k, v, tables)
        ms = time_ms(torch, lambda: pda.paged_decode_attention(q, k, v, tables, lengths), flush)
        plain_ms = time_ms(torch, lambda: pda.paged_decode_attention_plain(q, k, v, tables, lengths), flush)
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask), flush)
        bound_ms, bound_by = decode_bound(q, k, tables, lengths)
        kname = check_one_kernel_and_repeat(
            torch, "paged_decode_attention", lambda: pda.paged_decode_attention(q, k, v, tables, lengths), out)
        plan = pda.decode_plan(q.shape[0], h, kv, tables.shape[1], k.shape[2], n_sms(torch))
        print(f"  paged_decode_attention [{label}] {plan}: one call, one device kernel ({kname[:60]}), "
              f"two calls equal")
        results[("paged_decode_attention", label)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bound_ms, bound_by=bound_by,
        )
        # kernel 2: flash attention, paged chunk entry
        q, k, v, tables, starts, valid, chunk_lens = chunk_case(torch, np, h, kv, d)
        out = fa.paged_chunk_attention(q, k, v, tables, starts, valid)
        torch.cuda.synchronize()
        ref = fa.paged_chunk_attention_plain(q, k, v, tables, starts, valid)
        err = max_err(torch, out, ref, KERNEL_TOL["bfloat16"])
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
            ms_by_tile=time_tiles(torch, flush, lambda t: fa._launch_paged(
                q, k, v, tables, starts, valid, d ** -0.5, t), d) if d >= 64 else None,
        )
        # the dense entry of kernel 2 under windows and without the causal
        # mask, against its plain version
        g = torch.Generator(device="cuda").manual_seed(2)
        dq = torch.randn(2, h, 256, d, device="cuda", generator=g).bfloat16()
        dk = torch.randn(2, kv, 256, d, device="cuda", generator=g).bfloat16()
        dv = torch.randn(2, kv, 256, d, device="cuda", generator=g).bfloat16()
        for causal, window in ((True, 0), (True, 64), (False, 0)):
            out = fa.flash_attention(dq, dk, dv, causal=causal, window=window)
            torch.cuda.synchronize()
            derr = max_err(torch, out, fa.flash_attention_plain(
                dq, dk, dv, causal=causal, window=window), KERNEL_TOL["bfloat16"])
            print(f"  flash_attention dense {label} causal={causal} window={window}: "
                  f"max_abs_err={derr:.3g}")
    results.update(run_recurrentgemma_kernel_checks(torch, np, F, flush))
    for (name, label), r in results.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        tiles = r.get("ms_by_tile")
        print(f"  {name} [{label}] timed: max_abs_err={r['max_abs_err']:.4g} "
              f"kernel={r['ms']:.4f} ms plain={r['plain_ms']:.4f} ms "
              f"library={lib} bound={r['bound_ms']:.4f} ms ({r['bound_by']})"
              + ("".join(f"; {t}: {ms:.4f} ms" for t, ms in tiles.items()) if tiles else ""),
              flush=True)
    return results


def run_recurrentgemma_kernel_checks(torch, np, F, flush):
    """Kernels 2, 3 and 4 at RecurrentGemma-9B's shapes: 16 query heads on
    one KV head at head_dim 256, window 2048, rnn width 4096, 8 slots."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru
    from repro_torch.launch.profile_step import SERVE_LEN, dense_prefill_len

    label, (h, kv, d), window = "recurrentgemma-9b", (16, 1, 256), 2048
    results = {}
    # kernel 3 over the ring (W = min(2048, SERVE_LEN)), both dtypes; timed in bf16
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, lengths = dense_decode_case(torch, np, h, kv, d, dt, SERVE_LEN)
        out = da.decode_attention(q, k, v, lengths)
        torch.cuda.synchronize()
        name = str(dt).split(".")[1]
        err = max_err(torch, out, da.decode_attention_plain(q, k, v, lengths), KERNEL_TOL[name])
        check(bool((out[-1] == 0).all()), "decode_attention: a zero-length row is not 0")
        kname = check_one_kernel_and_repeat(
            torch, f"decode_attention [{label}] {name}", lambda: da.decode_attention(q, k, v, lengths), out)
        print(f"  decode_attention [{label}] {name}: max_abs_err={err:.4g}, {dense_plan(torch, da, q, k)}, "
              f"one call, one device kernel ({kname[:60]}), two calls equal", flush=True)
    qs = q[:, :, None]
    ks, vs = (x.repeat_interleave(h // kv, dim=1).contiguous() for x in (k, v))
    mask = (torch.arange(k.shape[2], device="cuda")[None, :] < lengths[:, None])[:, None, None]
    results[("decode_attention", label)] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: da.decode_attention(q, k, v, lengths), flush),
        plain_ms=time_ms(torch, lambda: da.decode_attention_plain(q, k, v, lengths), flush),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask),
                           flush),
        **dict(zip(("bound_ms", "bound_by"), dense_decode_bound(q, k, lengths))),
    )
    # kernel 2's dense entry at the wave prefill's shape, causal, window 2048;
    # float32 checked at the same shape
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (x.to(dt) for x in dense_prefill_case(torch, h, kv, d, 8, dense_prefill_len()))
        out = fa.flash_attention(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        name = str(dt).split(".")[1]
        err = max_err(torch, out, fa.flash_attention_plain(q, k, v, causal=True, window=window),
                      KERNEL_TOL[name])
        print(f"  flash_attention dense [{label}] {name}: max_abs_err={err:.4g}", flush=True)
    qs = q.contiguous()
    ks, vs = (x.repeat_interleave(h // kv, dim=1).contiguous() for x in (k, v))
    results[("flash_attention_dense", label)] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True, window=window), flush),
        plain_ms=time_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, causal=True, window=window), flush),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True),
                           flush),
        **dict(zip(("bound_ms", "bound_by"), dense_flash_bound(q, k))),
        ms_by_tile=time_tiles(torch, flush, lambda t: fa._launch_dense(
            q, k, v, True, window, d ** -0.5, t), d),
    )
    # kernel 4: the prefill's shape, the reference's test cases
    # (tests/test_kernels.py:161), one decode token, and two chained calls
    g = torch.Generator(device="cuda").manual_seed(5)
    errs = {}
    for b, s, r in ((8, dense_prefill_len(), 4096), (2, 512, 256), (1, 256, 128), (3, 128, 384),
                    (8, 1, 4096)):
        a = torch.sigmoid(torch.randn(b, s, r, device="cuda", generator=g))
        x = torch.randn(b, s, r, device="cuda", generator=g)
        h0 = torch.randn(b, r, device="cuda", generator=g)
        out, hf = rglru.rglru_scan(a, x, h0)
        torch.cuda.synchronize()
        ref, ref_hf = rglru.rglru_scan_plain(a, x, h0)
        errs[(b, s, r)] = max(max_err(torch, out, ref, RGLRU_TOL), max_err(torch, hf, ref_hf, RGLRU_TOL))
        print(f"  rglru_scan {(b, s, r)}: max_abs_err={errs[(b, s, r)]:.4g}", flush=True)
        if (b, s, r) == (8, dense_prefill_len(), 4096):
            timed = (a, x, h0)
    a, x = torch.sigmoid(torch.randn(1, 256, 128, device="cuda", generator=g)), \
        torch.randn(1, 256, 128, device="cuda", generator=g)
    full, hf_full = rglru.rglru_scan(a, x)
    _, hf1 = rglru.rglru_scan(a[:, :128], x[:, :128])
    h2, hf2 = rglru.rglru_scan(a[:, 128:], x[:, 128:], hf1)
    torch.cuda.synchronize()
    err = max(max_err(torch, h2, full[:, 128:], RGLRU_TOL), max_err(torch, hf2, hf_full, RGLRU_TOL))
    print(f"  rglru_scan chained across two calls: max_abs_err={err:.4g}", flush=True)
    a, x, h0 = timed
    results[("rglru_scan", label)] = dict(
        max_abs_err=max(errs.values()),
        ms=time_ms(torch, lambda: rglru.rglru_scan(a, x, h0), flush),
        plain_ms=time_ms(torch, lambda: rglru.rglru_scan_plain(a, x, h0), flush),
        library_ms=None,
        **dict(zip(("bound_ms", "bound_by"), rglru_bound(a))),
    )
    return results


# --------------------------------------------------------------------------- #
# Small-model parity: kernels on the card against plain versions on the CPU   #
# --------------------------------------------------------------------------- #
def _card_and_cpu(torch, cfg):
    """The same float32 model and weights on the CPU and on the card."""
    from repro_torch.models.layers import tree_map
    from repro_torch.models.transformer import TransformerLM

    cpu = TransformerLM(cfg, device="cpu")
    params_cpu = cpu.init_params(seed=0)
    return (cpu, params_cpu), (TransformerLM(cfg, device="cuda"), tree_map(lambda x: x.cuda(), params_cpu))


def _compare(torch, outs, what):
    """outs: two (prefill logits, decode logits, token block) triples, CPU
    first; logits within the float32 tolerance, tokens identical."""
    for a, b, kind in zip(outs[0][:2], outs[1][:2], ("prefill", "decode")):
        err = float((a - b).abs().max())
        check(err <= LOGITS_TOL, f"{what} {kind} logits: card vs CPU max err {err:.3g}")
        print(f"  {what} float32 {kind} logits card vs CPU: max_abs_err={err:.3g}")
    check(bool(torch.equal(outs[0][2], outs[1][2])), f"{what}: fused decode tokens differ card vs CPU")
    print(f"  {what} float32 fused decode tokens card == CPU: True", flush=True)


def run_dense_parity(torch, np, cfg, what, k_steps=8):
    """Whole-prompt prefill of ragged prompts into the dense slot cache, one
    decode step, then a fused horizon of ``k_steps``."""
    from repro_torch.serving.sampler import greedy

    n, s, max_len = 4, 32, 64
    lengths = np.array([30, 17, 5, 24], np.int32)
    rng = np.random.default_rng(1)
    tokens = rng.integers(1, cfg.vocab_size, size=(n, s)).astype(np.int32)
    tokens[np.arange(s)[None, :] >= lengths[:, None]] = 0
    outs = []
    for m, p in _card_and_cpu(torch, cfg):
        dev = m.device
        t = lambda x: torch.from_numpy(x).to(dev)
        cache = m.cache_init(n, max_len)
        logits, cache = m.prefill(p, t(tokens), cache, lengths=t(lengths))
        dec, cache = m.decode_step(p, greedy(logits), cache)
        on = torch.ones(n, dtype=torch.bool, device=dev)
        block = m.decode_steps(p, greedy(dec), cache, num_steps=k_steps, sampler=greedy, active=on,
                               budgets=t(np.full(n, k_steps, np.int32)),
                               rids=t(np.arange(n, dtype=np.int32)), token_idx0=t(np.ones(n, np.int32)))[0]
        outs.append((logits.cpu(), dec.cpu(), block.cpu()))
    _compare(torch, outs, what)


def run_parity(torch, np):
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ArchConfig
    from repro_torch.serving.sampler import greedy

    cfg = dataclasses.replace(get_smoke_config("qwen3_8b"), dtype="float32")
    models = _card_and_cpu(torch, cfg)
    n_slots, page, mb = 4, 16, 8
    rng = np.random.default_rng(0)
    tables = rng.permutation(n_slots * mb).astype(np.int32).reshape(n_slots, mb)
    pools = []
    for m, _ in models:
        pool = m.paged_cache_init(n_slots * mb, page, n_slots, mb)
        pool["block_tables"].copy_(torch.from_numpy(tables))
        pools.append(pool)
    tokens = rng.integers(1, cfg.vocab_size, size=(4, 32)).astype(np.int32)
    slots = np.array([0, 1, 2, n_slots], np.int32)
    starts = np.zeros(4, np.int32)
    lens = np.array([32, 17, 5, 0], np.int32)
    outs = []
    for (m, p), pool in zip(models, pools):
        t = lambda x: torch.from_numpy(x).to(m.device)
        logits, _ = m.prefill_chunk(p, t(tokens), pool, t(slots), t(starts), t(lens))
        dec, _ = m.decode_step(p, t(np.array([5, 6, 7, 8], np.int32)), pool,
                               t(np.array([True, True, True, False])))
        block = m.decode_steps(p, greedy(dec), pool, num_steps=4, sampler=greedy,
                               active=t(np.array([True, True, True, False])),
                               budgets=t(np.full(4, 4, np.int32)), rids=t(np.arange(4, dtype=np.int32)),
                               token_idx0=t(np.zeros(4, np.int32)))[0]
        outs.append((logits[:3].cpu(), dec[:3].cpu(), block[:, :3].cpu()))
    _compare(torch, outs, "smoke paged")
    run_dense_parity(torch, np, cfg, "smoke dense")
    # tests/test_fused_decode.py:126: W = 24, so prompts of 30 and 24 tokens
    # and the decode steps after them wrap the ring
    swa = ArchConfig(name="swa", family="dense", n_layers=2, d_model=64, n_heads=4,
                     n_kv_heads=2, d_ff=128, vocab_size=256, sliding_window=24,
                     dtype="float32")
    run_dense_parity(torch, np, swa, "sliding-window ring")
    run_recurrentgemma_parity(torch, np)


def run_recurrentgemma_parity(torch, np, steps=12):
    """The float32 smoke RecurrentGemma (8 layers, window 8): a ragged
    prefill (prompts of 12, 9 and 7 tokens, so the ring wraps), then greedy
    decode steps that wrap it again, on the card and on the CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.layers import tree_map
    from repro_torch.models.recurrentgemma import RecurrentGemma
    from repro_torch.serving.sampler import greedy

    cfg = dataclasses.replace(get_smoke_config("recurrentgemma_9b"), dtype="float32")
    cpu = RecurrentGemma(cfg, device="cpu")
    params_cpu = cpu.init_params(seed=0)
    lengths = np.array([12, 9, 7], np.int32)
    tokens = np.random.default_rng(1).integers(1, cfg.vocab_size, size=(3, 12)).astype(np.int32)
    tokens[np.arange(12)[None, :] >= lengths[:, None]] = 0
    outs = []
    for m, p in ((cpu, params_cpu),
                 (RecurrentGemma(cfg, device="cuda"), tree_map(lambda x: x.cuda(), params_cpu))):
        t = lambda x: torch.from_numpy(x).to(m.device)
        logits, cache = m.prefill(p, t(tokens), m.cache_init(3, 32), lengths=t(lengths))
        dec, toks = [], []
        cur = greedy(logits)
        for _ in range(steps):
            step_logits, cache = m.decode_step(p, cur, cache)
            cur = greedy(step_logits)
            dec.append(step_logits)
            toks.append(cur)
        outs.append((logits.cpu(), torch.stack(dec).cpu(), torch.stack(toks).cpu()))
    for a, b, kind in zip(outs[0][:2], outs[1][:2], ("prefill", "decode")):
        err = float((a - b).abs().max())
        check(err <= LOGITS_TOL, f"recurrentgemma {kind} logits: card vs CPU max err {err:.3g}")
        print(f"  smoke recurrentgemma float32 {kind} logits card vs CPU: max_abs_err={err:.3g}")
    check(bool(torch.equal(outs[0][2], outs[1][2])), "recurrentgemma: greedy tokens differ card vs CPU")
    print(f"  smoke recurrentgemma float32 {steps} decode steps (ring of 8 wrapped), "
          f"tokens card == CPU: True", flush=True)


# --------------------------------------------------------------------------- #
# Serve                                                                       #
# --------------------------------------------------------------------------- #
def warm(torch, model, params, eng):
    """All-pad calls of the serving entries of the engine's layout (every
    write dropped or thrown away, every lane inactive) so cuBLAS and the
    kernels are initialised before the measured serve: the engine's own
    warm pass on the paged layout, one prefill and one decode step on the
    dense one."""
    from repro_torch.serving.sampler import greedy

    if eng.cfg.kv_layout == "paged":
        eng.warm_serving_shapes()
        return
    j = eng.cfg.n_slots
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device=model.device)
    s = eng.cfg.prefill_seq_buckets[0]
    model.prefill(params, z(1, s), model.cache_init(1, s), lengths=z(1) + 1)
    model.decode_steps(params, z(j), eng.slots.cache, num_steps=1, sampler=greedy,
                       active=torch.zeros(j, dtype=torch.bool, device=model.device),
                       budgets=z(j), rids=z(j), token_idx0=z(j))
    torch.cuda.synchronize()


def kernel_modules():
    """Each ported kernel's wrapper module by launch-count name."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import rglru

    return {"paged_decode_attention": pda, "flash_attention": fa, "decode_attention": da,
            "rglru_scan": rglru}


def check_flash_variants(path, launches):
    """Every flash launch of a (bf16) serve ran the tensor-core body;
    returns flash's launches by body."""
    from repro_torch.kernels import flash_attention as fa

    by = dict(fa.launch_count_by_variant)
    print(f"  {path} flash launches by body: {json.dumps(by)}", flush=True)
    check(by["tensor_cores"] == launches["flash_attention"] and by["cuda_cores"] == 0,
          f"{path}: bf16 flash launches off the tensor-core body: {by}")
    return by


def check_launches(path, launches, expect):
    """Every kernel launched exactly as often as the path implies, and each
    kernel of the path at least once."""
    print(f"  {path} launches: {json.dumps(launches)} (expected {json.dumps(expect)})", flush=True)
    for name, n in launches.items():
        check(n == expect[name], f"{path}: {name}: {n} launches, the path implies {expect[name]}")
        if expect[name]:
            check(n > 0, f"{path}: {name} was never launched on its path")


def run_serve(torch, model, params, layout):
    """Serve the GSM8K-shaped closed-loop workload through the port's Engine
    under hybrid scheduling as launch/serve.py sets it up, on the paged
    layout (mixed steps) or the dense layout (whole-prompt prefill stages),
    and check the result. Returns (engine, launches per kernel, flash's
    launches by body)."""
    from repro_torch.core import (
        CostModel,
        LagrangianPolicy,
        SortingPreemptiveScheduler,
        StageKind,
        build_clients,
        solve_offline,
    )
    from repro_torch.launch.profile_step import DENSE_BUCKETS, SERVE_LEN, serve_workload
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg = model.cfg
    reqs = serve_workload()
    cm = CostModel(level_caps=(32, 64, 128, 256))
    asn = solve_offline(reqs, 8, cm).assignment
    clients = build_clients(8, reqs, asn)
    if layout == "paged":
        ecfg = EngineConfig(n_slots=8, max_len=SERVE_LEN, kv_layout="paged", mixed_schedule=True)
    else:
        ecfg = EngineConfig(n_slots=8, max_len=SERVE_LEN, kv_layout="dense",
                            prefill_seq_buckets=DENSE_BUCKETS)
    eng = Engine(model, params, ecfg, device="cuda")
    eng.profiler.cost_model = cm
    warm(torch, model, params, eng)
    torch.cuda.reset_peak_memory_stats()
    kernels = kernel_modules()
    for mod in kernels.values():
        mod.reset_launch_count()
    t0 = time.perf_counter()
    trace = eng.serve(reqs, clients, SortingPreemptiveScheduler(clients), LagrangianPolicy(),
                      policy_name="hybrid")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: mod.launch_count for name, mod in kernels.items()}

    trace.validate()
    for r in reqs:
        got = eng.generated.get(r.rid, [])
        check(len(got) == r.n_decode, f"{layout}: request {r.rid} emitted {len(got)} of {r.n_decode}")
        check(all(0 <= t < cfg.vocab_size for t in got), f"{layout}: request {r.rid}: invalid token id")
    kinds = [s.kind for s in trace.stages]
    decode_rounds = sum(s.rounds for s in trace.stages if s.kind is StageKind.DECODE)
    mixed = kinds.count(StageKind.MIXED)
    prefills = kinds.count(StageKind.PREFILL)
    if layout == "paged":
        expect = {
            "paged_decode_attention": cfg.n_layers * (decode_rounds + mixed),
            "flash_attention": cfg.n_layers * (mixed + prefills),
            "decode_attention": 0,
            "rglru_scan": 0,
        }
    else:
        expect = {
            "paged_decode_attention": 0,
            "flash_attention": cfg.n_layers * prefills,
            "decode_attention": cfg.n_layers * decode_rounds,
            "rglru_scan": 0,
        }
    by_variant = check_flash_variants(layout, launches)
    s = trace.summary()
    stall = trace.meta["prefill_stall_time_s"]
    print(f"  {layout} serve: {len(reqs)} requests, {sum(len(v) for v in eng.generated.values())} "
          f"output tokens, utilization {s['utilization']}, makespan {s['makespan_s']} s, "
          f"{s['generation_speed_tok_s']} tok/s, wall {wall:.4f} s", flush=True)
    print(f"  {layout} stages: {prefills} prefill stages ({'chunk rounds' if layout == 'paged' else 'whole prompts'}), "
          f"{mixed} mixed rounds, {kinds.count(StageKind.DECODE)} fused decode stages "
          f"({decode_rounds} rounds), decode dispatches {trace.meta['decode_dispatches']}, "
          f"prefill stall {stall} s")
    print(f"  {layout} peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check_launches(layout, launches, expect)
    if layout == "dense":
        check(stall > 0, "dense: no prefill stage ran while decoders were active")
    return eng, launches, by_variant


def run_recurrentgemma_serve(torch, model, params):
    """The serve's 16 requests through RecurrentGemma's own prefill and
    decode_step in two waves of 8 slots (launch.generate), after a warm-up
    wave; returns the launches per kernel and flash's launches by body."""
    from repro_torch.launch.generate import generate_waves
    from repro_torch.launch.profile_step import SERVE_LEN, dense_prefill_len, serve_workload

    cfg = model.cfg
    reqs = serve_workload()
    waves = dict(n_slots=8, max_len=SERVE_LEN, prefill_len=dense_prefill_len())
    # warm-up: cuBLAS and the kernels initialised at the serve's shapes
    generate_waves(model, params, [dataclasses.replace(r, n_decode=2) for r in reqs[:8]], **waves)
    torch.cuda.reset_peak_memory_stats()
    kernels = kernel_modules()
    for mod in kernels.values():
        mod.reset_launch_count()
    t0 = time.perf_counter()
    res = generate_waves(model, params, reqs, **waves)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: mod.launch_count for name, mod in kernels.items()}

    for r in reqs:
        got = res.generated.get(r.rid, [])
        check(len(got) == r.n_decode, f"recurrentgemma: request {r.rid} emitted {len(got)} of {r.n_decode}")
        check(all(0 <= t < cfg.vocab_size for t in got), f"recurrentgemma: request {r.rid}: invalid token id")
    calls = res.prefills + res.decode_steps
    n_attn, n_rec = model.n_periods, model.n_rec
    expect = {
        "paged_decode_attention": 0,
        "flash_attention": n_attn * res.prefills,
        "decode_attention": n_attn * res.decode_steps,
        "rglru_scan": n_rec * calls,
    }
    print(f"  recurrentgemma serve: {len(reqs)} requests in {res.prefills} waves of 8 slots, "
          f"{res.tokens} output tokens, {res.decode_steps} decode steps, wall {wall:.4f} s", flush=True)
    print(f"  recurrentgemma tokens/s: {res.tokens / wall:.3f}")
    print(f"  recurrentgemma ms per decode step: {1e3 * res.decode_s / res.decode_steps:.3f}")
    print(f"  recurrentgemma ms per prefill (8 x {waves['prefill_len']}): "
          f"{1e3 * res.prefill_s / res.prefills:.3f}")
    print(f"  recurrentgemma peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    by_variant = check_flash_variants("recurrentgemma", launches)
    check_launches("recurrentgemma", launches, expect)
    return launches, by_variant


# --------------------------------------------------------------------------- #
# Fleet                                                                       #
# --------------------------------------------------------------------------- #
class ScriptedClock:
    """Stands in for ``repro_torch.serving.engine.time``: every
    ``perf_counter`` call advances 2**-10 s, so each stage lasts exactly that
    (over its replica's speed factor) and no fleet decision reads the wall
    clock. A power of two keeps every clock reading exact."""

    STEP = 2.0 ** -10

    def __init__(self):
        self.calls = 0

    def perf_counter(self):
        self.calls += 1
        return self.calls * self.STEP


@contextlib.contextmanager
def scripted_clock():
    """The engine module reads a ScriptedClock while the context is open."""
    from repro_torch.serving import engine as engine_mod

    saved = engine_mod.time
    engine_mod.time = ScriptedClock()
    try:
        yield
    finally:
        engine_mod.time = saved


def fleet_expect(cfg, report):
    """Kernel launches a paged fleet serve implies: summed over every
    replica's trace (a drained replica's stages before the drain included;
    an import runs no prefill)."""
    from repro_torch.core import StageKind

    stages = [s for t in report.traces for s in t.stages]
    rounds = sum(s.rounds for s in stages if s.kind is StageKind.DECODE)
    mixed = sum(1 for s in stages if s.kind is StageKind.MIXED)
    prefills = sum(1 for s in stages if s.kind is StageKind.PREFILL)
    return {
        "paged_decode_attention": cfg.n_layers * (rounds + mixed),
        "flash_attention": cfg.n_layers * (mixed + prefills),
        "decode_attention": 0,
        "rglru_scan": 0,
    }


def check_exactly_once(what, fleet, report, reqs, vocab):
    """Every request finished on exactly one replica's trace and emitted its
    budget of valid token ids once (``Fleet.generated`` raises on a request
    decoded on two replicas)."""
    report.validate()
    served = [r.rid for t in report.traces for r in t.requests]
    check(sorted(served) == sorted(r.rid for r in reqs), f"{what}: served {sorted(served)}")
    gen = fleet.generated
    for r in reqs:
        got = gen.get(r.rid, [])
        check(len(got) == r.n_decode, f"{what}: request {r.rid} emitted {len(got)} of {r.n_decode}")
        check(all(0 <= t < vocab for t in got), f"{what}: request {r.rid}: invalid token id")


def tree_bytes(tree):
    return sum(x.numel() * x.element_size() for x in _leaves(tree))


def watch_page_copies(torch, fleet):
    """Wrap every replica's export_slot / import_slot: time each (device
    synchronised), time the payload's CRC alone, and check right after each
    import that the CRC of the landed pages, gathered back out of the
    destination pool, equals the export's checksum. Returns the records."""
    from repro_torch.serving.kv_slots import page_checksum

    records = []

    def wrap(eng):
        export, import_ = eng.export_slot, eng.import_slot

        def export_slot(slot):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ckpt = export(slot)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            page_checksum(ckpt.k_pages, ckpt.v_pages, ckpt.kv_length)
            crc_ms = 1e3 * (time.perf_counter() - t1)
            nbytes = 2 * ckpt.k_pages.numel() * ckpt.k_pages.element_size()
            records.append(dict(rid=ckpt.req.rid, kind=ckpt.kind, pages=ckpt.n_pages, bytes=nbytes,
                                export_ms=1e3 * (t1 - t0), crc_ms=crc_ms))
            return ckpt

        def import_slot(ckpt):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            slot = import_(ckpt)
            torch.cuda.synchronize()
            rec = records[-1]
            rec["import_ms"] = 1e3 * (time.perf_counter() - t0)
            cache = eng.slots.cache
            idx = torch.tensor(eng.slots.tables[slot], dtype=torch.long, device=cache["k"].device)
            landed = page_checksum(cache["k"].index_select(2, idx), cache["v"].index_select(2, idx),
                                   int(cache["length"][slot]))
            check(landed == ckpt.checksum,
                  f"rid {ckpt.req.rid}: landed pages CRC {landed:#010x} != export {ckpt.checksum:#010x}")
            rec["crc_verified"] = True
            return slot

        eng.export_slot, eng.import_slot = export_slot, import_slot

    for eng in fleet.engines:
        wrap(eng)
    return records


def fleet_workload(n, seed):
    from repro_torch.data import WorkloadSpec, gsm8k_like_workload

    return gsm8k_like_workload(WorkloadSpec(n_requests=n, output_max=128), seed=seed, known_lengths=True)


def run_fleet(torch, model, params):
    """Two replicas of the full-size model on one card over one weight set,
    the paged mixed layout, priced by the paper-prior cost model the other
    serves start from: a clean serve of 32 GSM8K-shaped requests under the
    offline LPT partition, least-load dispatch and work stealing (queued and
    running), then a serve of 8 requests that drains replica 0 mid-decode
    by page-copy (after the same 8 served clean, which times the drain).
    Returns the clean serve's launches and flash's launches by body."""
    from repro_torch.core import CostModel
    from repro_torch.launch.profile_step import SERVE_LEN
    from repro_torch.serving import EngineConfig, FaultPlan, Fleet, FleetConfig, ReplicaFault

    cfg = model.cfg
    gib = lambda b: b / 2**30
    ecfg = EngineConfig(n_slots=8, max_len=SERVE_LEN, kv_layout="paged", mixed_schedule=True)
    fcfg = FleetConfig(n_replicas=2, assign="lpt", dispatch="least_load", work_stealing=True,
                       steal_running=True)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    fleet = Fleet(model, params, ecfg, fcfg, cost_model=CostModel(level_caps=(32, 64, 128, 256)),
                  device=model.device)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    weights = tree_bytes(params)
    pools = sum(tree_bytes(eng.slots.cache) for eng in fleet.engines)
    print(f"  fleet memory: {gib(before):.3f} GiB before Fleet(...) (weights {gib(weights):.3f} GiB), "
          f"{gib(after):.3f} GiB after: +{gib(after - before):.3f} GiB for {fleet.n_replicas} pools of "
          f"{gib(pools / fleet.n_replicas):.3f} GiB", flush=True)
    check(all(eng.params is params for eng in fleet.engines), "fleet: a replica holds its own weights")
    check(abs((after - before) - pools) <= 2**20 * fleet.n_replicas,
          f"fleet: Fleet(...) allocated {after - before} bytes for {pools} bytes of pools")
    check(before >= weights, "fleet: the weights are not on the card")

    fleet.warm_serving_shapes()
    kernels = kernel_modules()
    reqs = fleet_workload(32, 0)
    torch.cuda.reset_peak_memory_stats()
    for mod in kernels.values():
        mod.reset_launch_count()
    t0 = time.perf_counter()
    report = fleet.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: mod.launch_count for name, mod in kernels.items()}
    peak = torch.cuda.max_memory_allocated()

    check_exactly_once("fleet", fleet, report, reqs, cfg.vocab_size)
    running = sum(1 for e in fleet.steal_log if e.get("running"))
    print(f"  fleet serve: {len(reqs)} requests on {fleet.n_replicas} replicas x 8 slots, offline "
          f"{report.offline_solver} partition {[len(p) for p in fleet._offline_result.assignment]}, "
          f"makespan {report.makespan:.4f} s (virtual: replicas in parallel), lower bound "
          f"{report.lower_bound_s:.4f} s (ratio {report.lb_ratio:.4f}), utilization {report.utilization:.6f}, "
          f"{report.generation_speed:.3f} tok/s, wall {wall:.4f} s "
          f"({sum(len(v) for v in fleet.generated.values()) / wall:.3f} tok/s on the one card)", flush=True)
    print(f"  fleet steals: {report.steal_events} queued, {running} running; "
          f"migrations {fleet.migration_events} ({fleet.migrated_pages} pages); per replica: "
          + "; ".join(f"r{i} makespan {t.makespan:.4f} s, {len(t.requests)} requests, {len(t.stages)} stages"
                      for i, t in enumerate(report.traces)))
    print(f"  fleet peak device memory {gib(peak):.3f} GiB against weights + pools "
          f"{gib(weights + pools):.3f} GiB", flush=True)
    by_variant = check_flash_variants("fleet", launches)
    check_launches("fleet", launches, fleet_expect(cfg, report))

    # drain: the same fleet, 8 requests (4 a replica under LPT), so the
    # survivor always has a free slot and pages for each of replica 0's
    # in-flight requests; the drain fires at half replica 0's clean makespan
    drain_reqs = lambda: fleet_workload(8, 1)
    clean = fleet.serve(drain_reqs())
    at_s = 0.5 * clean.traces[0].makespan
    records = watch_page_copies(torch, fleet)
    for mod in kernels.values():
        mod.reset_launch_count()
    reqs = drain_reqs()
    report = fleet.serve(reqs, fault_plan=FaultPlan([ReplicaFault(replica=0, at_s=at_s, kind="drain")]))
    torch.cuda.synchronize()
    drain_launches = {name: mod.launch_count for name, mod in kernels.items()}
    check_exactly_once("drain", fleet, report, reqs, cfg.vocab_size)
    entry = fleet.fault_log[0]
    meta = report.meta
    print(f"  drain at {at_s:.4f} s: {json.dumps(entry)}; meta drained {meta['drained_replicas']}, "
          f"recomputed tokens {meta['recomputed_tokens']}, page-copy {meta['recovered_page_copy']}, "
          f"recompute {meta['recovered_recompute']}", flush=True)
    for rec in records:
        print(f"  page-copy {json.dumps(rec)}")
    check(meta["drained_replicas"] == 1.0 and meta["recomputed_tokens"] == 0.0
          and meta["recovered_recompute"] == 0.0, "drain: a request was dropped or recomputed")
    check(entry["page_copy"] >= 1, "drain: replica 0 held nothing in flight at the drain")
    check(len(records) == fleet.migration_events and all(r.get("crc_verified") for r in records),
          "drain: a page-copy import went unverified")
    check_launches("drain", drain_launches, fleet_expect(cfg, report))
    del fleet
    return launches, by_variant


def run_fleet_parity(torch, np):
    """The float32 smoke Qwen3 fleet on the card (kernels) and on the CPU
    (plain versions) under the scripted clock, so both sides take the same
    decisions: a hard kill of replica 0 (recompute-on-resume), a 2-speed
    fleet (R||Cmax partition, queued and running steals) and a migrate_slot
    at a fixed step. Same offline assignment, streams, steals, migrations
    and fault records on both sides."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import CostModel, Request
    from repro_torch.serving import (
        EngineConfig, FaultPlan, Fleet, FleetConfig, OnlineProfiler, ReplicaFault, ReplicaSpec,
    )

    cfg = dataclasses.replace(get_smoke_config("qwen3_8b"), dtype="float32")
    ecfg = EngineConfig(n_slots=2, max_len=64, kv_layout="paged", page_size=16, prefill_chunk=16)
    cm = CostModel(level_caps=(32, 64, 128))
    step = ScriptedClock.STEP

    def requests():
        return [Request(rid=i, n_prefill=10 + 2 * (i % 3), n_decode=(20 if i % 2 == 0 else 3) + i)
                for i in range(6)]

    def kill(fleet):
        return fleet.serve(requests(), fault_plan=FaultPlan([ReplicaFault(replica=0, at_s=6 * step)]))

    def migrate(fleet):
        fleet.begin_serve(requests())
        for k in range(10**6):
            if k == 8:
                eng = fleet.engines[0]
                slot = eng.slots.active_slots[0]
                check(fleet.migrate_slot(0, slot, 1) == "page_copy", "parity: migrate_slot refused")
            if not fleet.step():
                return fleet.finish_serve()

    cases = (
        ("kill", FleetConfig(n_replicas=2, assign="round_robin", dispatch="round_robin",
                             work_stealing=False), None, kill),
        ("2-speed", FleetConfig(n_replicas=2, assign="lpt", work_stealing=True, steal_running=True),
         [ReplicaSpec(speed_factor=1.0), ReplicaSpec(speed_factor=0.5)], lambda f: f.serve(requests())),
        ("migrate", FleetConfig(n_replicas=2, assign="round_robin", dispatch="round_robin",
                                work_stealing=False), None, migrate),
    )
    (cpu, p_cpu), (card, p_card) = _card_and_cpu(torch, cfg)
    for what, fcfg, specs, run in cases:
        outs = []
        for m, p in ((cpu, p_cpu), (card, p_card)):
            fleet = Fleet(m, p, ecfg, fcfg, cost_model=cm, replica_specs=specs, device=m.device,
                          profiler_factory=lambda: OnlineProfiler(initial=cm, refit_every=10**9))
            with scripted_clock():
                report = run(fleet)
            check_exactly_once(f"{what} fleet ({m.device})", fleet, report, requests(), cfg.vocab_size)
            outs.append(dict(assignment=fleet._offline_result.assignment, generated=fleet.generated,
                             steals=fleet.steal_log, migrations=fleet.migration_log,
                             faults=fleet.fault_log, makespan=report.makespan,
                             lower_bound=report.lower_bound_s, meta=report.meta))
        for key in outs[0]:
            check(outs[0][key] == outs[1][key], f"{what} fleet: {key} differs card vs CPU: "
                  f"{outs[1][key]} != {outs[0][key]}")
        o = outs[1]
        print(f"  smoke fleet [{what}] card == CPU: assignment {o['assignment']}, streams of "
              f"{len(o['generated'])} requests, {len(o['steals'])} steals, {len(o['migrations'])} "
              f"migrations, faults {json.dumps(o['faults'])}, makespan {o['makespan']} (scripted)", flush=True)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


KERNELS = (
    # (row name, launch-count name, path that runs it, source, TPU kernel,
    #  shapes the row's times were taken at)
    ("paged_decode_attention", "paged_decode_attention", "paged",
     "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
     "src/repro/kernels/paged_decode_attention.py:136", "qwen3-8b"),
    ("flash_attention", "flash_attention", "paged",
     "src/repro_torch/kernels/csrc/flash_attention.cu", "src/repro/kernels/flash_attention.py:131",
     "qwen3-8b"),
    ("flash_attention_dense", "flash_attention", "dense",
     "src/repro_torch/kernels/csrc/flash_attention.cu", "src/repro/kernels/flash_attention.py:131",
     "qwen3-8b"),
    ("decode_attention", "decode_attention", "dense",
     "src/repro_torch/kernels/csrc/decode_attention.cu", "src/repro/kernels/decode_attention.py:111",
     "qwen3-8b"),
    ("flash_attention_dense_recurrentgemma", "flash_attention", "recurrentgemma",
     "src/repro_torch/kernels/csrc/flash_attention.cu", "src/repro/kernels/flash_attention.py:131",
     "recurrentgemma-9b"),
    ("decode_attention_recurrentgemma", "decode_attention", "recurrentgemma",
     "src/repro_torch/kernels/csrc/decode_attention.cu", "src/repro/kernels/decode_attention.py:111",
     "recurrentgemma-9b"),
    ("rglru_scan", "rglru_scan", "recurrentgemma",
     "src/repro_torch/kernels/csrc/rglru.cu", "src/repro/kernels/rglru.py:81", "recurrentgemma-9b"),
)


def check_tensor_core_sass(build):
    """The flash library's tensor-core kernels issue HGMMA (wgmma) in their
    SASS, read with cuobjdump from the toolkit that built them."""
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(build.lib_path("flash_attention"))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn and "HGMMA" in line:
            counts[fn] += 1
    tc = {f: n for f, n in counts.items() if "flash_tc_kernel" in f}
    print(f"  flash_attention SASS: HGMMA in {sum(1 for n in tc.values() if n)} of {len(tc)} "
          f"tensor-core variants ({sum(tc.values())} instructions), "
          f"{sum(n for f, n in counts.items() if f not in tc)} in the CUDA-core variants")
    check(bool(tc) and all(tc.values()), f"flash tensor-core variants without HGMMA: {tc}")


def sweep_dense_decode(torch, np, flush):
    """Kernel 3's bf16 body at every split count from 1 to 20, at Qwen3-8B's
    and RecurrentGemma-9B's decode shapes (the latter also with the serve's
    lengths, at most 256 keys of the 640-key ring), each checked against its
    plain version; cold and warm ms by split count."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.decode_split import plan_with_splits
    from repro_torch.launch.profile_step import SERVE_LEN

    out = {}
    for label, (h, kv, d), max_len in (("qwen3-8b", (32, 8, 128), None),
                                       ("recurrentgemma-9b", (16, 1, 256), None),
                                       ("recurrentgemma-9b serve lengths", (16, 1, 256), 256)):
        q, k, v, lengths = dense_decode_case(torch, np, h, kv, d, torch.bfloat16, SERVE_LEN,
                                             max_len=max_len)
        ref = da.decode_attention_plain(q, k, v, lengths)
        p = da.plan(q.dtype, q.shape[0], h, kv, SERVE_LEN, d, n_sms(torch))
        g = h // kv
        rows = out[label] = {"plan": [da.BODIES[p.body], p.split.splits]}
        for n in range(1, 21):
            plan = da.Plan(p.body, plan_with_splits(n, SERVE_LEN, h // kv, 1))
            call = lambda: da._launch(q, k, v, lengths, d ** -0.5, plan)
            err = max_err(torch, call(), ref, KERNEL_TOL["bfloat16"])
            row = dict(body=da.BODIES[p.body], splits=n, split_keys=plan.split.split_keys,
                       ctas=n * q.shape[0] * kv, max_abs_err=err,
                       cold_ms=time_ms(torch, call, flush), warm_ms=time_warm_ms(torch, call))
            rows[f"{da.BODIES[p.body]} {n}"] = row
            print(f"  decode_attention [{label}] {json.dumps(row)}"
                  + (" (the plan)" if n == p.split.splits else ""), flush=True)
    return out


def sweep_dense_decode_in_place(torch, np):
    """Kernel 3's device time inside the models' decode, under its plan and
    under other split counts: Qwen3-8B cut to 8 layers (fused decode, K = 8
    steps) and RecurrentGemma-9B cut to 6 layers (2 attention layers, 8
    decode steps), 8 slots holding 128, 240, 336 or 496 tokens before the
    steps, random bf16 weights; the median per launch of torch.profiler's
    device events. Each plan is forced by replacing ``decode_attention.plan``
    for the measured call only."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.decode_split import plan_with_splits
    from repro_torch.launch.profile_step import SERVE_LEN
    from repro_torch.models.recurrentgemma import RecurrentGemma
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving.sampler import greedy

    j, steps = 8, 8
    rng = np.random.default_rng(1)
    tok = lambda x: torch.from_numpy(np.asarray(x, np.int32)).cuda()
    z = torch.zeros(j, dtype=torch.int32, device="cuda")
    on = torch.ones(j, dtype=torch.bool, device="cuda")
    big = torch.full((j,), 10**6, dtype=torch.int32, device="cuda")
    cases = (
        ("qwen3-8b", TransformerLM, get_config("qwen3_8b"), 8, 4, (1, 2, 3, 4, 5, 10)),
        ("recurrentgemma-9b", RecurrentGemma, get_config("recurrentgemma_9b"), 6, 16, (1, 2, 5, 10, 20)),
    )
    out, plan = [], da.plan
    for label, cls, cfg, layers, g, plans in cases:
        model = cls(dataclasses.replace(cfg, n_layers=layers), device="cuda")
        params = model.init_params(seed=0)
        if label == "qwen3-8b":
            run = lambda cache: model.decode_steps(params, z, cache, num_steps=steps, sampler=greedy,
                                                   active=on, budgets=big, rids=z, token_idx0=z)
        else:
            def run(cache):
                for _ in range(steps):
                    _, cache = model.decode_step(params, z, cache)
        for ctx in (128, 240, 336, 496):
            for n in (None,) + plans:
                if n is not None:
                    forced = da.Plan(da.TENSOR_CORES, plan_with_splits(n, SERVE_LEN, g, 1))
                cache = model.cache_init(j, SERVE_LEN)
                model.prefill(params, tok(rng.integers(1, cfg.vocab_size, size=(j, ctx))), cache)
                try:
                    if n is not None:
                        da.plan = lambda *args, _p=forced: _p
                    run(cache)                 # warm-up; the cache grows by `steps` tokens
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                        run(cache)
                        torch.cuda.synchronize()
                finally:
                    da.plan = plan
                us = [e.time_range.elapsed_us() for e in prof.events()
                      if e.device_type.name == "CUDA" and "dense_decode" in e.name]
                row = dict(model=label, tokens=f"{ctx + steps + 1}-{ctx + 2 * steps}",
                           plan="the plan" if n is None else f"{da.BODIES[da.TENSOR_CORES]} {n}",
                           launches=len(us), us_median=statistics.median(us))
                out.append(row)
                print(f"  in place {json.dumps(row)}", flush=True)
                del cache
        del model, params
        torch.cuda.empty_cache()
    return out


def run_sweep(torch, np):
    """Paged decode attention at every split count, kernel 3 by split count
    at both of its serving shapes (cold, warm and inside the models'
    decode), and kernels 1-3 under each L2 state; returns the times."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.launch.profile_step import SERVE_LEN, dense_prefill_len

    h, kv, d = 32, 8, 128
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    q, k, v, tables, lengths = decode_case(torch, np, h, kv, d)
    b, mb, bs = q.shape[0], tables.shape[1], k.shape[2]
    scale = d ** -0.5
    plan = pda.decode_plan(b, h, kv, mb, bs, n_sms(torch))
    ref = pda.paged_decode_attention_plain(q, k, v, tables, lengths)
    splits = {}
    for n in range(1, 21):
        p = pda.plan_with_splits(n, mb * bs, plan.group, plan.parts)
        call = lambda: pda._launch(q, k, v, tables, lengths, scale, p)
        err = max_err(torch, call(), ref, KERNEL_TOL["bfloat16"])
        splits[n] = dict(split_keys=p.split_keys, ctas=n * b * kv * p.parts, max_abs_err=err,
                         cold_ms=time_ms(torch, call, flush), warm_ms=time_warm_ms(torch, call))
        print(f"  paged_decode_attention splits={n}: {json.dumps(splits[n])}"
              + (" (the plan)" if n == plan.splits else ""), flush=True)
    dense = sweep_dense_decode(torch, np, flush)
    in_place = sweep_dense_decode_in_place(torch, np)

    dq, dk, dv, dlen = dense_decode_case(torch, np, h, kv, d, torch.bfloat16, SERVE_LEN)
    mq, mk, mv, mlen = dense_decode_case(torch, np, 16, 1, 256, torch.bfloat16, SERVE_LEN)
    cq, ck, cv, ctab, cst, cval, _ = chunk_case(torch, np, h, kv, d)
    fq, fk, fv = dense_prefill_case(torch, h, kv, d, 8, dense_prefill_len())
    one = torch.zeros(1, device="cuda")
    calls = {
        "paged_decode_attention": lambda: pda.paged_decode_attention(q, k, v, tables, lengths),
        "flash_attention": lambda: fa.paged_chunk_attention(cq, ck, cv, ctab, cst, cval),
        "flash_attention_dense": lambda: fa.flash_attention(fq, fk, fv, causal=True),
        "decode_attention": lambda: da.decode_attention(dq, dk, dv, dlen),
        "decode_attention_recurrentgemma": lambda: da.decode_attention(mq, mk, mv, mlen),
        "add_": lambda: one.add_(1.0),
    }
    l2 = {}
    for name, call in calls.items():
        l2[name] = dict(cold_ms=time_ms(torch, call, flush), warm_ms=time_warm_ms(torch, call),
                        host_paced_ms=time_host_paced_ms(torch, call))
        print(f"  {name}: {json.dumps(l2[name])}", flush=True)
    return {"plan_splits": plan.splits, "paged_decode_attention_by_splits": splits,
            "decode_attention_by_body_and_splits": dense, "decode_attention_in_place": in_place,
            "l2_states": l2}


def main() -> int:
    sweep = sys.argv[1:] == ["--sweep"]
    if sys.argv[1:] and not sweep:
        print("usage: chip_smoke.py [--sweep]", file=sys.stderr)
        return 2
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
    for src in ("flash_attention", "paged_decode_attention", "decode_attention"):
        for fn, info in build.ptxas_kernels(src).items():
            print(f"    {fn}: {info}")
    check_tensor_core_sass(build)
    phase("build", t0)

    if sweep:
        t0 = time.perf_counter()
        res = run_sweep(torch, np)
        phase("sweep", t0)
        print(json.dumps({"sweep": res, "device": smi}))
        return 0

    t0 = time.perf_counter()
    kres = run_kernel_checks(torch, np)
    phase("kernels", t0)

    t0 = time.perf_counter()
    run_parity(torch, np)
    run_fleet_parity(torch, np)
    phase("parity", t0)

    t0 = time.perf_counter()
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import TransformerLM

    model = TransformerLM(get_config("qwen3_8b"), device="cuda")
    params = model.init_params(seed=0)
    torch.cuda.synchronize()
    cfg = model.cfg
    print(f"  model {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{sum(x.numel() for x in _leaves(params)) / 1e9:.3f} B parameters ({cfg.dtype}), "
          f"init {time.perf_counter() - t0:.2f} s", flush=True)
    launches, by_variant = {}, {}
    for layout in ("paged", "dense"):
        eng, launches[layout], by_variant[layout] = run_serve(torch, model, params, layout)
        del eng                       # free this layout's KV before the next one
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    launches["fleet"], by_variant["fleet"] = run_fleet(torch, model, params)
    torch.cuda.empty_cache()
    phase("fleet", t1)
    del model, params                 # free Qwen3-8B before RecurrentGemma-9B loads
    torch.cuda.empty_cache()

    from repro_torch.models.recurrentgemma import RecurrentGemma

    t1 = time.perf_counter()
    model = RecurrentGemma(get_config("recurrentgemma_9b"), device="cuda")
    params = model.init_params(seed=0)
    torch.cuda.synchronize()
    cfg = model.cfg
    print(f"  model {cfg.name}: {cfg.n_layers} layers ({model.n_rec} recurrent, "
          f"{model.n_periods} attention), d_model {cfg.d_model}, "
          f"{sum(x.numel() for x in _leaves(params)) / 1e9:.3f} B parameters ({cfg.dtype}), "
          f"init {time.perf_counter() - t1:.2f} s", flush=True)
    launches["recurrentgemma"], by_variant["recurrentgemma"] = run_recurrentgemma_serve(
        torch, model, params)
    del model, params
    torch.cuda.empty_cache()
    phase("serve", t0)

    kernels = []
    for kname, count, layout, source, replaces, label in KERNELS:
        r = kres[(kname.replace("_recurrentgemma", ""), label)]
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[layout][count],
            "launches_by_path": {lay: launches[lay][count] for lay in launches},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **({"launches_by_variant": by_variant[layout],
                "ms_by_tile": r.get("ms_by_tile")} if count == "flash_attention" else {}),
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
