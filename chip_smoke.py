#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py            # the smoke run below
    python3 chip_smoke.py --sweep    # kernel plans and L2 states, timed
    python3 chip_smoke.py --train    # the training path's kernels and phase train alone

Phases, each printing its seconds on a line of its own:

1. device  — find the CUDA device (exit non-zero without one) and print its
             name and power limit as nvidia-smi reports them;
2. build   — compile the hand-written kernels from src/repro_torch/kernels/csrc
             with nvcc for sm_90a (one nvcc per source, all at once), print
             each variant's registers and spills for kernels 1, 2 and 3, and
             check that flash's tensor-core variants issue HGMMA (cuobjdump);
             that the flash backward's wgmma kernels issue HGMMA, and none
             of its other kernels does, and that they use no stack and no
             local memory (cuobjdump -res-usage; 0 spill bytes in ptxas's
             report where the process built them), each printed;
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
             bits; then kernels 1, 2 (both entries) and 3 (bf16 and float32)
             at the other decoders' (H, KV) at head_dim 128 — (64, 64),
             (36, 4), (48, 8), (28, 4), (16, 16) — timed at LLaMA-65B's and
             StarCoder2-7B's; and the training path's kernels: kernel 2's
             forward with its log-sum-exp and the backward kernel
             (flash_attention_bwd.cu) at Qwen3-8B's attention (S 2048, 32/8
             heads, head_dim 128, bf16, causal) at B 2 and at the train
             step's B 1, a window of 256, LLaMA-65B's 64/64 heads and
             float32 at the smoke shape, against the plain versions: one
             device kernel a forward, and a backward runs exactly the
             device kernels of backward_plan, in order (each pass's device
             µs printed), two calls bit-equal, and the other dK/dV grid
             (the GQA group split over CTAs, or not) checked and timed
             beside the plan's; at both Qwen3 batches the backward timed
             beside its bound, the design's floor, its plain version, our
             forward + backward, and SDPA under each backend that takes
             the inputs (forward, forward + backward, backward alone; the
             fastest backward alone is the library time), and kernel 2's
             forward with its log-sum-exp beside its bound, its plain
             version and SDPA's fastest forward;
4. parity  — float32 smoke models on the card (kernels) against the same
             models on the CPU (plain versions): the paged path (chunked
             prefill, decode, fused decode) and the dense path (whole-prompt
             prefill, fused decode) of the smoke Qwen3, the dense path of a
             sliding-window config whose ring wraps, and the smoke
             RecurrentGemma (ragged prefill, then decode steps that wrap its
             window-8 ring); logits within 1e-4, identical greedy tokens;
             the smoke Granite, LLaMA-65B, StarCoder2 (head widened to
             16, which the kernels take), Nemotron, OLMoE, Mixtral (window
             8, the ring wraps) and Qwen2-VL (prefill with patch
             embeddings), every weight perturbed off its init, on the dense
             path and (all but Mixtral) the paged path;
             three smoke Qwen3 fleets under a scripted clock (a hard kill, a
             2-speed fleet with stealing, a migrate_slot), with the same
             assignment, streams, steals, migrations and faults; and top-p
             sampling: threefry keys and bits at Qwen3-8B's (8, 151936)
             equal to the CPU's bit for bit, the same categorical and top-p
             draws, and the smoke Qwen3 served under TopPSampler(top_p=0.9)
             with an Observation and the scripted clock on the paged and
             the dense layout with the same streams, span kinds and
             Observation state;
5. serve   — full-size Qwen3-8B (36 layers, bf16, random weights from a seed)
             behind the port's Engine, twice on the same weights and the same
             16 GSM8K-shaped requests (outputs capped at 128) under hybrid
             scheduling: the paged layout with mixed steps, then the dense
             layout with whole-prompt prefill stages and fused decode; checks
             the trace, the budgets, the token ids and that each kernel ran
             exactly as often as each schedule implies, every flash launch
             on the tensor-core body, and that these greedy serves, run with
             observe=None, made no obs callback (Observation.tripwire). Then
             the paged serve again under TopPSampler(top_p=0.9) with an
             Observation: the same gates, capacity conserved, one
             first_token and one complete span a request, a Perfetto trace
             that parses; its tok/s beside the greedy paged serve's. Then
             the fleet on the same weights: two
             replicas of 8 slots (paged, mixed) over one weight set (the
             memory Fleet(...) adds must be the two pools), 32 GSM8K-shaped
             requests under the offline LPT partition, least-load dispatch
             and queued and running work stealing, every request exactly
             once, the makespan printed beside its lower bound (the paper
             prior's flat-pool bound, a model number: not a gate), launches exact
             summed over the replicas; then 8 requests
             with replica 0 drained mid-decode by page-copy on a second
             fleet that records into one Observation (zero drops, zero
             recomputed tokens, each import's landed pages holding the
             export's CRC32, each moved request's spans running migrate_out,
             migrate_in on the other replica, complete; capacity conserved),
             page-copy times printed. Then, Qwen3 freed,
             full-size RecurrentGemma-9B (38 layers, bf16, random weights)
             on the same 16 requests in two waves of 8 slots through its own
             prefill and decode_step (launch.generate; the Engine does not
             take it); checks the budgets, the token ids and that the scan
             ran in each of the 26 recurrent layers and kernels 2 and 3 in
             each of the 12 attention layers of every prefill and step;
6. family  — the other decoders the reference's Engine serves, at their
             published widths (random bf16 weights from seed 0):
             Granite-3-8B, StarCoder2-7B, Nemotron-4-15B, Qwen2-VL-7B and
             OLMoE-1B-7B whole, LLaMA-65B cut to 32 of 80 layers and
             Mixtral-8x22B to 12 of 56 (each cut printed), one at a time,
             each freed before the next: 8 GSM8K-shaped requests (outputs
             capped at 64) through the serve phase's gates on the dense
             layout, and on the paged mixed one for LLaMA, StarCoder2 and
             OLMoE; each serve's tok/s, utilization, makespan, decode
             rounds, ms a decode round beside the weight-read floor, peak
             memory; then one fused decode stage under the profiler, whose
             device busy share says whether the device or the host paces
             it;
7. train   — the training path (repro_torch.train, its kernels checked
             in phase kernels): the float32 smoke Qwen3, OLMoE, Qwen2-VL and Mixtral, card
             against CPU: loss and every gradient leaf, one AdamW step on
             identical gradients, three train() steps (two microbatches,
             remat) from one step-0 checkpoint, flash launches exact; the
             smoke Qwen3 trained 60 steps on the card (loss drops >= 0.3)
             and 9 steps against 6 + save + resume for 3; then Qwen3-8B at
             its published widths cut to 12 of 36 layers (AdamW's float32
             moments must fit in 80 GB), bf16, batch 2 x 2048, two
             microbatches, remat, 8 steps of train(): losses finite,
             grad_norm > 0, count 8, parameters changed, launches exact;
             step ms, tokens/s, model-FLOPs utilisation, peak memory and
             the device busy share of one profiled step with its device ms
             by kind (GEMM, flash forward, flash backward, the rest),
             beside the card.

Then one JSON line of the train phase's numbers, one JSON line naming every
ported kernel (kernel 2 once per entry, and kernels 2 and 3 again at
RecurrentGemma's shapes, kernels 1-3 again at LLaMA-65B's and
StarCoder2-7B's, the flash backward and kernel 2's dense entry at the
training shape) with its launches on each path (flash's also by device
body) and this run's times, and, last,
{"ok": true, "device": {...}}.
Any failed check raises, so the script exits non-zero and prints no result.

``--train`` builds the kernels and runs the training path's kernel checks
and phase 7 (train) alone, printing their numbers as one JSON line.

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
import gc
import json
import re
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
# float32 smoke training, card vs CPU: each gradient leaf within this much of
# the leaf's largest magnitude. Without qk-norm the smoke configs' gradients
# are ill-conditioned enough that the reference and the port's CPU path
# themselves disagree by up to 1e-4 on these inputs
# (tests/test_torch_train.py::test_float32_disagreement_on_the_card_checks_inputs).
TRAIN_GRAD_TOL = 5e-4
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


def device_kernel_us(torch, fn, attempts=3):
    """(name, device µs) of each device kernel one call of ``fn`` runs, in
    the order they started (torch.profiler). A trace that holds no device
    event at all missed the call (on the card a process's later traces now
    and then come back empty), so the call is traced again, up to
    ``attempts`` times; every retry is printed."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type.name == "CUDA"]
        if events:
            break
        print(f"  device_kernels: trace {attempt} of {attempts} held no device event", flush=True)
    events.sort(key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.elapsed_us()) for e in events
            if "emcpy" not in e.name and "emset" not in e.name]


def device_kernels(torch, fn, attempts=3):
    """Names of the device kernels one call of ``fn`` runs, in order."""
    return [name for name, _ in device_kernel_us(torch, fn, attempts)]


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


# The other decoders' attention shapes at head_dim 128, by (H, KV): kernels
# 1-3 are held against their plain versions at each, and timed at LLaMA-65B's
# MHA and StarCoder2-7B's g = 9.
FAMILY_GROUPS = (
    ("llama-65b", (64, 64)),                      # g = 1 (MHA)
    ("starcoder2-7b", (36, 4)),                   # g = 9
    ("nemotron-4-15b, mixtral-8x22b", (48, 8)),   # g = 6
    ("qwen2-vl-7b", (28, 4)),                     # g = 7
    ("olmoe-1b-7b", (16, 16)),                    # g = 1
)
TIMED_FAMILY = ("llama-65b", "starcoder2-7b")


def check_attention_kernels(torch, np, F, flush, label, h, kv, d, timed=True):
    """Kernel 3 (bf16 and float32, the strided cache view, ragged lengths
    with an idle lane), kernel 2's dense entry (at the dense prefill's shape,
    then under windows and without the causal mask) and paged-chunk entry,
    and kernel 1, at (h, kv, d) against their plain versions, with one device
    kernel a call and equal bits on a second call for kernels 1 and 3.
    Where ``timed``, each is timed with its plain version and one SDPA call
    on the same inputs, beside its bound (and flash's tensor-core tiles at
    head_dim >= 64). Returns the timed results by (kernel, label)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.launch.profile_step import SERVE_LEN, dense_prefill_len
    from repro_torch.models.cache import paged_key_positions

    results = {}
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
    if timed:
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
    print(f"  flash_attention dense [{label}] at the dense prefill's shape: max_abs_err={err:.4g}")
    if timed:
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
    kname = check_one_kernel_and_repeat(
        torch, "paged_decode_attention", lambda: pda.paged_decode_attention(q, k, v, tables, lengths), out)
    plan = pda.decode_plan(q.shape[0], h, kv, tables.shape[1], k.shape[2], n_sms(torch))
    print(f"  paged_decode_attention [{label}] {plan}: max_abs_err={err:.4g}, one call, one device "
          f"kernel ({kname[:60]}), two calls equal")
    if timed:
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
    err = max_err(torch, out, ref, KERNEL_TOL["bfloat16"])
    check(bool((out[-1] == 0).all()), "pad chunk row is not zero")
    print(f"  flash_attention paged chunk [{label}]: max_abs_err={err:.4g}")
    if timed:
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
    return results


def run_kernel_checks(torch, np):
    import torch.nn.functional as F

    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    results = {}
    for label, (h, kv, d) in (("qwen3-8b", (32, 8, 128)), ("smoke", (4, 2, 16))):
        results.update(check_attention_kernels(torch, np, F, flush, label, h, kv, d))
    for label, (h, kv) in FAMILY_GROUPS:
        results.update(check_attention_kernels(torch, np, F, flush, label, h, kv, 128,
                                               timed=label in TIMED_FAMILY))
    results.update(run_recurrentgemma_kernel_checks(torch, np, F, flush))
    for key, row in run_train_kernel_checks(torch, np, F).items():
        results[(key, "qwen3-8b train")] = row
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
def _card_and_cpu(torch, cfg, perturb=False):
    """The same float32 model and weights on the CPU and on the card; with
    ``perturb``, every leaf plus seeded noise (0.1 x its spread, 0.1 for a
    constant leaf), so zero biases and unit scales leave their init."""
    from repro_torch.models.layers import tree_map
    from repro_torch.models.transformer import TransformerLM

    cpu = TransformerLM(cfg, device="cpu")
    params_cpu = cpu.init_params(seed=0)
    if perturb:
        gen = torch.Generator().manual_seed(1)

        def bump(x):
            spread = float(x.float().std()) if x.numel() > 1 else 0.0
            noise = torch.randn(x.shape, generator=gen)
            return (x.float() + 0.1 * (spread or 1.0) * noise).to(x.dtype)

        params_cpu = tree_map(bump, params_cpu)
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


def run_dense_parity(torch, np, cfg, what, k_steps=8, models=None):
    """Whole-prompt prefill of ragged prompts into the dense slot cache (a
    VLM config's prefix replaced by seeded ``patch_embeds``), one decode
    step, then a fused horizon of ``k_steps``."""
    from repro_torch.serving.sampler import greedy

    n, s, max_len = 4, 32, 64
    lengths = np.array([30, 17, 5, 24], np.int32)
    rng = np.random.default_rng(1)
    tokens = rng.integers(1, cfg.vocab_size, size=(n, s)).astype(np.int32)
    tokens[np.arange(s)[None, :] >= lengths[:, None]] = 0
    patches = (rng.standard_normal((n, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
               if cfg.num_patch_tokens else None)
    outs = []
    for m, p in models or _card_and_cpu(torch, cfg):
        dev = m.device
        t = lambda x: torch.from_numpy(x).to(dev)
        cache = m.cache_init(n, max_len)
        logits, cache = m.prefill(p, t(tokens), cache, None if patches is None else t(patches),
                                  lengths=t(lengths))
        dec, cache = m.decode_step(p, greedy(logits), cache)
        on = torch.ones(n, dtype=torch.bool, device=dev)
        block = m.decode_steps(p, greedy(dec), cache, num_steps=k_steps, sampler=greedy, active=on,
                               budgets=t(np.full(n, k_steps, np.int32)),
                               rids=t(np.arange(n, dtype=np.int32)), token_idx0=t(np.ones(n, np.int32)))[0]
        outs.append((logits.cpu(), dec.cpu(), block.cpu()))
    _compare(torch, outs, what)


def run_paged_parity(torch, np, cfg, what, models=None):
    """Chunked prefill of ragged prompts (and a pad row) into the paged pool,
    one decode step with an idle lane, then a fused horizon of 4."""
    from repro_torch.serving.sampler import greedy

    models = models or _card_and_cpu(torch, cfg)
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
    _compare(torch, outs, what)


# The other decoders' smoke configs on the card against the CPU. StarCoder2's
# smoke config has head_dim 12, for which no kernel has a variant, so its
# card check widens the head to 16 (d_model, heads, biases, layernorm and GELU
# as in the smoke config). Mixtral's window of 8 wraps its ring.
FAMILY_PARITY = ("granite_3_8b", "llama_65b", "starcoder2_7b", "nemotron_4_15b",
                 "olmoe_1b_7b", "mixtral_8x22b", "qwen2_vl_7b")


def run_family_parity(torch, np):
    """Each other decoder's float32 smoke config, every weight perturbed off
    its init: the dense path (a VLM's prefill with patch embeddings) and,
    where the reference has it, the paged path, card against CPU."""
    from repro_torch.configs import get_smoke_config

    for arch in FAMILY_PARITY:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        if cfg.resolved_head_dim == 12:
            cfg = dataclasses.replace(cfg, head_dim=16)
        models = _card_and_cpu(torch, cfg, perturb=True)
        run_dense_parity(torch, np, cfg, f"smoke {arch} dense", models=models)
        if cfg.sliding_window == 0:
            run_paged_parity(torch, np, cfg, f"smoke {arch} paged", models=models)


def run_parity(torch, np):
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ArchConfig

    cfg = dataclasses.replace(get_smoke_config("qwen3_8b"), dtype="float32")
    models = _card_and_cpu(torch, cfg)
    run_paged_parity(torch, np, cfg, "smoke paged", models=models)
    run_dense_parity(torch, np, cfg, "smoke dense", models=models)
    # tests/test_fused_decode.py:126: W = 24, so prompts of 30 and 24 tokens
    # and the decode steps after them wrap the ring
    swa = ArchConfig(name="swa", family="dense", n_layers=2, d_model=64, n_heads=4,
                     n_kv_heads=2, d_ff=128, vocab_size=256, sliding_window=24,
                     dtype="float32")
    run_dense_parity(torch, np, swa, "sliding-window ring")
    run_family_parity(torch, np)
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
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import rglru

    return {"paged_decode_attention": pda, "flash_attention": fa, "decode_attention": da,
            "rglru_scan": rglru, "flash_attention_backward": fb}


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
    """Every kernel launched exactly as often as the path implies (a kernel
    that ``expect`` does not name, as the training backward on a serving
    path, exactly 0 times), and each kernel of the path at least once."""
    print(f"  {path} launches: {json.dumps(launches)} (expected {json.dumps(expect)})", flush=True)
    for name, n in launches.items():
        want = expect.get(name, 0)
        check(n == want, f"{path}: {name}: {n} launches, the path implies {want}")
        if want:
            check(n > 0, f"{path}: {name} was never launched on its path")


def run_serve(torch, model, params, layout, sampler=None, obs=None, reqs=None, path=None):
    """Serve the GSM8K-shaped closed-loop workload (``reqs``, by default the
    16 requests of ``profile_step.serve_workload``) through the port's Engine
    under hybrid scheduling as launch/serve.py sets it up, on the paged
    layout (mixed steps) or the dense layout (whole-prompt prefill stages),
    greedy or under ``sampler`` (seed 0), recording into ``obs`` when one
    is given, and check the result. Returns (engine, launches per kernel,
    flash's launches by body, serve stats: tok/s, wall seconds, decode
    rounds and the wall ms a decode round)."""
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
    from repro_torch.serving.sampler import greedy

    cfg = model.cfg
    path = path or (layout if sampler is None else "top_p")
    reqs = reqs or serve_workload()
    cm = CostModel(level_caps=(32, 64, 128, 256))
    asn = solve_offline(reqs, 8, cm).assignment
    clients = build_clients(8, reqs, asn)
    if layout == "paged":
        ecfg = EngineConfig(n_slots=8, max_len=SERVE_LEN, kv_layout="paged", mixed_schedule=True,
                            sample_seed=0, observe=obs)
    else:
        ecfg = EngineConfig(n_slots=8, max_len=SERVE_LEN, kv_layout="dense",
                            prefill_seq_buckets=DENSE_BUCKETS, sample_seed=0, observe=obs)
    eng = Engine(model, params, ecfg, sampler=sampler or greedy, device="cuda")
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
        check(len(got) == r.n_decode, f"{path}: request {r.rid} emitted {len(got)} of {r.n_decode}")
        check(all(0 <= t < cfg.vocab_size for t in got), f"{path}: request {r.rid}: invalid token id")
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
    by_variant = check_flash_variants(path, launches)
    s = trace.summary()
    stall = trace.meta["prefill_stall_time_s"]
    print(f"  {path} serve ({layout}): {len(reqs)} requests, {sum(len(v) for v in eng.generated.values())} "
          f"output tokens, utilization {s['utilization']}, makespan {s['makespan_s']} s, "
          f"{s['generation_speed_tok_s']} tok/s, wall {wall:.4f} s", flush=True)
    print(f"  {path} stages: {prefills} prefill stages ({'chunk rounds' if layout == 'paged' else 'whole prompts'}), "
          f"{mixed} mixed rounds, {kinds.count(StageKind.DECODE)} fused decode stages "
          f"({decode_rounds} rounds), decode dispatches {trace.meta['decode_dispatches']}, "
          f"prefill stall {stall} s")
    print(f"  {path} peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check_launches(path, launches, expect)
    if layout == "dense" and len(reqs) > ecfg.n_slots:
        check(stall > 0, "dense: no prefill stage ran while decoders were active")
    decode_s = sum(st.t_end - st.t_start for st in trace.stages if st.kind is StageKind.DECODE)
    return eng, launches, by_variant, dict(
        tok_s=s["generation_speed_tok_s"], wall=wall, utilization=s["utilization"],
        makespan=s["makespan_s"], decode_rounds=decode_rounds, mixed_rounds=mixed,
        ms_per_decode_round=1e3 * decode_s / max(decode_rounds, 1),
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def run_top_p_serve(torch, model, params, greedy_stats):
    """The paged serve of ``run_serve`` under TopPSampler(top_p=0.9,
    temperature=1.0) with an Observation: run_serve's gates, then capacity
    conserved, one first_token and one complete span per request, and a
    Perfetto trace that parses. Prints tok/s, the wall and the count of obs
    records beside the greedy paged serve's of this run."""
    import tempfile

    from repro_torch.obs import Observation, check_capacity_conservation, write_trace
    from repro_torch.serving.sampler import TopPSampler

    obs = Observation()
    eng, launches, by_variant, stats = run_serve(
        torch, model, params, "paged", sampler=TopPSampler(top_p=0.9, temperature=1.0), obs=obs)
    check(check_capacity_conservation(obs), "top_p: capacity not conserved")
    for rid in eng.generated:
        kinds = [e.kind for e in obs.spans.by_request(rid)]
        check(kinds.count("first_token") == 1 and kinds.count("complete") == 1 and kinds[-1] == "complete",
              f"top_p: request {rid} spans {kinds}")
    with tempfile.TemporaryDirectory() as tmp:
        with open(write_trace(obs, str(Path(tmp) / "top_p.trace.json"))) as fh:
            events = json.load(fh)["traceEvents"]
    check(len(events) > 0, "top_p: empty Perfetto trace")
    print(f"  top_p serve: {stats['tok_s']} tok/s, wall {stats['wall']:.4f} s; greedy paged serve of "
          f"this run {greedy_stats['tok_s']} tok/s, wall {greedy_stats['wall']:.4f} s "
          f"(top_p / greedy tok/s {stats['tok_s'] / greedy_stats['tok_s']:.4f}); obs records: "
          f"{len(obs.spans.events)} spans, {len(obs.audit.records)} audit, "
          f"{len(obs.capacity_samples)} capacity samples, {len(events)} trace events", flush=True)
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
# The other decoders at full width                                            #
# --------------------------------------------------------------------------- #
# (arch, layers kept — None keeps them all —, also served paged with mixed
# steps). Every width is the published one; LLaMA-65B (121.6 GiB in bf16) and
# Mixtral-8x22B (262 GiB) are cut to depth only, to fit one 80 GB card with
# about 10 GiB to spare. Paged: LLaMA's MHA, StarCoder2's g = 9 with biases
# and OLMoE's experts in mixed rounds; the reference refuses Mixtral's window
# on the paged layout.
FAMILY_SERVES = (
    ("granite_3_8b", None, False),
    ("starcoder2_7b", None, True),
    ("nemotron_4_15b", None, False),
    ("qwen2_vl_7b", None, False),
    ("olmoe_1b_7b", None, True),
    ("llama_65b", 32, True),
    ("mixtral_8x22b", 12, False),
)


def family_workload():
    """8 GSM8K-shaped requests, outputs capped at 64, seed 0."""
    from repro_torch.data import WorkloadSpec, gsm8k_like_workload

    return gsm8k_like_workload(WorkloadSpec(n_requests=8, output_max=64), seed=0, known_lengths=True)


def weight_read_floor_ms(params, cfg):
    """The least time a decode round can take: the weights the round reads,
    each once, at the card's memory rate — every weight but the embedding
    table (a round gathers only its tokens' rows of it, unless it is tied to
    the unembedding); an MoE layer reads every expert, since the capacity
    buffers run each expert each round."""
    nbytes = tree_bytes(params)
    if not cfg.tie_embeddings:
        nbytes -= tree_bytes({"e": params["embed"]["embedding"]})
    return 1e3 * nbytes / HBM_BYTES_PER_S


def decode_stage_profile(torch, model, params):
    """One fused decode stage (K = 8) of 8 slots on the dense layout after a
    prefill of 8 prompts at the serve's largest bucket, under torch.profiler
    (``profile_step._measure``): wall, device time, busy share, kernels."""
    from repro_torch.launch.profile_step import SERVE_LEN, _measure, dense_prefill_len
    from repro_torch.serving.sampler import greedy

    j = 8
    cache = model.cache_init(j, SERVE_LEN)
    g = torch.Generator(device="cuda").manual_seed(0)
    prompts = torch.randint(1, model.cfg.vocab_size, (j, dense_prefill_len()), generator=g,
                            device="cuda").int()
    model.prefill(params, prompts, cache)
    z = torch.zeros(j, dtype=torch.int32, device="cuda")
    on = torch.ones(j, dtype=torch.bool, device="cuda")
    big = torch.full((j,), 10**6, dtype=torch.int32, device="cuda")
    return _measure("dense fused decode, K = 8", lambda: model.decode_steps(
        params, z, cache, num_steps=8, sampler=greedy, active=on, budgets=big, rids=z,
        token_idx0=z), iters=1)


def run_family_serves(torch):
    """Each of FAMILY_SERVES at full width (random bf16 weights, seed 0):
    the 8 requests of ``family_workload`` through ``run_serve``'s gates on the
    dense layout and, where marked, the paged mixed one; then one fused
    decode stage under the profiler, whose device busy share says whether
    the device or the host paces a decode round. Each model is freed before
    the next loads. Returns launches and flash's launches by body, by path."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import TransformerLM

    launches, by_variant = {}, {}
    reqs = family_workload()
    for arch, keep, paged in FAMILY_SERVES:
        # what earlier phases left in reference cycles (an engine and its
        # slot manager hold each other) goes before the next model loads
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated() / 2**30
        t0 = time.perf_counter()
        full = get_config(arch)
        cfg = full if keep is None else dataclasses.replace(full, n_layers=keep)
        model = TransformerLM(cfg, device="cuda")
        params = model.init_params(seed=0)
        torch.cuda.synchronize()
        floor = weight_read_floor_ms(params, cfg)
        print(f"  model {cfg.name}: {cfg.n_layers} layers kept of {full.n_layers}, d_model {cfg.d_model}, "
              f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {model.hd}, "
              f"{f'{cfg.n_experts} experts top-{cfg.experts_per_token}, ' if cfg.is_moe else ''}"
              f"{sum(x.numel() for x in _leaves(params)) / 1e9:.3f} B parameters, "
              f"{tree_bytes(params) / 2**30:.3f} GiB ({cfg.dtype}), init {time.perf_counter() - t0:.2f} s "
              f"({held:.3f} GiB allocated before it loaded); weight-read floor of a decode round "
              f"{floor:.3f} ms", flush=True)
        for layout in ("dense", "paged") if paged else ("dense",):
            path = f"{arch} {layout}"
            eng, launches[path], by_variant[path], st = run_serve(
                torch, model, params, layout, reqs=reqs, path=path)
            del eng
            gc.collect()
            torch.cuda.empty_cache()
            print(f"  {path}: {st['tok_s']} tok/s, wall {st['wall']:.4f} s, utilization "
                  f"{st['utilization']}, makespan {st['makespan']} s, {st['decode_rounds']} decode "
                  f"rounds, {st['mixed_rounds']} mixed rounds, {st['ms_per_decode_round']:.3f} ms a "
                  f"decode round against the weight-read floor {floor:.3f} ms "
                  f"({st['ms_per_decode_round'] / floor:.2f}x), peak {st['peak_gib']:.3f} GiB", flush=True)
        prof = decode_stage_profile(torch, model, params)
        busy = prof["device_busy_share"]
        print(f"  {cfg.name} fused decode stage (8 slots, K = 8, dense): wall {prof['traced_wall_ms']:.3f} ms, "
              f"device {prof['device_ms']:.3f} ms ({prof['device_ms'] / 8:.3f} ms a step against the floor "
              f"{floor:.3f} ms), busy share {busy:.3f}, {prof['kernels_launched']} kernels: "
              f"{'device' if busy >= 0.8 else 'host'}-paced; top {json.dumps(prof['top_kernels'][:4])}")
        del model, params
        torch.cuda.empty_cache()
        print(f"  {cfg.name}: {time.perf_counter() - t0:.3f} s", flush=True)
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
    by page-copy (after the same 8 served clean, which times the drain), on
    a second fleet of the same shape that records into one Observation:
    every page-copied request's spans run migrate_out, migrate_in on the
    other replica, then one complete, and capacity is conserved. Returns
    the clean serve's launches and flash's launches by body."""
    from repro_torch.core import CostModel
    from repro_torch.launch.profile_step import SERVE_LEN
    from repro_torch.obs import Observation, check_capacity_conservation
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
    del fleet
    torch.cuda.empty_cache()
    obs = Observation()
    fleet = Fleet(model, params, dataclasses.replace(ecfg, observe=obs), fcfg,
                  cost_model=CostModel(level_caps=(32, 64, 128, 256)), device=model.device)
    fleet.warm_serving_shapes()
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
    check(check_capacity_conservation(obs), "drain: capacity not conserved")
    for rec in records:
        evs = obs.spans.by_request(rec["rid"])
        kinds = [e.kind for e in evs]
        check("migrate_out" in kinds and "migrate_in" in kinds, f"drain: request {rec['rid']} spans {kinds}")
        i_out, i_in = kinds.index("migrate_out"), kinds.index("migrate_in")
        check(i_out < i_in and evs[i_out].replica != evs[i_in].replica
              and evs[i_in].parent == evs[i_out].event_id
              and kinds[i_in:].count("complete") == 1 and kinds[-1] == "complete"
              and obs.spans.chain(rec["rid"]) == evs,
              f"drain: request {rec['rid']} spans {[(e.kind, e.replica) for e in evs]}")
    print(f"  drain observed: {len(records)} page-copied requests each migrate_out -> migrate_in on the "
          f"other replica -> complete; capacity conserved; {len(obs.spans.events)} spans, "
          f"{len(obs.audit.records)} audit records", flush=True)
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


def run_sampler_parity(torch, np):
    """Top-p sampling on the card against the CPU: threefry keys folded from
    (seed, rid, step) and their random bits at Qwen3-8B's (8, 151936) bit for
    bit, then categorical and top-p draws on the same logits; then the
    float32 smoke Qwen3 served under TopPSampler(top_p=0.9), sample_seed 0,
    with an Observation and the scripted clock, on the paged (mixed) and the
    dense layout: the same streams, each request's span kinds in the same
    order and the same Observation state on both sides."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import (
        CostModel, LagrangianPolicy, SortingPreemptiveScheduler, build_clients, solve_offline,
    )
    from repro_torch.data import WorkloadSpec, gsm8k_like_workload
    from repro_torch.obs import Observation
    from repro_torch.serving import Engine, EngineConfig, OnlineProfiler, TopPSampler, fold_row_keys, greedy
    from repro_torch.serving.threefry import categorical, random_bits, seed_key

    b, v = 8, 151936
    rids = np.array([-1, 0, 1, 2, 3, 5, 8, 2**31 - 1], np.int32)
    steps = np.arange(b, dtype=np.int32) * 17
    logits = torch.from_numpy(np.random.default_rng(2).standard_normal((b, v)).astype(np.float32) * 4)
    out = {}
    for dev in ("cpu", "cuda"):
        keys = fold_row_keys(seed_key(0, dev), torch.from_numpy(rids).to(dev), torch.from_numpy(steps).to(dev))
        x = logits.to(dev)
        out[dev] = [t.cpu() for t in (keys, random_bits(keys, (v,)), categorical(keys, x),
                                       TopPSampler(top_p=0.9)(x, keys))]
    for what, a, c in zip(("keys", "random bits", "categorical draws", "top-p draws"), out["cpu"], out["cuda"]):
        check(bool(torch.equal(a, c)), f"sampler: {what} differ card vs CPU")
    print(f"  threefry at ({b}, {v}): keys, bits, categorical and top-p draws card == CPU: True "
          f"(top-p tokens {out['cuda'][3].tolist()})", flush=True)
    # what one decode iteration's draw costs: its device kernels, its device
    # time queued behind a sleep, and its time paced by the host's launches
    # (the fused loop folds a horizon's keys once, outside the draw)
    x, base = logits.cuda(), seed_key(0, "cuda")
    r, st = torch.from_numpy(rids).cuda(), torch.from_numpy(steps).cuda()
    keys = fold_row_keys(base, r, st)
    horizon = st + torch.arange(8, dtype=st.dtype, device="cuda")[:, None]
    for what, draw in ((f"top-p draw at ({b}, {v})", lambda: TopPSampler(top_p=0.9)(x, keys)),
                       (f"greedy argmax at ({b}, {v})", lambda: greedy(x)),
                       (f"key fold of a K = 8 horizon (8, {b})", lambda: fold_row_keys(base, r, horizon))):
        n = len(device_kernels(torch, draw))
        print(f"  sampler cost, {what}: {n} device kernels, device "
              f"{time_warm_ms(torch, draw, batch=5, reps=10):.4f} ms (queued), host-paced "
              f"{time_host_paced_ms(torch, draw, iters=20):.4f} ms", flush=True)

    cfg = dataclasses.replace(get_smoke_config("qwen3_8b"), dtype="float32")
    spec = WorkloadSpec(n_requests=10, input_mean=20, input_std=6, output_mean=12, output_std=5,
                        output_max=16, input_max=40)
    models = _card_and_cpu(torch, cfg)
    for layout in ("paged", "dense"):
        runs = []
        for m, p in models:
            cm = CostModel(level_caps=(32, 64, 128))
            reqs = gsm8k_like_workload(spec, seed=3, known_lengths=True)
            clients = build_clients(4, reqs, solve_offline(reqs, 4, cm).assignment)
            obs = Observation()
            eng = Engine(m, p, EngineConfig(n_slots=4, max_len=64, kv_layout=layout, prefill_chunk=16,
                                            straggler_factor=1e9, sample_seed=0, observe=obs),
                         profiler=OnlineProfiler(initial=cm, refit_every=10**9),
                         sampler=TopPSampler(top_p=0.9), device=m.device)
            with scripted_clock():
                eng.serve(reqs, clients, SortingPreemptiveScheduler(clients), LagrangianPolicy())
            spans = {rid: [e.kind for e in obs.spans.by_request(rid)] for rid in obs.spans.request_ids()}
            runs.append((eng.generated, spans, obs.state_dict()))
        (gen_cpu, spans_cpu, state_cpu), (gen, spans, state) = runs
        check(gen == gen_cpu, f"smoke top-p {layout}: streams differ card vs CPU")
        check(spans == spans_cpu, f"smoke top-p {layout}: span kinds differ card vs CPU")
        check(state == state_cpu, f"smoke top-p {layout}: Observation state differs card vs CPU")
        print(f"  smoke top-p {layout} serve card == CPU: streams of {len(gen)} requests, span kinds, "
              f"Observation state ({sum(len(k) for k in spans.values())} request spans): True", flush=True)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


KERNELS = (
    # (row name, result key, shapes the row's times were taken at, launch-count
    #  name, path that runs it, source, TPU kernel)
    ("paged_decode_attention", "paged_decode_attention", "qwen3-8b", "paged_decode_attention",
     "paged", "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
     "src/repro/kernels/paged_decode_attention.py:136"),
    ("flash_attention", "flash_attention", "qwen3-8b", "flash_attention", "paged",
     "src/repro_torch/kernels/csrc/flash_attention.cu", "src/repro/kernels/flash_attention.py:131"),
    ("flash_attention_dense", "flash_attention_dense", "qwen3-8b", "flash_attention", "dense",
     "src/repro_torch/kernels/csrc/flash_attention.cu", "src/repro/kernels/flash_attention.py:131"),
    ("decode_attention", "decode_attention", "qwen3-8b", "decode_attention", "dense",
     "src/repro_torch/kernels/csrc/decode_attention.cu", "src/repro/kernels/decode_attention.py:111"),
    ("flash_attention_dense_recurrentgemma", "flash_attention_dense", "recurrentgemma-9b",
     "flash_attention", "recurrentgemma",
     "src/repro_torch/kernels/csrc/flash_attention.cu", "src/repro/kernels/flash_attention.py:131"),
    ("decode_attention_recurrentgemma", "decode_attention", "recurrentgemma-9b", "decode_attention",
     "recurrentgemma",
     "src/repro_torch/kernels/csrc/decode_attention.cu", "src/repro/kernels/decode_attention.py:111"),
    ("rglru_scan", "rglru_scan", "recurrentgemma-9b", "rglru_scan", "recurrentgemma",
     "src/repro_torch/kernels/csrc/rglru.cu", "src/repro/kernels/rglru.py:81"),
    ("flash_attention_backward", "flash_attention_backward", "qwen3-8b train", "flash_attention_backward",
     "train", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
     "src/repro/models/attention.py:18 attention, the gradient jax.grad derives on the training path "
     "(the gradient of kernel 2's function; no Pallas kernel)"),
    ("flash_attention_dense_train", "flash_attention_dense", "qwen3-8b train", "flash_attention", "train",
     "src/repro_torch/kernels/csrc/flash_attention.cu", "src/repro/kernels/flash_attention.py:131"),
) + tuple(
    (f"{name}_{arch.split('_')[0]}", name, label, count, f"{arch} {layout}", f"src/repro_torch/kernels/csrc/{src}.cu",
     replaces)
    for arch, label in (("llama_65b", "llama-65b"), ("starcoder2_7b", "starcoder2-7b"))
    for name, count, layout, src, replaces in (
        ("paged_decode_attention", "paged_decode_attention", "paged", "paged_decode_attention",
         "src/repro/kernels/paged_decode_attention.py:136"),
        ("flash_attention", "flash_attention", "paged", "flash_attention",
         "src/repro/kernels/flash_attention.py:131"),
        ("flash_attention_dense", "flash_attention", "dense", "flash_attention",
         "src/repro/kernels/flash_attention.py:131"),
        ("decode_attention", "decode_attention", "dense", "decode_attention",
         "src/repro/kernels/decode_attention.py:111"),
    )
)


def _hgmma_counts(build, name):
    """HGMMA (wgmma) instructions in each function of ``name``'s library,
    read with cuobjdump from the toolkit that built it."""
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(build.lib_path(name))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn and "HGMMA" in line:
            counts[fn] += 1
    return counts


def check_tensor_core_sass(build):
    """The flash library's tensor-core kernels issue HGMMA (wgmma) in their
    SASS."""
    counts = _hgmma_counts(build, "flash_attention")
    tc = {f: n for f, n in counts.items() if "flash_tc_kernel" in f}
    print(f"  flash_attention SASS: HGMMA in {sum(1 for n in tc.values() if n)} of {len(tc)} "
          f"tensor-core variants ({sum(tc.values())} instructions), "
          f"{sum(n for f, n in counts.items() if f not in tc)} in the CUDA-core variants")
    check(bool(tc) and all(tc.values()), f"flash tensor-core variants without HGMMA: {tc}")


def check_backward_build(build):
    """The flash backward's wgmma kernels issue HGMMA and keep everything in
    registers: no stack and no local memory in cuobjdump's resource usage
    of the built library, and 0 spill bytes in ptxas's report where this
    process built it; its other kernels issue no HGMMA."""
    counts = _hgmma_counts(build, "flash_attention_bwd")
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    usage = subprocess.run([str(tool), "-res-usage", str(build.lib_path("flash_attention_bwd"))],
                           capture_output=True, text=True, check=True, timeout=300).stdout
    res, fn = {}, None
    for line in usage.splitlines():
        if line.strip().startswith("Function "):
            fn = line.strip()[len("Function "):].rstrip(":")
        elif fn and "REG:" in line:
            res[fn] = {k: int(v) for k, v in re.findall(r"(REG|STACK|LOCAL):(\d+)", line)}
            fn = None
    ptxas = build.ptxas_kernels("flash_attention_bwd")
    wg = {f: n for f, n in counts.items() if "wgmma" in f}
    for f, n in sorted(wg.items()):
        print(f"    {f}: HGMMA {n}, {json.dumps(res.get(f))}, ptxas: {ptxas.get(f, 'not built here')}")
    others = sum(n for f, n in counts.items() if f not in wg)
    print(f"  flash_attention_bwd SASS: HGMMA in {sum(1 for n in wg.values() if n)} of {len(wg)} wgmma "
          f"kernels, {others} in the other {len(counts) - len(wg)} kernels", flush=True)
    check(bool(wg) and all(wg.values()), f"flash backward wgmma kernels without HGMMA: {wg}")
    check(others == 0, "flash backward: HGMMA outside its wgmma kernels")
    for f in wg:
        check(f in res and res[f]["STACK"] == 0 and res[f]["LOCAL"] == 0,
              f"flash backward {f}: stack or local memory (spills): {res.get(f)}")
        if f in ptxas:
            check("0 bytes spill stores, 0 bytes spill loads" in ptxas[f], f"flash backward {f}: {ptxas[f]}")


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


# --------------------------------------------------------------------------- #
# Training                                                                    #
# --------------------------------------------------------------------------- #
# The backward kernel's shapes: Qwen3-8B's attention at the check's batch of
# 2 (timed, the kernels line's row) and at the train step's microbatch of 1
# (timed), a sliding window, LLaMA-65B's MHA, and float32 at the smoke shape.
TRAIN_KERNEL_CASES = (
    ("qwen3-8b", dict(b=2, h=32, kv=8, s=2048, d=128, window=0, dtype="bfloat16")),
    ("qwen3-8b microbatch", dict(b=1, h=32, kv=8, s=2048, d=128, window=0, dtype="bfloat16")),
    ("window 256", dict(b=2, h=32, kv=8, s=1024, d=128, window=256, dtype="bfloat16")),
    ("llama-65b", dict(b=1, h=64, kv=64, s=2048, d=128, window=0, dtype="bfloat16")),
    ("smoke", dict(b=2, h=4, kv=2, s=64, d=16, window=0, dtype="float32")),
)
TIMED_TRAIN_CASES = ("qwen3-8b", "qwen3-8b microbatch")
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")
TRAIN_LAYERS = 12                 # full-width Qwen3-8B cut to 12 of its 36 layers
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICROBATCHES = 8, 2, 2048, 2
TRAIN_PARITY = ("qwen3_8b", "olmoe_1b_7b", "qwen2_vl_7b", "mixtral_8x22b")


def attention_pairs(s, window):
    """(query, key) pairs a causal (windowed) self-attention of length s sees."""
    return sum(min(i + 1, window) if window else i + 1 for i in range(s))


def flash_backward_bound(q, k, window, flops_per_pair=10):
    """Five products of the visible pairs (S, dP, dV, dQ, dK: 10 D flops a
    pair and head) against reading q, k, v, o, dO and lse once and writing
    dq, dk and dv once. With ``flops_per_pair=14`` the same count for the
    kernel's own design, whose dQ pass computes S and dP again: its floor,
    not the function's bound."""
    b, h, s, d = q.shape
    e = q.element_size()
    nbytes = (4 * q.numel() + 4 * k.numel()) * e + b * h * s * 4
    flops = flops_per_pair * d * h * b * attention_pairs(s, window)
    peak = F32_FLOPS_PER_S if e == 4 else BF16_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def rel_err(torch, out, ref, tol, what):
    """Largest error relative to the reference's largest magnitude (a
    gradient's scale is set by the whole tensor, and bf16 inputs round at
    other places in the plain version's float32 einsums)."""
    out, ref = out.float(), ref.float()
    check(bool(torch.isfinite(out).all()), f"{what}: not finite")
    err = float((out - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
    check(err <= tol, f"{what}: relative error {err:.3g} over {tol}")
    return err


def sdpa_times(torch, F, flush, q, k, v, do):
    """The library yardstick, timed here only and never called by the port:
    scaled_dot_product_attention (causal) under each backend that takes
    these inputs, its forward, forward + backward, and backward alone (one
    forward kept outside the timed region, then torch.autograd.grad with
    retain_graph). With enable_gqa where the backend takes it, else with K
    and V expanded to the query heads outside the timed region (that
    backward then returns the expanded heads' dK and dV unsummed).
    Returns {backend: times}."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    g = q.shape[1] // k.shape[1]
    out = {}
    for name in SDPA_BACKENDS:
        for gqa in (True, False):
            kk, vv = (k, v) if gqa else (k.repeat_interleave(g, 1), v.repeat_interleave(g, 1))
            leaves = [x.detach().clone().requires_grad_(True) for x in (q, kk, vv)]
            fwd = lambda: F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=gqa)
            try:
                with sdpa_kernel(getattr(SDPBackend, name)):
                    o = fwd()
                    torch.autograd.grad(o, leaves, do, retain_graph=True)
                    torch.cuda.synchronize()
                    row = dict(
                        enable_gqa=gqa,
                        forward_ms=time_ms(torch, fwd, flush, iters=10, warmup=2),
                        forward_backward_ms=time_ms(
                            torch, lambda: torch.autograd.grad(fwd(), leaves, do), flush, iters=10, warmup=2),
                        backward_ms=time_ms(
                            torch, lambda: torch.autograd.grad(o, leaves, do, retain_graph=True), flush,
                            iters=10, warmup=2))
            except RuntimeError as e:
                print(f"  SDPA {name} enable_gqa={gqa}: refused ({str(e).strip().splitlines()[0][:100]})",
                      flush=True)
                continue
            out[name] = row
            print(f"  SDPA {name} enable_gqa={gqa}: forward {row['forward_ms']:.4f} ms, forward + backward "
                  f"{row['forward_backward_ms']:.4f} ms, backward alone {row['backward_ms']:.4f} ms", flush=True)
            break
        torch.cuda.empty_cache()
    check(bool(out), "no SDPA backend takes the training shape")
    return out


def fastest(sdpa, key):
    """The fastest backend's time of ``key`` and the backend's name."""
    name = min(sdpa, key=lambda n: sdpa[n][key])
    return sdpa[name][key], name


def run_train_kernel_checks(torch, np, F):
    """Kernel 2's forward with the log-sum-exp and the backward kernel at
    TRAIN_KERNEL_CASES against their plain versions: one device kernel a
    forward, the device kernels of ``backward_plan`` a backward (the same
    names, count and order; each pass's device µs printed), two calls equal
    bit for bit, and at the bf16 cases the wgmma body's other plan (the GQA
    group split or not) checked and timed beside the plan's. At
    TIMED_TRAIN_CASES the cold-L2 times of the backward, its plain version,
    the forward with the log-sum-exp, our forward + backward, and SDPA on
    the same inputs under each backend (sdpa_times; the yardstick, never
    called by the port). Returns the rows of the kernels line: the
    backward's and kernel 2's dense entry at the training shape."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb

    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    rows, timed = {}, {}
    for label, c in TRAIN_KERNEL_CASES:
        g = torch.Generator(device="cuda").manual_seed(7)
        dt = getattr(torch, c["dtype"])
        mk = lambda n: torch.randn(c["b"], c["s"], n, c["d"], device="cuda", generator=g).to(dt).transpose(1, 2)
        q, k, v, do = mk(c["h"]), mk(c["kv"]), mk(c["kv"]), mk(c["h"])
        w, scale = c["window"], c["d"] ** -0.5
        out, lse = fa.flash_attention(q, k, v, causal=True, window=w, return_lse=True)
        grads = fb.flash_attention_backward(q, k, v, out, lse, do, causal=True, window=w)
        torch.cuda.synchronize()
        tol = KERNEL_TOL[c["dtype"]]
        ref_lse = fa.flash_attention_lse_plain(q, k, causal=True, window=w)
        err_lse = float((lse - ref_lse).abs().max())
        check(err_lse <= KERNEL_TOL["float32"] * (1 + float(ref_lse.abs().max())),
              f"flash lse [{label}]: max err {err_lse:.3g}")
        refs = fb.flash_attention_backward_plain(q, k, v, out, ref_lse, do, causal=True, window=w)
        errs = {f"d{n}": rel_err(torch, a, b, tol, f"flash_attention_backward [{label}] d{n}")
                for n, a, b in zip("qkv", grads, refs)}
        max_abs = max(float((a.float() - b.float()).abs().max()) for a, b in zip(grads, refs))
        plan = fb.backward_plan(c["b"], c["h"], c["kv"], c["s"], c["s"], c["d"], dt, causal=True, window=w,
                                n_sms=n_sms(torch))
        fwd_names = device_kernels(torch, lambda: fa.flash_attention(
            q, k, v, causal=True, window=w, return_lse=True))
        passes = device_kernel_us(torch, lambda: fb.flash_attention_backward(
            q, k, v, out, lse, do, causal=True, window=w))
        names = [n for n, _ in passes]
        check(len(fwd_names) == 1, f"flash forward [{label}] ran {fwd_names}")
        check(len(names) == len(plan.kernels) and all(k_ in n for k_, n in zip(plan.kernels, names)),
              f"flash backward [{label}] ran {names}, its plan {plan.kernels}")
        again = fb.flash_attention_backward(q, k, v, out, lse, do, causal=True, window=w)
        check(all(bool(torch.equal(a, b)) for a, b in zip(grads, again)),
              f"flash backward [{label}]: two calls differ")
        del again
        print(f"  flash_attention_backward [{label}] {tuple(q.shape)} kv {c['kv']} window {w} {c['dtype']}: "
              f"lse max err {err_lse:.3g}, rel err {json.dumps(errs)} (tol {tol}), forward one device "
              f"kernel, backward the plan's {len(names)} ({plan.body}, split group {plan.split_group}, "
              f"scratch {plan.scratch_bytes} B), two calls equal; device µs a pass "
              f"{json.dumps([[n.split('(')[0].split('::')[-1], round(us, 1)] for n, us in passes])}",
              flush=True)
        ms_by_plan = {}
        if plan.body == "tensor_cores" and c["h"] > c["kv"]:
            # the other dK/dV grid: the GQA group split over CTAs, or not
            alt = fb.backward_plan(c["b"], c["h"], c["kv"], c["s"], c["s"], c["d"], dt, causal=True,
                                   window=w, split=not plan.split_group)
            alt_grads = fb._launch(q, k, v, out, lse, do, True, w, scale, alt)
            torch.cuda.synchronize()
            alt_errs = [rel_err(torch, a, b, tol, f"flash_attention_backward [{label}] other plan")
                        for a, b in zip(alt_grads, refs)]
            del alt_grads
            for p in (plan, alt):
                key = "split" if p.split_group else "grouped"
                ms_by_plan[key] = time_ms(torch, lambda: fb._launch(q, k, v, out, lse, do, True, w, scale, p),
                                          flush, iters=10, warmup=2)
            print(f"  flash_attention_backward [{label}] by plan (the plan: "
                  f"{'split' if plan.split_group else 'grouped'}): "
                  f"{json.dumps({k_: round(ms, 4) for k_, ms in ms_by_plan.items()})} ms, the other's rel err "
                  f"{max(alt_errs):.3g}", flush=True)
        del refs
        if label in TIMED_TRAIN_CASES:
            def ours_fwd_bwd():
                o, l = fa.flash_attention(q, k, v, causal=True, return_lse=True)
                return fb.flash_attention_backward(q, k, v, o, l, do, causal=True)

            bound_ms, bound_by = flash_backward_bound(q, k, w)
            floor_ms, _ = flash_backward_bound(q, k, w, flops_per_pair=14)
            sdpa = sdpa_times(torch, F, flush, q, k, v, do)
            library_ms, library_backend = fastest(sdpa, "backward_ms")
            row = dict(
                max_abs_err=max_abs, rel_err=max(errs.values()), plan=plan._asdict(),
                pass_us=[[n, us] for n, us in passes], ms_by_plan=ms_by_plan,
                ms=time_ms(torch, lambda: fb.flash_attention_backward(q, k, v, out, lse, do, causal=True),
                           flush, iters=10, warmup=2),
                plain_ms=time_ms(torch, lambda: fb.flash_attention_backward_plain(
                    q, k, v, out, lse, do, causal=True), flush, iters=5, warmup=1),
                forward_lse_ms=time_ms(torch, lambda: fa.flash_attention(
                    q, k, v, causal=True, return_lse=True), flush, iters=10, warmup=2),
                forward_backward_ms=time_ms(torch, ours_fwd_bwd, flush, iters=10, warmup=2),
                library_ms=library_ms, library_backend=library_backend,
                library_forward_backward_ms=fastest(sdpa, "forward_backward_ms")[0], sdpa=sdpa,
                bound_ms=bound_ms, bound_by=bound_by, design_floor_ms=floor_ms,
            )
            timed[label] = row
            print(f"  flash_attention_backward [{label}] timed: backward {row['ms']:.4f} ms (passes "
                  f"{' + '.join(f'{us:.1f}' for _, us in passes)} µs), plain {row['plain_ms']:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by}, {row['ms'] / bound_ms:.2f}x), the design's floor "
                  f"{floor_ms:.4f} ms; SDPA's backward alone {library_ms:.4f} ms ({library_backend}); forward "
                  f"with lse {row['forward_lse_ms']:.4f} ms; forward + backward {row['forward_backward_ms']:.4f} "
                  f"ms against SDPA's {row['library_forward_backward_ms']:.4f} ms", flush=True)
            if label == "qwen3-8b":
                # kernel 2's dense entry as the training path runs it: with
                # its log-sum-exp, against the plain forward and lse
                fwd_bound_ms, fwd_bound_by = dense_flash_bound(q, k)
                out_ref = fa.flash_attention_plain(q, k, v, causal=True)
                rows["flash_attention_dense"] = dict(
                    max_abs_err=max_err(torch, out, out_ref, KERNEL_TOL[c["dtype"]]),
                    ms=row["forward_lse_ms"],
                    plain_ms=time_ms(torch, lambda: (fa.flash_attention_plain(q, k, v, causal=True),
                                                     fa.flash_attention_lse_plain(q, k, causal=True)),
                                     flush, iters=5, warmup=1),
                    library_ms=fastest(sdpa, "forward_ms")[0], library_backend=fastest(sdpa, "forward_ms")[1],
                    bound_ms=fwd_bound_ms, bound_by=fwd_bound_by)
                print(f"  flash_attention_dense [qwen3-8b train] timed: forward with lse {row['forward_lse_ms']:.4f} "
                      f"ms, plain {rows['flash_attention_dense']['plain_ms']:.4f} ms, SDPA's forward "
                      f"{rows['flash_attention_dense']['library_ms']:.4f} ms, bound {fwd_bound_ms:.4f} ms "
                      f"({fwd_bound_by})", flush=True)
                del out_ref
        del q, k, v, do, out, lse, grads
        torch.cuda.empty_cache()
    rows["flash_attention_backward"] = dict(timed["qwen3-8b"], microbatch=timed["qwen3-8b microbatch"])
    return rows


def _train_counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb

    return fa.launch_count, fb.launch_count


def _reset_train_counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb

    fa.reset_launch_count()
    fb.reset_launch_count()


def train_launches(n_layers, passes, remat):
    """What a training run implies: kernel 2's forward n_layers x passes x
    (2 under remat: the recompute), the backward n_layers x passes."""
    return {"flash_attention": n_layers * passes * (2 if remat else 1),
            "flash_attention_backward": n_layers * passes}


def check_train_launches(what, n_layers, passes, remat):
    """The flash forward and backward launched exactly as the run implies."""
    got = dict(zip(("flash_attention", "flash_attention_backward"), _train_counts()))
    want = train_launches(n_layers, passes, remat)
    print(f"  {what} launches: {json.dumps(got)} (expected {json.dumps(want)})", flush=True)
    check(got == want, f"{what}: flash launches {got}, the path implies {want}")


def _step0_checkpoint(params_cpu, directory):
    """A step-0 checkpoint of the CPU model's parameters and a fresh AdamW
    state: train() on either device resumes from it, so both start from the
    same weights (each device's generator draws other numbers)."""
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.train.optimizer import adamw_init

    save_checkpoint(directory, 0, {"params": params_cpu, "opt": adamw_init(params_cpu)})


def run_train_parity(torch, np):
    """TRAIN_PARITY's float32 smoke configs (every weight perturbed off its
    init), card against CPU: the loss (1e-4) and every gradient leaf
    (TRAIN_GRAD_TOL relative to the leaf's largest magnitude), one AdamW
    step on identical gradients
    (the CPU's, copied to the card), and three train() steps (two
    microbatches, remat) from the same step-0 checkpoint at train()'s
    default optimizer (lr 1e-4, warmup 10: the reference's); flash launches
    exact. At lr 1e-2 the smoke OLMoE's losses drifted apart by 5e-4 in
    three steps with gradients equal to 1e-6: AdamW's first steps are
    sign-like, so where an element's gradient is near 0 the two devices can
    step it 2 lr apart, and the next steps (and the MoE's routing) see it."""
    import tempfile

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.layers import _leaves as leaves_of
    from repro_torch.models.layers import tree_map
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_loop import TrainConfig, synthetic_batches, train

    for arch in TRAIN_PARITY:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        (cpu, p_cpu), (card, p_card) = _card_and_cpu(torch, cfg, perturb=True)
        tc = TrainConfig(steps=3, batch=4, seq=32, microbatches=2, remat=True, log_every=0)
        batch = next(synthetic_batches(cfg, tc))
        grads = {}
        for dev, m, p in (("cpu", cpu, p_cpu), ("cuda", card, p_card)):
            leaves = [(path, t.detach().clone().requires_grad_(True)) for path, t in leaves_of(p)]
            tree = {}
            for path, t in leaves:
                node = tree
                for key in path[:-1]:
                    node = node.setdefault(key, {})
                node[path[-1]] = t
            _reset_train_counts()
            loss = m.loss(tree, {k: x.to(dev) for k, x in batch.items()}, remat=True)
            gs = torch.autograd.grad(loss, [t for _, t in leaves])
            grads[dev] = (float(loss.detach()), {path: g.cpu() for (path, _), g in zip(leaves, gs)})
            if dev == "cuda":
                check_train_launches(f"smoke {arch} loss + grad", cfg.n_layers, 1, True)
        loss_err = abs(grads["cpu"][0] - grads["cuda"][0])
        check(loss_err <= LOGITS_TOL, f"smoke {arch}: loss card vs CPU {loss_err:.3g}")
        worst = 0.0
        for path, g in grads["cpu"][1].items():
            e = float((grads["cuda"][1][path] - g).abs().max() / g.abs().max().clamp_min(1e-30))
            check(e <= TRAIN_GRAD_TOL, f"smoke {arch} grad {'/'.join(path)}: card vs CPU {e:.3g}")
            worst = max(worst, e)
        # one AdamW step on the same gradients
        g_cpu = {}
        for path, g in grads["cpu"][1].items():
            node = g_cpu
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = g
        cfg_opt = opt.AdamWConfig(lr=1e-2, warmup_steps=1)
        new_cpu, _, m_cpu = opt.adamw_update(g_cpu, opt.adamw_init(p_cpu), tree_map(torch.clone, p_cpu),
                                             cfg_opt)
        new_card, _, m_card = opt.adamw_update(tree_map(lambda x: x.cuda(), g_cpu),
                                               opt.adamw_init(p_card), tree_map(torch.clone, p_card), cfg_opt)
        step_err = max(float((b.cpu() - a).abs().max()) for (_, a), (_, b) in
                       zip(leaves_of(new_cpu), leaves_of(new_card)))
        check(step_err <= 1e-6, f"smoke {arch}: AdamW step on identical gradients card vs CPU {step_err:.3g}")
        # three train() steps from one step-0 checkpoint
        losses = {}
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            for dev in ("cpu", "cuda"):
                d = Path(tmp) / dev
                _step0_checkpoint(p_cpu, d)
                _reset_train_counts()
                out = train(cfg, dataclasses.replace(tc, checkpoint_dir=str(d), save_every=100),
                            device=dev)
                losses[dev] = out["losses"]
                if dev == "cuda":
                    check_train_launches(f"smoke {arch} train()", cfg.n_layers, 3 * 2, True)
        train_err = max(abs(a - b) for a, b in zip(losses["cpu"], losses["cuda"]))
        check(len(losses["cuda"]) == 3 and train_err <= LOGITS_TOL,
              f"smoke {arch}: train() losses card {losses['cuda']} vs CPU {losses['cpu']}")
        print(f"  smoke {arch} float32 training card vs CPU: loss err {loss_err:.3g}, worst gradient leaf "
              f"{worst:.3g} (relative), AdamW step on identical gradients {step_err:.3g}, grad_norm "
              f"{float(m_card['grad_norm']):.6g} vs {float(m_cpu['grad_norm']):.6g}, three train() steps "
              f"{json.dumps(losses['cuda'])} vs {json.dumps(losses['cpu'])} (max err {train_err:.3g})",
              flush=True)


def run_train_loop_checks(torch):
    """On the card: the smoke Qwen3 (bf16, as configured) trained 60 steps
    loses at least 0.3 (the reference's test_train_loss_decreases); the
    float32 smoke Qwen3 trained 9 steps in one run equals 6 steps, a
    CheckpointManager save and a resume for 3 more (losses within 1e-6;
    whether bit-equal is printed)."""
    import tempfile

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.layers import _leaves as leaves_of
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import TrainConfig, train

    cfg = get_smoke_config("qwen3_8b")
    _reset_train_counts()
    t0 = time.perf_counter()
    out = train(cfg, TrainConfig(steps=60, batch=4, seq=32, log_every=0),
                AdamWConfig(lr=5e-3, warmup_steps=5), device="cuda")
    check_train_launches("smoke qwen3 60 steps", cfg.n_layers, 60, False)
    drop = out["first_loss"] - out["last_loss"]
    check(drop >= 0.3, f"smoke qwen3: loss {out['first_loss']:.4f} -> {out['last_loss']:.4f}")
    print(f"  smoke qwen3 ({cfg.dtype}) 60 steps on the card: loss {out['first_loss']:.4f} -> "
          f"{out['last_loss']:.4f} (drop {drop:.4f} >= 0.3), {time.perf_counter() - t0:.2f} s", flush=True)

    cfg = dataclasses.replace(cfg, dtype="float32")
    kw = dict(batch=2, seq=16, save_every=3, log_every=0)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        whole = train(cfg, TrainConfig(steps=9, **kw), device="cuda")
        first = train(cfg, TrainConfig(steps=6, checkpoint_dir=tmp, **kw), device="cuda")
        rest = train(cfg, TrainConfig(steps=9, checkpoint_dir=tmp, **kw), device="cuda")
    resumed = first["losses"] + rest["losses"]
    check((rest["start_step"], rest["steps_run"]) == (6, 3), f"resume: {rest['start_step']}, {rest['steps_run']}")
    err = max(abs(a - b) for a, b in zip(resumed, whole["losses"]))
    check(len(resumed) == 9 and err <= 1e-6, f"resume: losses {resumed} vs {whole['losses']}")
    same = all(bool(torch.equal(a, b)) for (_, a), (_, b) in zip(leaves_of(whole["params"]),
                                                                 leaves_of(rest["params"])))
    print(f"  smoke qwen3 float32 on the card: 9 steps in one run vs 6 + save + resume for 3: losses max "
          f"err {err:.3g}, losses bit-equal {resumed == whole['losses']}, parameters bit-equal {same}",
          flush=True)


def run_full_width_train(torch, np, smi):
    """Qwen3-8B at its published widths, cut to TRAIN_LAYERS of 36 layers
    (AdamW's state must fit in 80 GB), bf16, random weights from seed 0:
    TRAIN_STEPS steps of train() at batch TRAIN_BATCH x TRAIN_SEQ with
    TRAIN_MICROBATCHES microbatches and remat. Gates: every loss finite,
    grad_norm finite and > 0, count == TRAIN_STEPS, parameters changed,
    exact flash launches. Then one more step under torch.profiler (device
    busy share). Returns the launches and the measured numbers."""
    from repro_torch.configs import get_config
    from repro_torch.launch.profile_step import _measure
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import TrainConfig, synthetic_batches, train
    from repro_torch.train.train_step import make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    full = get_config("qwen3_8b")
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    tc = TrainConfig(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     microbatches=TRAIN_MICROBATCHES, remat=True, log_every=1)
    opt_cfg = AdamWConfig(lr=1e-4, warmup_steps=2)
    # a few rows of the initial weights (train() draws the same from the
    # seed), to show the steps changed them. Not the leaves initialised to 1
    # (bf16 keeps 1 under steps of ~lr = 1e-4, below half a bf16 step there)
    # nor embedding rows of tokens the batches never hold (weight decay
    # alone moves them less than a bf16 step)
    sample = lambda p: {"unembed": p["embed"]["unembed"][:, :64].clone(),
                        "wq": p["blocks"]["wq"][0, :64].clone(),
                        "w_down": p["blocks"]["mlp"]["w_down"][-1, :64].clone()}
    init = TransformerLM(cfg, device="cuda").init_params(tc.seed)
    before = sample(init)
    del init
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels = kernel_modules()
    for mod in kernels.values():
        mod.reset_launch_count()
    out = train(cfg, tc, opt_cfg, device="cuda")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {name: mod.launch_count for name, mod in kernels.items()}
    check_launches("qwen3-8b train", launches,
                   train_launches(cfg.n_layers, TRAIN_STEPS * TRAIN_MICROBATCHES, True))
    flash_by_variant = check_flash_variants("qwen3-8b train", launches)
    by_body = kernels["flash_attention_backward"].launch_count_by_variant
    print(f"  qwen3-8b train flash backward launches by body: {json.dumps(by_body)}")
    check(by_body["tensor_cores"] == launches["flash_attention_backward"],
          "bf16 flash backward off the tensor-core body")
    params, state = out["params"], out["opt_state"]
    n_params = sum(x.numel() for x in _leaves(params))
    check(all(np.isfinite(out["losses"])), f"train losses not finite: {out['losses']}")
    check(all(np.isfinite(out["grad_norms"])) and min(out["grad_norms"]) > 0,
          f"grad norms {out['grad_norms']}")
    check(int(state["count"]) == TRAIN_STEPS, f"count {int(state['count'])}")
    changed = {name: float((x != before[name]).float().mean()) for name, x in sample(params).items()}
    print(f"  qwen3-8b train: share of sampled weights the steps changed {json.dumps(changed)}")
    check(all(share > 0 for share in changed.values()), f"parameters did not change: {changed}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = out["step_s"][1:]
    step_s = statistics.median(steady)
    hd, s = cfg.resolved_head_dim, TRAIN_SEQ
    n_blocks = sum(x.numel() for x in _leaves(params["blocks"]))
    model_flops = (6 * (n_blocks + cfg.d_model * cfg.vocab_size) * tokens
                   + 12 * hd * cfg.n_heads * cfg.n_layers * TRAIN_BATCH * attention_pairs(s, 0))
    mfu = model_flops / step_s / BF16_FLOPS_PER_S
    # one more step of the same work under the profiler
    model = TransformerLM(cfg, device="cuda")
    step_fn = make_train_step(model, opt_cfg, microbatches=TRAIN_MICROBATCHES, remat=True)
    batch = next(synthetic_batches(cfg, tc, "cuda"))
    prof = _measure("train step", lambda: step_fn(params, state, batch), iters=1, kernels=True)
    if not prof["kernels_launched"]:
        # every trace came back empty: the profiled numbers are not measured
        prof.update(device_busy_share=None, device_ms=None)
    by_kind = {}
    for name, us in prof["kernel_us"]:
        kind = ("flash backward" if "flash_bwd" in name else "flash forward" if "flash_" in name else
                "gemm" if any(t in name for t in ("gemm", "nvjet", "cutlass", "sm90_xmma")) else
                "elementwise, reductions, copies")
        by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3
    # the optimizer alone: one adamw_update (global norm, clip, moments,
    # the in-place parameter update) on a gradient tree of the params' size
    from repro_torch.models.layers import tree_map
    from repro_torch.train.optimizer import adamw_update

    grads = tree_map(torch.zeros_like, params)
    opt_ms = time_warm_ms(torch, lambda: adamw_update(grads, state, params, opt_cfg), batch=1, reps=3)
    del grads
    res = dict(
        layers=f"{cfg.n_layers} of {full.n_layers}", parameters=n_params, losses=out["losses"],
        grad_norms=out["grad_norms"], step_s=out["step_s"], step_ms_median=step_s * 1e3,
        changed_share=changed,
        tokens_per_s=tokens / step_s, model_flops=model_flops, mfu=mfu, peak_gib=peak,
        device_busy_share=prof["device_busy_share"], profiled_step_wall_ms=prof["traced_wall_ms"],
        profiled_step_device_ms=prof["device_ms"], top_kernels=prof["top_kernels"][:6],
        device_ms_by_kind=by_kind, adamw_update_ms=opt_ms,
        launches=launches, flash_launches_by_variant=flash_by_variant, card=smi,
    )
    print(f"  qwen3-8b train ({res['layers']} layers, {n_params / 1e9:.3f} B parameters, bf16, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_MICROBATCHES} microbatches, remat) on {smi}: losses "
          f"{json.dumps([round(x, 4) for x in out['losses']])}, step ms {json.dumps([round(1e3 * x, 1) for x in out['step_s']])}, "
          f"median of steps 2-{TRAIN_STEPS} {step_s * 1e3:.1f} ms, {tokens / step_s:.0f} tokens/s, "
          f"model FLOPs {model_flops / 1e12:.2f} T a step, MFU {mfu:.4f} of {BF16_FLOPS_PER_S / 1e12:.0f} TFLOPS, "
          f"peak {peak:.2f} GiB, device busy share of one step {prof['device_busy_share']} "
          f"({prof['device_ms']} of {prof['traced_wall_ms']:.1f} ms), device ms by kind "
          f"{json.dumps(by_kind)}, one adamw_update {opt_ms:.1f} ms, top kernels "
          f"{json.dumps(prof['top_kernels'][:6])}", flush=True)
    del model, params, state, out, step_fn, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


def run_train_phase(torch, np, smi):
    """Phase train: smoke parity card against CPU, the smoke loop and resume
    on the card, then full-width Qwen3-8B at 12 of 36 layers (the kernels at
    the training shapes run in phase kernels, where torch.profiler's traces
    still hold their device events: late in a long process they come back
    empty). Returns (the train path's launches, the full-width numbers)."""
    run_train_parity(torch, np)
    run_train_loop_checks(torch)
    full = run_full_width_train(torch, np, smi)
    return full["launches"], full


def main() -> int:
    sweep = sys.argv[1:] == ["--sweep"]
    train_only = sys.argv[1:] == ["--train"]
    if sys.argv[1:] and not (sweep or train_only):
        print("usage: chip_smoke.py [--sweep | --train]", file=sys.stderr)
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
    check_backward_build(build)
    phase("build", t0)

    if sweep:
        t0 = time.perf_counter()
        res = run_sweep(torch, np)
        phase("sweep", t0)
        print(json.dumps({"sweep": res, "device": smi}))
        return 0
    if train_only:
        import torch.nn.functional as F

        t0 = time.perf_counter()
        rows = run_train_kernel_checks(torch, np, F)
        _, res = run_train_phase(torch, np, smi)
        phase("train", t0)
        print(json.dumps({"train": res, **rows}))
        return 0

    t0 = time.perf_counter()
    kres = run_kernel_checks(torch, np)
    phase("kernels", t0)

    t0 = time.perf_counter()
    run_parity(torch, np)
    run_fleet_parity(torch, np)
    run_sampler_parity(torch, np)
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
    from repro_torch.obs import Observation

    launches, by_variant, stats = {}, {}, {}
    # the greedy serves run with observe=None: the tripwire counts every
    # obs callback, and there must be none
    calls = []
    Observation.tripwire = staticmethod(lambda: calls.append(1))
    try:
        for layout in ("paged", "dense"):
            eng, launches[layout], by_variant[layout], stats[layout] = run_serve(
                torch, model, params, layout)
            del eng                   # free this layout's KV before the next one
            torch.cuda.empty_cache()
    finally:
        Observation.tripwire = None
    print(f"  tripwire: the greedy paged and dense serves ran {len(calls)} obs callbacks", flush=True)
    check(not calls, f"observe=None serves ran {len(calls)} obs callbacks")
    eng, launches["top_p"], by_variant["top_p"] = run_top_p_serve(torch, model, params, stats["paged"])
    del eng
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

    t0 = time.perf_counter()
    family_launches, family_by_variant = run_family_serves(torch)
    launches.update(family_launches)
    by_variant.update(family_by_variant)
    phase("family", t0)

    t0 = time.perf_counter()
    launches["train"], train_res = run_train_phase(torch, np, smi)
    by_variant["train"] = train_res["flash_launches_by_variant"]
    phase("train", t0)

    kernels = []
    for kname, key, label, count, layout, source, replaces in KERNELS:
        r = kres[(key, label)]
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[layout][count],
            "launches_by_path": {lay: launches[lay][count] for lay in launches},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **({"launches_by_variant": by_variant[layout],
                "ms_by_tile": r.get("ms_by_tile")} if count == "flash_attention" else {}),
            **({k: r[k] for k in ("rel_err", "forward_lse_ms", "forward_backward_ms", "library_backend",
                                  "library_forward_backward_ms", "design_floor_ms", "ms_by_plan", "pass_us",
                                  "plan")}
               if key == "flash_attention_backward" else {}),
            **({"microbatch": {k: r["microbatch"][k] for k in (
                "ms", "ms_by_plan", "pass_us", "plan", "bound_ms", "design_floor_ms", "library_ms",
                "library_backend", "forward_backward_ms", "library_forward_backward_ms")}}
               if key == "flash_attention_backward" else {}),
        })
    print(json.dumps({"train": train_res}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
