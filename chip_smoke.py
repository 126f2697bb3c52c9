#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py            # the smoke run below
    python3 chip_smoke.py --sweep    # kernel plans and L2 states, timed
    python3 chip_smoke.py --train    # the training path's kernels and phases train and dp alone
    python3 chip_smoke.py --profiler-cost   # train steps before and after profiler sessions

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
             version and SDPA's fastest forward; the same for the backward
             and the forward at RecurrentGemma-9B's attention (B 1 x 4096,
             16/1 heads, head_dim 256, window 2048, bf16: the
             two-warpgroup wgmma body, every sub-group count of the dK/dV
             grid checked and timed beside the plan's; SDPA under the
             window's boolean mask, the math backend included) and for the
             backward at Whisper-small's encoder (B 8 x 256, 12 heads of
             64, no mask); the RG-LRU backward (rglru_bwd.cu) at
             RecurrentGemma-9B's training shape (1, 4096, 4096) float32,
             chained across two calls, against its plain reverse scan, its
             device kernels those of its scan_plan, two calls bit-equal,
             timed beside its bound (bytes) and the design's floor, and
             kernel 4 timed at that shape; and kernels 2 and 3 at
             Whisper-small's serving shapes (the encoder's 8 x 1500
             frames, no mask; decode over 1500 cross keys);
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
             Observation state; the float32 smoke RecurrentGemma, xLSTM
             (128 tokens: two time chunks) and Whisper (weights
             perturbed): each one's loss and every gradient leaf (remat)
             card vs CPU (RecurrentGemma's through
             the RG-LRU and flash backward kernels, Whisper's through the
             flash backward, launches exact), xLSTM's ragged prefill and
             Whisper's prefill then greedy decode steps card vs CPU;
5. serve   — full-size Qwen3-8B (36 layers, bf16, random weights from a seed)
             behind the port's Engine, twice on the same weights and the same
             16 GSM8K-shaped requests (outputs capped at 128) under hybrid
             scheduling: the paged layout with mixed steps, then the dense
             layout with whole-prompt prefill stages and fused decode; checks
             the trace, the budgets, the token ids and that each kernel ran
             exactly as often as each schedule implies (a replay counts the
             launches its graph holds), every flash launch on the
             tensor-core body, and that these greedy serves, run with
             observe=None, made no obs callback (Observation.tripwire). Every
             engine of this phase and the next (fleet replicas too) captures
             its reachable dispatch keys in ``warm_serving_shapes`` and
             replays one graph a stage: captures, capture seconds, replays
             and graph pool MiB are printed, and the replays must equal the
             trace's stages and the captures the reachable keys. Then
             (phase replays) each captured key of Qwen3-8B's engines, paged
             and dense, greedy and top-p, is replayed against a direct model
             call on the same inputs over a copy of the same mid-serve
             state: token block, emitted counts, active mask, last tokens
             (or sampled tokens, or logits) and the pool bit-equal. Then
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
             prefill and decode_step (launch.generate.WaveServer, each decode
             step a replay of the wave size's graph; the Engine does not
             take it); checks the budgets, the token ids, that the first
             wave's tokens equal direct calls', that the replays equal the
             decode steps, and that the scan ran in each of the 26 recurrent
             layers and kernels 2 and 3 in each of the 12 attention layers
             of every prefill and step;
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
             memory; then one fused decode stage under the profiler, called
             directly and replayed from its graph, whose device busy share
             says whether the device or the host paces it; and, on
             LLaMA-65B's weights before they are freed,
   paper   — the paper's experiment: 32 requests drawn from its GSM8K
             moments with the outputs over 4 (capped at 128) on 8 slots of
             the dense layout, served under each of the four configurations
             of core.simulate (baseline, offline, online, hybrid) through
             the serve's gates, each mode's online profiler starting from
             the same prior and refitting (at least once); each mode's
             utilization, makespan, tok/s, prefill stages, decode rounds and
             prefill stall printed beside the cost model it fitted, the
             ported simulator's utilization and makespan for the same
             requests under that model, the served / simulated ratio and
             the Eq. 32 lower bound (the ranking and the ratio are not
             gated); then xLSTM-350M and Whisper-small whole, each the
             serve's 16 requests in two waves of 8 slots through
             launch.generate.WaveServer (Whisper: prompts of 64 tokens and
             1500 seeded frames each), budgets, one capture and a replay a
             decode step, launches exact (Whisper: kernels 2 and 3; xLSTM
             none, its cells are plain PyTorch), the first wave equal to
             direct calls; tok/s and ms a decode step printed;
7. train   — run right after build, so that its timed steps follow no
             torch.profiler session (Qwen3-8B's profiled step runs last,
             profile_train_step): the training
             path (repro_torch.train, its kernels checked in phase
             kernels): the float32 smoke Qwen3, OLMoE, Qwen2-VL and Mixtral, card
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
             beside the card; then RecurrentGemma-9B at its published
             widths cut to 8 of 38 layers (two periods and the tail) at
             batch 1 x 4096 (past its window of 2048), xLSTM-350M whole at
             4 x 128 (two time chunks) and Whisper-small whole at 8 x 256,
             remat, lr 1e-4 warmup 2, a few steps of train() each: losses
             finite, grad_norm > 0, launches exact (the RG-LRU and flash
             backward kernels once a layer a step), every flash backward
             launch of these bf16 runs on the tensor-core body,
             RecurrentGemma's step printed beside its time before the
             head_dim 256 wgmma body and the chunked scan, and from the same
             init 3 steps on the first batch alone bring its loss below the
             initial one; losses, step ms, tokens/s and peak memory
             printed;
8. dp      — right after train: a one-rank NCCL group (a FileStore in a
             temp dir) and a gloo group beside it. Qwen3-8B at its
             published widths cut to 8 of 36 layers, bf16, global batch
             1 x 2048, remat, lr 1e-3 warmup 1, 3 steps each of
             make_train_step, the plain make_dp_train_step (parameters and
             loss bit-equal to train_step's after each step) and the
             compressed one (its first loss the plain one's, losses
             falling, every leaf within 9e-3 of the plain run's, every
             leaf's error feedback within half its int8 scale at every
             step; its loss gap printed beside the reference's bar of
             0.05, which the reference's own step misses at this
             vocabulary); flash launches exact in each run; step ms,
             reduction ms (CUDA events), bytes all-reduced and peak memory
             printed. Then the float32 smoke Granite's compressed and
             plain DP steps on the card's NCCL group against the gloo
             group on the CPU, and reshard_restore of a smoke Qwen3
             checkpoint onto a (1, 1) data/model mesh on the card
             (DTensors bit-equal to the saved tree); the groups are
             destroyed at the end.
9. dryrun  — last: the dry-run (repro_torch.launch.dryrun) held to the
             card. Two steps that fit one card are traced on a world of
             one (fake CUDA tensors) and then run for real: Qwen3-8B's
             decode_step at B 8 against a dense cache of 32,768 (36 layers,
             every row full) and phase train's step (Qwen3-8B at 12 of 36
             layers, 2 x 2048, 2 microbatches, remat). The trace's peak
             must be within DRYRUN_PEAK_TOL of max_memory_allocated over
             the step (both above what was allocated before the step's
             arguments), its registered FLOPs must equal FlopCounterMode's
             count over the real step, and its custom-op calls the
             kernels' launch counts; the step's ms is printed beside the
             roofline's bound (no gate). DRYRUN_CELLS, one cell per
             family, are traced meanwhile on the fake 16 x 16 world in a
             subprocess that sees no card: each must be ok, its trace
             seconds and per-device peak printed.

Then one JSON line of the train phase's numbers, one of phase dp's, one of phase paper's
(each mode's served and simulated numbers and fitted cost model, with the
card's name and power limit), one JSON line naming every
ported kernel (kernel 2 once per entry, and kernels 2 and 3 again at
RecurrentGemma's shapes, kernels 1-3 again at LLaMA-65B's and
StarCoder2-7B's, the flash backward and kernel 2's dense entry at the
training shape, the RG-LRU backward, the flash backward and kernels 4
and 2 at RecurrentGemma-9B's training shapes, kernels 2 and 3 on
Whisper-small's serve and the flash backward on its training run, and
kernels 2 and 3 at LLaMA-65B's on phase paper's four serves) with its launches on each path (flash's also by device
body) and this run's times, one JSON line of phase dryrun's numbers (with
the card's name and power limit), and, last,
{"ok": true, "device": {...}}.
Any failed check raises, so the script exits non-zero and prints no result.

``--train`` builds the kernels and runs phases 7 (train) and 8 (dp) and
the training path's kernel checks alone, printing their numbers as one
JSON line.

``--profiler-cost`` builds the kernels and times Whisper-small's and
Qwen3-8B's train steps before and after 300 torch.profiler sessions in
the CUPTI mode the environment sets (TEARDOWN_CUPTI: 1 tears CUPTI down
after each session, 0 keeps it attached, the default here); run both
modes in turns in one call.

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
import os
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


def device_kernel_us(torch, fn, attempts=10, expect=None):
    """(name, device µs) of each device kernel one call of ``fn`` runs, in
    the order they started (torch.profiler). A trace that holds no device
    event at all missed the call (on the card a process's traces now and
    then come back empty, several in a row), and one that holds fewer than
    ``expect`` kernels (the caller's plan) dropped some, so the call is
    traced again, after a pause that grows with each retry, up to
    ``attempts`` times; every retry is printed. The caller still holds the
    last trace's kernels to its plan."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        # the device's timestamps, read against the host's clock, drift
        # early over a long process, and the profiler drops a kernel that
        # seems to start before its session: launch after a pause (and end
        # after one), doubled at each retry
        pause = 0.01 * 2 ** (attempt - 1)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(pause)
            fn()
            torch.cuda.synchronize()
            time.sleep(pause)
        events = sorted((e for e in prof.events() if e.device_type.name == "CUDA"),
                        key=lambda e: e.time_range.start)
        kernels = [(e.name, e.time_range.elapsed_us()) for e in events
                   if "emcpy" not in e.name and "emset" not in e.name]
        if events and (expect is None or len(kernels) >= expect):
            break
        print(f"  device_kernels: trace {attempt} of {attempts} held "
              + (f"{len(kernels)} of {expect} device kernels" if events else "no device event"), flush=True)
        time.sleep(0.25 * attempt)
    return kernels


def device_kernels(torch, fn, attempts=10):
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


def dense_flash_bound(q, k, causal=True, window=0):
    b, h, s, d = q.shape
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()   # q, out, k, v
    pairs = attention_pairs(s, window) if causal else s * k.shape[2]
    flops = 4 * d * h * b * pairs                                 # the visible pairs
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
    results.update(run_whisper_kernel_checks(torch, np, F, flush))
    for key, row in run_train_kernel_checks(torch, np, F).items():
        results[key if isinstance(key, tuple) else (key, "qwen3-8b train")] = row
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
        if (b, s, r) == (8, 1, 4096):
            decode = (a, x, h0)
    a, x = torch.sigmoid(torch.randn(1, 256, 128, device="cuda", generator=g)), \
        torch.randn(1, 256, 128, device="cuda", generator=g)
    full, hf_full = rglru.rglru_scan(a, x)
    _, hf1 = rglru.rglru_scan(a[:, :128], x[:, :128])
    h2, hf2 = rglru.rglru_scan(a[:, 128:], x[:, 128:], hf1)
    torch.cuda.synchronize()
    err = max(max_err(torch, h2, full[:, 128:], RGLRU_TOL), max_err(torch, hf2, hf_full, RGLRU_TOL))
    print(f"  rglru_scan chained across two calls: max_abs_err={err:.4g}", flush=True)
    # the prefill's and a decode step's shapes: the plan's device kernels,
    # two calls equal, and at the model's decays both plain versions
    for key, (a, x, h0), what in ((("rglru_scan", label), timed, "wave prefill"),
                                  (("rglru_scan", f"{label} decode"), decode, "decode step")):
        plan_row = check_rglru_forward(torch, a, x, h0, model_decays(torch, *a.shape, g), what)
        results[key] = dict(
            max_abs_err=max(errs[tuple(a.shape)], plan_row.pop("model_err")), **plan_row,
            ms=time_ms(torch, lambda: rglru.rglru_scan(a, x, h0), flush),
            plain_ms=time_ms(torch, lambda: rglru.rglru_scan_plain(a, x, h0), flush),
            library_ms=None,
            **dict(zip(("bound_ms", "bound_by"), rglru_bound(a))),
        )
        print(f"  rglru_scan {tuple(a.shape)} ({what}) timed: {results[key]['ms']:.4f} ms, bound "
              f"{results[key]['bound_ms']:.4f} ms ({results[key]['bound_by']})", flush=True)
    (results[("rglru_scan_backward", "recurrentgemma-9b train")],
     results[("rglru_scan", "recurrentgemma-9b train")]) = check_rglru_backward(torch, flush)
    return results


WHISPER_FRAMES = 1500             # Whisper-small's encoder positions (30 s of audio)


def run_whisper_kernel_checks(torch, np, F, flush):
    """Kernels 2 and 3 at Whisper-small's serving shapes (12 heads of 64, no
    GQA, 8 slots): kernel 2's dense entry at the encoder's self-attention
    (8 x 1500 frames, no mask; the wave's decoder self- and
    cross-attention launches are shorter) and kernel 3 over the 1500 cross
    keys of every slot (the decoder's self rows are shorter), each against
    its plain version and timed beside its bound and SDPA on the same
    inputs."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    label, (h, kv, d) = "whisper-small", (12, 12, 64)
    results = {}
    q, k, v = dense_prefill_case(torch, h, kv, d, 8, WHISPER_FRAMES)
    out = fa.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    err = max_err(torch, out, fa.flash_attention_plain(q, k, v, causal=False), KERNEL_TOL["bfloat16"])
    qs, ks, vs = (x.contiguous() for x in (q, k, v))
    results[("flash_attention_dense", label)] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: fa.flash_attention(q, k, v, causal=False), flush),
        plain_ms=time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, causal=False), flush, iters=5,
                         warmup=1),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(qs, ks, vs), flush),
        **dict(zip(("bound_ms", "bound_by"), dense_flash_bound(q, k, causal=False))),
    )
    print(f"  flash_attention dense [{label}] encoder (8, 12, {WHISPER_FRAMES}, 64), no mask: max_abs_err={err:.4g}",
          flush=True)
    del q, k, v, qs, ks, vs, out
    q, k, v, lengths = dense_decode_case(torch, np, h, kv, d, torch.bfloat16, WHISPER_FRAMES)
    lengths = torch.full_like(lengths, WHISPER_FRAMES)           # every slot reads all the frames
    out = da.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    err = max_err(torch, out, da.decode_attention_plain(q, k, v, lengths), KERNEL_TOL["bfloat16"])
    kname = check_one_kernel_and_repeat(
        torch, f"decode_attention [{label}]", lambda: da.decode_attention(q, k, v, lengths), out)
    print(f"  decode_attention [{label}] cross keys ({WHISPER_FRAMES}): max_abs_err={err:.4g}, "
          f"{dense_plan(torch, da, q, k)}, one device kernel ({kname[:60]}), two calls equal", flush=True)
    qs, ks, vs = q[:, :, None], k.contiguous(), v.contiguous()
    results[("decode_attention", label)] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: da.decode_attention(q, k, v, lengths), flush),
        plain_ms=time_ms(torch, lambda: da.decode_attention_plain(q, k, v, lengths), flush),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(qs, ks, vs), flush),
        **dict(zip(("bound_ms", "bound_by"), dense_decode_bound(q, k, lengths))),
    )
    return results


def model_decays(torch, b, s, r, gen):
    """RG-LRU decays in RecurrentGemma's trained range, float32 (b, s, r) on
    the card: a_t = base^{r_t}, with base (= sigma(Lambda)^c) uniform in
    [0.9, 0.999] a channel, Griffin's init of Lambda, and the recurrence
    gate r_t = sigmoid(N(0, 1)). A chunk of 128 steps passes on about 1e-3
    to 0.94 of the carry it receives, so every chunk's carry shows."""
    base = torch.rand((1, 1, r), device="cuda", generator=gen) * 0.099 + 0.9
    return base ** torch.sigmoid(torch.randn((b, s, r), device="cuda", generator=gen))


def check_rglru_forward(torch, a, x, h0, model_a, what):
    """Kernel 4 (csrc/rglru.cu) on ``a``, ``x``, ``h0``: a call runs exactly
    the device kernels of its scan_plan (each one's device µs printed), two
    calls give the same bits; on the model's decays ``model_a`` (same x and
    h0) it is held to the sequential plain version and to the plain version
    in its chunked order, to RGLRU_TOL of the largest |h| (over memories of
    ~1000 steps its fma and the plain versions' multiply-then-add round
    apart by more than RGLRU_TOL of a small |h|). Returns the plan, the
    device µs and that error (``model_err``)."""
    from repro_torch.kernels import rglru

    plan = rglru.scan_plan(*a.shape)
    call = lambda: rglru.rglru_scan(a, x, h0)
    passes = device_kernel_us(torch, call, expect=len(plan.kernels))
    names = [n for n, _ in passes]
    check(len(names) == len(plan.kernels) and all(k_ in n for k_, n in zip(plan.kernels, names)),
          f"rglru_scan {tuple(a.shape)} ran {names}, its plan {plan.kernels}")
    once, again = call(), call()
    check(all(bool(torch.equal(u, w)) for u, w in zip(once, again)), f"rglru_scan {tuple(a.shape)}: two calls differ")
    out = rglru.rglru_scan(model_a, x, h0)
    torch.cuda.synchronize()
    err = max(max_err(torch, u, v, RGLRU_TOL * (1 + float(v.abs().max())))
              for ref in (rglru.rglru_scan_plain(model_a, x, h0),
                          rglru.rglru_scan_chunked_plain(model_a, x, h0, plan.chunk))
              for u, v in zip(out, ref))
    print(f"  rglru_scan {tuple(a.shape)} ({what}): the plan's device kernels ({plan.n_chunks} chunks of "
          f"{plan.chunk}), two calls equal; device µs "
          f"{json.dumps([[n.split('(')[0].split('::')[-1], round(us, 2)] for n, us in passes])}; at the "
          f"model's decays max_abs_err={err:.4g} against both plain versions (to {RGLRU_TOL} of the largest "
          f"|h|)", flush=True)
    return dict(plan=plan._asdict(), pass_us=[[n, us] for n, us in passes], model_err=err)


def check_rglru_backward(torch, flush):
    """The RG-LRU backward (csrc/rglru_bwd.cu) at RecurrentGemma-9B's
    training shape (1, 4096, 4096) float32, decays in the model's range
    (``model_decays``: the slowest channels carry over all 32 chunks),
    from the states of two chained forward calls (the second seeded with
    the first's final state), each call's gradients against the plain
    reverse scan; the gradient the first call's final state receives is
    the second's dh0. A call runs exactly
    the device kernels of its scan_plan, in order (each one's device µs
    printed), and two calls give the same bits. Timed beside its bound
    (bytes: a, h and g read, da and dx written, once), the design's floor
    (a and g read twice) and its plain version; no library call computes
    it. Kernel 4 (the forward) timed at the same shape, the training
    path's. Returns the backward's row and the forward's."""
    from repro_torch.kernels import rglru, rglru_bwd

    b, s, r = RG_TRAIN_SCAN
    g = torch.Generator(device="cuda").manual_seed(11)
    a = model_decays(torch, b, s, r, g)
    x, gg = (torch.randn(b, s, r, device="cuda", generator=g) for _ in range(2))
    h0, g_fin = (torch.randn(b, r, device="cuda", generator=g) for _ in range(2))
    cut = s // 2
    h1, f1 = rglru.rglru_scan(a[:, :cut], x[:, :cut], h0)
    h2, _ = rglru.rglru_scan(a[:, cut:], x[:, cut:], f1)
    a2, gg2 = a[:, cut:].contiguous(), gg[:, cut:].contiguous()
    second = rglru_bwd.rglru_scan_backward(a2, h2, f1, gg2, g_fin)
    a1, gg1 = a[:, :cut].contiguous(), gg[:, :cut].contiguous()
    first = rglru_bwd.rglru_scan_backward(a1, h1, h0, gg1, second[2])
    torch.cuda.synchronize()
    ref2 = rglru_bwd.rglru_scan_backward_plain(a2, h2, f1, gg2, g_fin)
    ref1 = rglru_bwd.rglru_scan_backward_plain(a1, h1, h0, gg1, ref2[2])
    err = max(max_err(torch, u, v, RGLRU_TOL * (1 + float(v.abs().max())))
              for u, v in zip(first + second, ref1 + ref2))
    plan = rglru_bwd.scan_plan(b, s, r)
    # the carry is of leading order across chunks: a chunk's product of a,
    # and in the slowest channels the product over every step
    chunk_prod = a[:, :plan.chunk].prod(1)
    whole = float(a.prod(1).max())
    check(whole > 1e-2, f"rglru_scan_backward: the decays keep at most {whole:.3g} of a carry over "
          f"{s} steps; the chunks' carries would not show")
    print(f"  rglru_scan_backward {(b, s, r)} chained across two calls (cut at {cut}): "
          f"max_abs_err={err:.4g}; decays a = base^r (base U[0.9, 0.999] a channel, r = sigmoid(N(0, 1))): "
          f"a chunk of {plan.chunk} keeps {float(chunk_prod.min()):.3g} to {float(chunk_prod.max()):.3g} of its "
          f"carry, all {s} steps at most {whole:.3g}", flush=True)
    h, _ = rglru.rglru_scan(a, x, h0)
    call = lambda: rglru_bwd.rglru_scan_backward(a, h, h0, gg, g_fin)
    passes = device_kernel_us(torch, call, expect=len(plan.kernels))
    names = [n for n, _ in passes]
    check(len(names) == len(plan.kernels) and all(k_ in n for k_, n in zip(plan.kernels, names)),
          f"rglru_scan_backward ran {names}, its plan {plan.kernels}")
    once, again = call(), call()
    check(all(bool(torch.equal(u, w)) for u, w in zip(once, again)), "rglru_scan_backward: two calls differ")
    del once, again
    nbytes = 5 * a.numel() * 4 + 3 * b * r * 4
    row = dict(
        max_abs_err=err, plan=plan._asdict(), pass_us=[[n, us] for n, us in passes],
        ms=time_ms(torch, call, flush),
        plain_ms=time_ms(torch, lambda: rglru_bwd.rglru_scan_backward_plain(a, h, h0, gg, g_fin), flush,
                         iters=3, warmup=1),
        library_ms=None, bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_by="bytes",
        design_floor_ms=1e3 * (nbytes + 2 * a.numel() * 4) / HBM_BYTES_PER_S,
    )
    print(f"  rglru_scan_backward {(b, s, r)}: the plan's {len(names)} device kernels ({plan.n_chunks} chunks "
          f"of {plan.chunk}), two calls equal; device µs a kernel "
          f"{json.dumps([[n.split('(')[0].split('::')[-1], round(us, 1)] for n, us in passes])}", flush=True)
    print(f"  rglru_scan_backward {(b, s, r)} timed: {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"(bytes, {row['bound_ms'] / row['ms']:.2f} of it), the design's floor {row['design_floor_ms']:.4f} "
          f"ms, plain {row['plain_ms']:.4f} ms", flush=True)
    # kernel 4 at the same shape: at the model's decays held as the
    # backward is, to RGLRU_TOL of the largest magnitude (over memories of
    # ~1000 steps its fma and the plain version's multiply-then-add round
    # apart by more than RGLRU_TOL of a small |h|); at sigmoid(N(0, 1))
    # decays element by element, as phase kernels holds it
    plan_row = check_rglru_forward(torch, a, x, h0, a, "the training path's forward")
    model_err = plan_row.pop("model_err")
    fast = torch.sigmoid(torch.randn(b, s, r, device="cuda", generator=g))
    ref, ref_hf = rglru.rglru_scan_plain(fast, x, h0)
    out, hf = rglru.rglru_scan(fast, x, h0)
    torch.cuda.synchronize()
    elem_err = max(max_err(torch, out, ref, RGLRU_TOL), max_err(torch, hf, ref_hf, RGLRU_TOL))
    del fast, ref, ref_hf, out, hf
    print(f"  rglru_scan {(b, s, r)}: max_abs_err={model_err:.4g} at the model's decays (to {RGLRU_TOL} of "
          f"the largest |h|, both plain versions), {elem_err:.4g} at sigmoid(N(0, 1)) decays (element by "
          f"element)", flush=True)
    forward = dict(
        max_abs_err=max(model_err, elem_err), **plan_row,
        ms=time_ms(torch, lambda: rglru.rglru_scan(a, x, h0), flush),
        plain_ms=time_ms(torch, lambda: rglru.rglru_scan_plain(a, x, h0), flush, iters=3, warmup=1),
        library_ms=None, **dict(zip(("bound_ms", "bound_by"), rglru_bound(a))),
    )
    print(f"  rglru_scan {(b, s, r)} (the training path's forward) timed: {forward['ms']:.4f} ms, bound "
          f"{forward['bound_ms']:.4f} ms ({forward['bound_by']}), plain {forward['plain_ms']:.4f} ms", flush=True)
    return row, forward


# --------------------------------------------------------------------------- #
# Small-model parity: kernels on the card against plain versions on the CPU   #
# --------------------------------------------------------------------------- #
def _card_and_cpu(torch, cfg, perturb=False):
    """The same float32 model (of any family) and weights on the CPU and on
    the card; with ``perturb``, every leaf plus seeded noise (0.1 x its
    spread, 0.1 for a constant leaf), so zero biases and unit scales leave
    their init."""
    from repro_torch.models.layers import tree_map
    from repro_torch.models.registry import get_model

    cpu = get_model(cfg, device="cpu")
    params_cpu = cpu.init_params(seed=0)
    if perturb:
        gen = torch.Generator().manual_seed(1)

        def bump(x):
            spread = float(x.float().std()) if x.numel() > 1 else 0.0
            noise = torch.randn(x.shape, generator=gen)
            return (x.float() + 0.1 * (spread or 1.0) * noise).to(x.dtype)

        params_cpu = tree_map(bump, params_cpu)
    return (cpu, params_cpu), (get_model(cfg, device="cuda"), tree_map(lambda x: x.cuda(), params_cpu))


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

    cfg = dataclasses.replace(get_smoke_config("recurrentgemma_9b"), dtype="float32")
    lengths = np.array([12, 9, 7], np.int32)
    tokens = np.random.default_rng(1).integers(1, cfg.vocab_size, size=(3, 12)).astype(np.int32)
    tokens[np.arange(12)[None, :] >= lengths[:, None]] = 0

    def prefill(m, p):
        t = lambda x: torch.from_numpy(x).to(m.device)
        return m.prefill(p, t(tokens), m.cache_init(3, 32), lengths=t(lengths))

    _serve_card_and_cpu(torch, _card_and_cpu(torch, cfg), prefill, steps,
                        "smoke recurrentgemma (ring of 8 wrapped)")


def _grads_card_and_cpu(torch, pair, batch, what):
    """Loss and every gradient leaf (remat on) on the CPU and on the card:
    the loss within 1e-5, each leaf within TRAIN_GRAD_TOL of its largest
    magnitude. Returns the card's launches by kernel."""
    from repro_torch.models.layers import _leaves, tree_map

    kernels = kernel_modules()
    outs = []
    for model, params in pair:
        tree = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
        for mod in kernels.values():
            mod.reset_launch_count()
        loss = model.loss(tree, {k: v.to(model.device) for k, v in batch.items()}, remat=True)
        loss.backward()
        outs.append((float(loss.detach()), {k: v.grad.cpu() for k, v in _leaves(tree)}))
    launches = {name: mod.launch_count for name, mod in kernels.items()}
    err_loss = abs(outs[0][0] - outs[1][0])
    check(err_loss <= 1e-5, f"{what} loss: card vs CPU {err_loss:.3g}")
    worst = max((float((outs[1][1][k] - g).abs().max() / g.abs().max().clamp_min(1e-30)), k)
                for k, g in outs[0][1].items())
    check(worst[0] <= TRAIN_GRAD_TOL, f"{what} gradient {worst[1]}: card vs CPU {worst[0]:.3g}")
    print(f"  {what} float32 loss card vs CPU: {err_loss:.3g}; every gradient leaf within "
          f"{worst[0]:.3g} of its largest magnitude (worst {'/'.join(worst[1])}); card launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}", flush=True)
    return launches


def _serve_card_and_cpu(torch, pair, prefill, steps, what):
    """``prefill(model, params) -> (logits, cache)`` then greedy decode steps
    on the CPU and on the card: logits within LOGITS_TOL, tokens equal."""
    from repro_torch.serving.sampler import greedy

    outs = []
    for model, params in pair:
        logits, cache = prefill(model, params)
        dec, toks = [], []
        cur = greedy(logits)
        for _ in range(steps):
            step_logits, cache = model.decode_step(params, cur, cache)
            cur = greedy(step_logits)
            dec.append(step_logits)
            toks.append(cur)
        outs.append((logits.cpu(), torch.stack(dec).cpu(), torch.stack(toks).cpu()))
    for a, b, kind in zip(outs[0][:2], outs[1][:2], ("prefill", "decode")):
        err = float((a - b).abs().max())
        check(err <= LOGITS_TOL, f"{what} {kind} logits: card vs CPU max err {err:.3g}")
        print(f"  {what} float32 {kind} logits card vs CPU: max_abs_err={err:.3g}")
    check(bool(torch.equal(outs[0][2], outs[1][2])), f"{what}: greedy tokens differ card vs CPU")
    print(f"  {what} float32 {steps} decode steps, tokens card == CPU: True", flush=True)


def run_new_family_parity(torch, np, steps=8):
    """The float32 smoke RecurrentGemma, xLSTM and Whisper (every weight
    perturbed off its init) on the card against the CPU: RecurrentGemma's
    loss and every gradient (a sequence of 16 past its window of 8; the
    RG-LRU and flash backward kernels launched once a layer); xLSTM's
    ragged prefill and Whisper's prefill (24 seeded frames) then greedy
    decode steps; and one xLSTM loss (128 tokens: two time chunks, the
    state carried between their checkpoints) and one Whisper loss with
    every gradient."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.train.train_loop import TrainConfig, synthetic_batches

    pairs = {}
    for arch in ("recurrentgemma_9b", "xlstm_350m", "whisper_small"):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        pairs[arch] = _card_and_cpu(torch, cfg, perturb=True)
        seq = 128 if arch == "xlstm_350m" else 16
        batch = next(synthetic_batches(cfg, TrainConfig(batch=2, seq=seq, seed=3)))
        launches = _grads_card_and_cpu(torch, pairs[arch], batch, f"smoke {arch}")
        model = pairs[arch][1][0]
        if arch == "recurrentgemma_9b":
            want = {"rglru_scan": 2 * model.n_rec, "rglru_scan_backward": model.n_rec,
                    "flash_attention": 2 * model.n_periods, "flash_attention_backward": model.n_periods}
            check_launches(f"smoke {arch} loss and gradients (remat)", launches, want)
        if arch == "whisper_small":
            n = cfg.encoder_layers + 2 * cfg.n_layers
            check_launches(f"smoke {arch} loss and gradients (remat)", launches,
                           {"flash_attention": 2 * n, "flash_attention_backward": n})
    lengths = np.array([12, 9, 7], np.int32)
    tokens = np.random.default_rng(1).integers(1, 256, size=(3, 12)).astype(np.int32)
    tokens[np.arange(12)[None, :] >= lengths[:, None]] = 0

    def xlstm_prefill(m, p):
        t = lambda x: torch.from_numpy(x).to(m.device)
        return m.prefill(p, t(tokens), m.cache_init(3), lengths=t(lengths))

    frames = np.random.default_rng(2).standard_normal((3, 24, 64)).astype(np.float32)

    def whisper_prefill(m, p):
        t = lambda x: torch.from_numpy(x).to(m.device)
        return m.prefill(p, t(tokens[:, :7]), m.cache_init(3, 32, enc_len=24), patch_embeds=t(frames))

    _serve_card_and_cpu(torch, pairs["xlstm_350m"], xlstm_prefill, steps, "smoke xlstm (ragged 12/9/7)")
    _serve_card_and_cpu(torch, pairs["whisper_small"], whisper_prefill, steps, "smoke whisper")


# --------------------------------------------------------------------------- #
# Serve                                                                       #
# --------------------------------------------------------------------------- #
def graph_stats(what, dispatches):
    """Print one owner's captured dispatches: captures, capture seconds,
    replays and its graph pool."""
    st = dispatches.stats()
    print(f"  {what} graphs: {st['captures']} captures in {st['capture_s']:.3f} s, "
          f"{st['replays']} replays, pool {st['pool_mib']:.3f} MiB", flush=True)
    return st


def check_graphs(what, eng, n_stages, replays_before=0):
    """Every stage of the serve replayed one captured dispatch, every
    dispatch was captured before the serve (``warm_serving_shapes``), and
    the engine captured exactly the keys it can reach."""
    st = graph_stats(what, eng.graphs)
    check(eng.graphs.captures == len(eng.graphs.keys) and eng.graphs.keys == eng.serving_keys(),
          f"{what}: captured {sorted(eng.graphs.keys)} of {sorted(eng.serving_keys())}")
    check(st["replays"] - replays_before == n_stages,
          f"{what}: {st['replays'] - replays_before} replays for {n_stages} stages")
    return st


def kernel_modules():
    """Each ported kernel's wrapper module by launch-count name."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import rglru, rglru_bwd

    return {"paged_decode_attention": pda, "flash_attention": fa, "decode_attention": da,
            "rglru_scan": rglru, "flash_attention_backward": fb, "rglru_scan_backward": rglru_bwd}


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


def run_serve(torch, model, params, layout, sampler=None, obs=None, reqs=None, path=None,
              mode="hybrid"):
    """Serve the GSM8K-shaped closed-loop workload (``reqs``, by default the
    16 requests of ``profile_step.serve_workload``) through the port's Engine
    under one of the paper's four configurations (``mode``; hybrid unless
    asked) as launch/serve.py builds it, on the paged layout (mixed steps)
    or the dense layout (whole-prompt prefill stages), greedy or under
    ``sampler`` (seed 0), recording into ``obs`` when one is given, and
    check the result. The online profiler starts from the same prior in
    every mode and refits as it serves. Returns (engine, launches per
    kernel, flash's launches by body, serve stats: tok/s, wall seconds,
    decode rounds and the wall ms a decode round, prefill stages and
    stall)."""
    from repro_torch.core import CostModel, StageKind
    from repro_torch.launch.profile_step import DENSE_BUCKETS, SERVE_LEN, serve_workload
    from repro_torch.launch.serve import build_scheduling
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.sampler import greedy

    cfg = model.cfg
    path = path or (layout if sampler is None else "top_p")
    reqs = reqs or serve_workload()
    cm = CostModel(level_caps=(32, 64, 128, 256))
    clients, scheduler, policy = build_scheduling(mode, reqs, 8, cm)
    if layout == "paged":
        ecfg = EngineConfig(n_slots=8, max_len=SERVE_LEN, kv_layout="paged", mixed_schedule=True,
                            sample_seed=0, observe=obs)
    else:
        ecfg = EngineConfig(n_slots=8, max_len=SERVE_LEN, kv_layout="dense",
                            prefill_seq_buckets=DENSE_BUCKETS, sample_seed=0, observe=obs)
    eng = Engine(model, params, ecfg, sampler=sampler or greedy, device="cuda")
    eng.profiler.cost_model = cm
    eng.warm_serving_shapes()
    torch.cuda.reset_peak_memory_stats()
    kernels = kernel_modules()
    for mod in kernels.values():
        mod.reset_launch_count()
    t0 = time.perf_counter()
    trace = eng.serve(reqs, clients, scheduler, policy, policy_name=mode)
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
    graphs = check_graphs(path, eng, len(trace.stages))
    check_launches(path, launches, expect)
    if layout == "dense" and len(reqs) > ecfg.n_slots:
        check(stall > 0, "dense: no prefill stage ran while decoders were active")
    decode_s = sum(st.t_end - st.t_start for st in trace.stages if st.kind is StageKind.DECODE)
    return eng, launches, by_variant, dict(
        tok_s=s["generation_speed_tok_s"], wall=wall, utilization=s["utilization"],
        makespan=s["makespan_s"], decode_rounds=decode_rounds, mixed_rounds=mixed,
        prefill_stages=prefills, prefill_stall_s=stall,
        ms_per_decode_round=1e3 * decode_s / max(decode_rounds, 1),
        peak_gib=torch.cuda.max_memory_allocated() / 2**30, graphs=graphs)


def _bits(torch, t):
    """A tensor's bits, for bit-equality (bf16 and float32 alike)."""
    return t.contiguous().view({2: torch.int16, 4: torch.int32, 8: torch.int64,
                                1: torch.int8}[t.element_size()])


def _same_bits(torch, a, b):
    return a.shape == b.shape and bool(torch.equal(_bits(torch, a), _bits(torch, b)))


def replay_inputs(np, rng, eng, key):
    """Random inputs of ``key``'s dispatch, valid for the engine's state:
    random tokens, about three lanes in four decoding, chunk rows on
    distinct slots continuing at each slot's length, random budgets, rids
    and token indices."""
    cfg = eng.cfg
    j, c = cfg.n_slots, cfg.prefill_chunk
    vocab = eng.model.cfg.vocab_size
    ints = lambda lo, hi, *shape: rng.integers(lo, hi, size=shape).astype(np.int32)
    lengths = eng.slots.cache["length"].cpu().numpy()
    if key.kind == "decode":
        k = key.shape[0]
        return dict(tokens=ints(1, vocab, j), active=rng.random(j) < 0.75,
                    budgets=ints(1, k + 3, j), rids=ints(0, 1000, j), token_idx0=ints(0, 64, j))
    if key.kind in ("mixed", "chunk"):
        r = key.shape[0]
        m = int(rng.integers(1, min(r, j) + 1))
        slots = rng.permutation(j)[:m]
        rows = dict(tokens=ints(1, vocab, r, c), slots=np.full(r, j, np.int32),
                    starts=np.zeros(r, np.int32), lens=np.zeros(r, np.int32))
        rows["slots"][:m] = slots
        rows["starts"][:m] = lengths[slots]
        rows["lens"][:m] = ints(1, c + 1, m)
        if key.kind == "chunk":
            return dict(tokens=rows["tokens"], slot_ids=rows["slots"], starts=rows["starts"],
                        lens=rows["lens"])
        dec = rng.random(j) < 0.75
        dec[slots] = False
        return dict(pending=ints(1, vocab, j), chunk_tokens=rows["tokens"],
                    chunk_slots=rows["slots"], starts=rows["starts"], lens=rows["lens"],
                    dec_active=dec, rids=ints(0, 1000, j + r), token_idx=ints(0, 64, j + r),
                    sample_rows=rng.random(j + r) < 0.8)
    n, sl = key.shape
    return dict(tokens=ints(1, vocab, n, sl), lengths=ints(1, sl + 1, n))


def direct_dispatch(torch, eng, key, x, cache):
    """The call ``key`` captures, made directly on the model over ``cache``
    (a copy of the engine's): what its replay must give, bit for bit."""
    model, params, cfg = eng.model, eng.params, eng.cfg
    t = lambda a: torch.from_numpy(a).to(eng.device)
    sample = dict(sampler=eng.sampler, base_key=eng._base_key)
    if key.kind == "decode":
        block, counts, act, last, _ = model.decode_steps(
            params, t(x["tokens"]), cache, num_steps=key.shape[0], active=t(x["active"]),
            budgets=t(x["budgets"]), rids=t(x["rids"]), token_idx0=t(x["token_idx0"]),
            eos_id=cfg.eos_id, **sample)
        return dict(block=block, counts=counts, active=act, last=last)
    if key.kind == "mixed":
        sampled, _ = model.mixed_step(
            params, t(x["pending"]), cache, t(x["chunk_tokens"]), t(x["chunk_slots"]),
            t(x["starts"]), t(x["lens"]), dec_active=t(x["dec_active"]), rids=t(x["rids"]),
            token_idx=t(x["token_idx"]), sample_rows=t(x["sample_rows"]), **sample)
        return dict(sampled=sampled)
    if key.kind == "chunk":
        logits, _ = model.prefill_chunk(params, t(x["tokens"]), cache, t(x["slot_ids"]),
                                        t(x["starts"]), t(x["lens"]))
        return dict(logits=logits)
    n, sl = key.shape
    fresh = model.cache_init(n, sl)
    logits, _ = model.prefill(params, t(x["tokens"]), fresh, lengths=t(x["lengths"]))
    return dict(logits=logits, **{f"prefill {k}": v for k, v in fresh.items()})


def replayed_dispatch(torch, eng, key, x):
    """The same call through the engine's captured dispatch: inputs loaded
    into its static buffers (pending tokens into the engine's own buffer),
    the graph replayed, the outputs unpacked as the engine reads them."""
    x = dict(x)
    if key.kind in ("decode", "mixed"):
        eng._pending_dev.copy_(torch.from_numpy(x.pop("tokens" if key.kind == "decode" else "pending")))
    entry = eng.graphs.prepare(key)
    check(entry.graph is not None, f"replay {key}: no graph was captured")
    out = eng.graphs.run(key, **x)
    if key.kind == "decode":
        k, j = key.shape[0], eng.cfg.n_slots
        return dict(block=out[: k * j].view(k, j), counts=out[k * j: k * j + j],
                    active=out[k * j + j:].bool(), last=eng._pending_dev)
    if key.kind == "mixed":
        return dict(sampled=out)
    if key.kind == "chunk":
        return dict(logits=out)
    return dict(logits=out, **{f"prefill {k}": v for k, v in entry.inputs["cache"].items()})


def check_replays(torch, np, model, params):
    """Every captured key of Qwen3-8B's serving engines — paged (chunk,
    mixed, decode) and dense (prefill, decode), greedy and top-p — replayed
    against a direct model call on the same inputs over a copy of the same
    mid-serve state: the token block, emitted counts, active mask, last
    tokens (or the sampled tokens, or the logits) and the pool's bytes and
    lengths after the call bit-equal. Returns the number of keys checked."""
    from repro_torch.core import CostModel
    from repro_torch.launch.profile_step import DENSE_BUCKETS, SERVE_LEN, serve_workload
    from repro_torch.launch.serve import build_scheduling
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.sampler import TopPSampler, greedy

    rng = np.random.default_rng(0)
    checked = 0
    for layout in ("paged", "dense"):
        for sampler in (greedy, TopPSampler(top_p=0.9)):
            what = f"replay {layout} {'top_p' if sampler is not greedy else 'greedy'}"
            t0 = time.perf_counter()
            ecfg = (EngineConfig(n_slots=8, max_len=SERVE_LEN, kv_layout="paged")
                    if layout == "paged" else
                    EngineConfig(n_slots=8, max_len=SERVE_LEN, prefill_seq_buckets=DENSE_BUCKETS))
            eng = Engine(model, params, ecfg, sampler=sampler, device="cuda")
            eng.profiler.cost_model = CostModel(level_caps=(32, 64, 128, 256))
            eng.warm_serving_shapes()
            # a mid-serve state: slots bound, pages owned, lengths ragged
            reqs = serve_workload()
            eng.begin_serve(reqs, *build_scheduling("hybrid", reqs, 8, eng.profiler.cost_model))
            for _ in range(6):
                eng.serve_step()
            names = set()
            for key in sorted(eng.graphs.keys):
                x = replay_inputs(np, rng, eng, key)
                cache = {k: v.clone() for k, v in eng.slots.cache.items()}
                want = direct_dispatch(torch, eng, key, x, cache)
                got = replayed_dispatch(torch, eng, key, x)
                names |= set(want)
                torch.cuda.synchronize()
                for name in want:
                    check(_same_bits(torch, got[name], want[name]), f"{what} {key}: {name} differs")
                for name, v in cache.items():
                    check(_same_bits(torch, eng.slots.cache[name], v),
                          f"{what} {key}: the pool's {name} differs after the call")
                checked += 1
            st = graph_stats(what, eng.graphs)
            print(f"  {what}: {len(eng.graphs.keys)} keys, each replay bit-equal to the direct call "
                  f"({', '.join(sorted(names))} and the pool), {time.perf_counter() - t0:.3f} s",
                  flush=True)
            del eng, cache
            gc.collect()
            torch.cuda.empty_cache()
    return checked


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


def direct_wave(torch, server, wave):
    """One wave served by direct calls (the model's prefill of the server's
    wave inputs into a fresh cache, then ``decode_step`` and the greedy pick
    per token, no graph): the tokens a WaveServer's replays must give."""
    from repro_torch.serving.sampler import greedy

    model, params = server.model, server.params
    cache = model.cache_init(len(wave), server.max_len, **server.enc)
    logits, _ = model.prefill(params, cache=cache, **server.wave_inputs(wave))
    out = [greedy(logits)]
    for _ in range(max(r.n_decode for r in wave) - 1):
        logits, _ = model.decode_step(params, out[-1], cache)
        out.append(greedy(logits))
    block = torch.stack(out).cpu().numpy()
    return {r.rid: block[: r.n_decode, i].tolist() for i, r in enumerate(wave)}


def run_recurrentgemma_serve(torch, model, params):
    """The serve's 16 requests through RecurrentGemma's own prefill and
    decode_step in two waves of 8 slots (``launch.generate.WaveServer``, its
    decode steps replayed), after a warm-up wave that captures the wave
    size's graph; the first wave's tokens equal direct calls'. Returns the
    launches per kernel and flash's launches by body."""
    from repro_torch.launch.generate import WaveServer
    from repro_torch.launch.profile_step import SERVE_LEN, dense_prefill_len, serve_workload

    cfg = model.cfg
    reqs = serve_workload()
    server = WaveServer(model, params, n_slots=8, max_len=SERVE_LEN, prefill_len=dense_prefill_len())
    # warm-up: the wave's graph captured, cuBLAS and the kernels initialised
    server.serve([dataclasses.replace(r, n_decode=2) for r in reqs[:8]])
    replays = server.graphs.replays
    torch.cuda.reset_peak_memory_stats()
    kernels = kernel_modules()
    for mod in kernels.values():
        mod.reset_launch_count()
    t0 = time.perf_counter()
    res = server.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: mod.launch_count for name, mod in kernels.items()}
    launches.update({f"rglru_scan/{k}": n for k, n in kernels["rglru_scan"].launch_count_by_kernel.items()})
    st = graph_stats("recurrentgemma", server.graphs)
    check(st["captures"] == 1 and st["replays"] - replays == res.decode_steps,
          f"recurrentgemma: {st['replays'] - replays} replays for {res.decode_steps} decode steps")

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
    # the prefill's plan chunks time, a decode step's runs one chunk
    plans = {k: kernels["rglru_scan"].scan_plan(8, s, model.rnn).kernels for k, s in
             (("prefill", dense_prefill_len()), ("decode", 1))}
    check(plans == {"prefill": ("rglru_chunked_kernel",), "decode": ("rglru_kernel",)},
          f"recurrentgemma: kernel 4's plans {plans}")
    expect.update({"rglru_scan/rglru_chunked_kernel": n_rec * res.prefills,
                   "rglru_scan/rglru_kernel": n_rec * res.decode_steps})
    print(f"  recurrentgemma serve: {len(reqs)} requests in {res.prefills} waves of 8 slots, "
          f"{res.tokens} output tokens, {res.decode_steps} decode steps, wall {wall:.4f} s", flush=True)
    print(f"  recurrentgemma tokens/s: {res.tokens / wall:.3f}")
    print(f"  recurrentgemma ms per decode step: {1e3 * res.decode_s / res.decode_steps:.3f}")
    print(f"  recurrentgemma ms per prefill (8 x {dense_prefill_len()}): "
          f"{1e3 * res.prefill_s / res.prefills:.3f}")
    print(f"  recurrentgemma peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    by_variant = check_flash_variants("recurrentgemma", launches)
    check_launches("recurrentgemma", launches, expect)
    direct = direct_wave(torch, server, reqs[:8])
    check(all(res.generated[rid] == toks for rid, toks in direct.items()),
          "recurrentgemma: the replayed wave's tokens differ from direct calls'")
    print(f"  recurrentgemma: wave 1's {sum(map(len, direct.values()))} tokens replayed == direct "
          f"calls': True", flush=True)
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
    (``profile_step.measure_both``), called directly and replayed from its
    graph: (direct, replay), each with wall, device time, busy share,
    kernels."""
    from repro_torch.launch.profile_step import SERVE_LEN, dense_prefill_len, measure_both
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
    return measure_both("dense fused decode, K = 8", lambda: model.decode_steps(
        params, z, cache, num_steps=8, sampler=greedy, active=on, budgets=big, rids=z,
        token_idx0=z), iters=1, read=lambda out: out[0].cpu())


def run_family_serves(torch, then=None):
    """Each of FAMILY_SERVES at full width (random bf16 weights, seed 0):
    the 8 requests of ``family_workload`` through ``run_serve``'s gates on the
    dense layout and, where marked, the paged mixed one; then one fused
    decode stage under the profiler, whose device busy share says whether
    the device or the host paces a decode round; then ``then[arch](model,
    params)`` where given, on the same weights. Each model is freed before
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
        for prof in decode_stage_profile(torch, model, params):
            busy = prof["device_busy_share"]
            print(f"  {cfg.name} fused decode stage (8 slots, K = 8, dense, {prof['way']}): wall "
                  f"{prof['traced_wall_ms']:.3f} ms, device {prof['device_ms']:.3f} ms "
                  f"({prof['device_ms'] / 8:.3f} ms a step against the floor {floor:.3f} ms), busy share "
                  f"{busy:.3f}, {prof['kernels_launched']} kernels: "
                  f"{'device' if busy >= 0.8 else 'host'}-paced; top {json.dumps(prof['top_kernels'][:4])}")
        if then and arch in then:
            then[arch](model, params)
        del model, params
        torch.cuda.empty_cache()
        print(f"  {cfg.name}: {time.perf_counter() - t0:.3f} s", flush=True)
    return launches, by_variant


WHISPER_PROMPT = 64               # Whisper's waves take prompts of one length


def run_wave_family_serve(torch, arch):
    """xLSTM-350M or Whisper-small at their published sizes (random bf16
    weights, seed 0) serving the serve's 16 requests in two waves of 8 slots
    through their own prefill and decode_step (``WaveServer``, each decode
    step a replay of the wave size's graph), after a warm-up wave that
    captures it; Whisper's prompts set to WHISPER_PROMPT tokens (its
    prefill takes no lengths) with 1500 seeded frames each. Gates: every
    budget met with valid token ids, one capture and a replay a decode step,
    launches exact (Whisper: kernel 2 for each encoder self-attention and
    each decoder self- and cross-attention of a wave's prefill, kernel 3
    twice a decoder layer a decode step; xLSTM's cells are plain PyTorch and
    launch none), the first wave's tokens equal to direct calls'. Prints
    tok/s over the served time (the waves' prefills and decode steps; the
    wall also holds drawing the waves' inputs on the host), ms a decode step
    and the launches; returns the launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch.generate import WaveServer
    from repro_torch.launch.profile_step import SERVE_LEN, dense_prefill_len, serve_workload
    from repro_torch.models.registry import get_model

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = get_config(arch)
    model = get_model(cfg, device="cuda")
    params = model.init_params(seed=0)
    torch.cuda.synchronize()
    audio = cfg.family == "audio"
    reqs = serve_workload()
    if audio:
        reqs = [dataclasses.replace(r, n_prefill=WHISPER_PROMPT) for r in reqs]
    prefill_len = WHISPER_PROMPT if audio else dense_prefill_len()
    print(f"  model {cfg.name}: {cfg.n_layers} layers{f' + {cfg.encoder_layers} encoder' if audio else ''}, "
          f"d_model {cfg.d_model}, {cfg.n_heads} heads of {model.hd}, "
          f"{sum(x.numel() for x in _leaves(params)) / 1e9:.3f} B parameters ({cfg.dtype}), "
          f"init {time.perf_counter() - t0:.2f} s", flush=True)
    server = WaveServer(model, params, n_slots=8, max_len=SERVE_LEN, prefill_len=prefill_len)
    server.serve([dataclasses.replace(r, n_decode=2) for r in reqs[:8]])
    replays = server.graphs.replays
    torch.cuda.reset_peak_memory_stats()
    kernels = kernel_modules()
    for mod in kernels.values():
        mod.reset_launch_count()
    t1 = time.perf_counter()
    res = server.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {name: mod.launch_count for name, mod in kernels.items()}
    st = graph_stats(arch, server.graphs)
    check(st["captures"] == 1 and st["replays"] - replays == res.decode_steps,
          f"{arch}: {st['replays'] - replays} replays for {res.decode_steps} decode steps")
    for r in reqs:
        got = res.generated.get(r.rid, [])
        check(len(got) == r.n_decode, f"{arch}: request {r.rid} emitted {len(got)} of {r.n_decode}")
        check(all(0 <= t < cfg.vocab_size for t in got), f"{arch}: request {r.rid}: invalid token id")
    expect = {}
    if audio:
        expect = {"flash_attention": (cfg.encoder_layers + 2 * cfg.n_layers) * res.prefills,
                  "decode_attention": 2 * cfg.n_layers * res.decode_steps}
    served = res.prefill_s + res.decode_s
    print(f"  {arch} serve: {len(reqs)} requests in {res.prefills} waves of 8 slots, {res.tokens} output "
          f"tokens, {res.decode_steps} decode steps, wall {wall:.4f} s (with drawing the waves' inputs), "
          f"served {served:.4f} s (prefills and decode steps), {res.tokens / served:.3f} tok/s, "
          f"{1e3 * res.decode_s / res.decode_steps:.3f} ms a decode step, "
          f"{1e3 * res.prefill_s / res.prefills:.3f} ms a prefill (8 x {prefill_len}"
          f"{', 1500 frames' if audio else ''}), peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    check_launches(f"{arch} serve", launches, expect)
    if audio:
        check_flash_variants(arch, launches)
    direct = direct_wave(torch, server, reqs[:8])
    check(all(res.generated[rid] == toks for rid, toks in direct.items()),
          f"{arch}: the replayed wave's tokens differ from direct calls'")
    print(f"  {arch}: wave 1's {sum(map(len, direct.values()))} tokens replayed == direct calls': True",
          flush=True)
    del server, model, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  {cfg.name}: {time.perf_counter() - t0:.3f} s", flush=True)
    return launches


# --------------------------------------------------------------------------- #
# Paper                                                                       #
# --------------------------------------------------------------------------- #
PAPER_MODES = ("baseline", "offline", "online", "hybrid")
PAPER_SLOTS = 8
PAPER_OUTPUT_SCALE = 4            # the paper's GSM8K output moments over 4
PAPER_ESTIMATE_NOISE_STD = 10.0   # the paper's predictor noise (40) over 4


def paper_workload():
    """32 requests drawn from the paper's GSM8K moments (inputs 68.43 ±
    25.04; outputs 344.83 ± 187.99 capped at 512, each over 4, so capped
    at 128), seed 0, with decode-length estimates off by N(0, 10)."""
    from repro_torch.data import WorkloadSpec, gsm8k_like_workload

    k = PAPER_OUTPUT_SCALE
    spec = WorkloadSpec(n_requests=32, output_mu0=423.508 / k, output_sigma0=340.894 / k,
                        output_mean=344.83 / k, output_std=187.99 / k, output_max=512 // k)
    return gsm8k_like_workload(spec, seed=0, estimate_noise_std=PAPER_ESTIMATE_NOISE_STD)


def run_paper_phase(torch, model, params, smi):
    """The paper's experiment on the card: ``paper_workload`` served under
    each of the four configurations of ``core.simulate`` (baseline, offline,
    online, hybrid) through ``run_serve`` on the dense layout (buckets
    DENSE_BUCKETS, 8 slots) with every gate of the serve, each mode's
    profiler starting from the same prior and refitting as it serves (at
    least one fit a mode); then the ported simulator's prediction for the
    same requests under the cost model that mode fitted on the card, and
    the Eq. 32 lower bound under it. The ranking of the modes and the
    served / simulated ratio are the finding, not gates. Returns (launches
    by path, flash's launches by body by path, the numbers by mode)."""
    from repro_torch.core import simulate, theoretical_lower_bound

    t0 = time.perf_counter()
    reqs = paper_workload()
    print(f"  paper workload: {len(reqs)} requests on {PAPER_SLOTS} slots, "
          f"{sum(r.n_prefill for r in reqs)} prompt tokens (longest {max(r.n_prefill for r in reqs)}), "
          f"{sum(r.n_decode for r in reqs)} output tokens "
          f"({sum(r.n_decode == 512 // PAPER_OUTPUT_SCALE for r in reqs)} at the cap of "
          f"{512 // PAPER_OUTPUT_SCALE}); {model.cfg.name}, {model.cfg.n_layers} layers, dense layout",
          flush=True)
    launches, by_variant, res = {}, {}, {}
    for mode in PAPER_MODES:
        path = f"paper {mode}"
        eng, launches[path], by_variant[path], st = run_serve(
            torch, model, params, "dense", reqs=paper_workload(), path=path, mode=mode)
        fits, cm = eng.profiler.fits, eng.profiler.cost_model
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        check(fits >= 1, f"{path}: the online profiler never refit the cost model")
        sim = simulate(reqs, PAPER_SLOTS, cm, mode=mode)
        lb = theoretical_lower_bound(reqs, PAPER_SLOTS, cm)
        fitted = {k: getattr(cm, k) for k in ("prefill_overhead", "prefill_per_token",
                                              "decode_overhead", "decode_per_token",
                                              "decode_dispatch")}
        res[mode] = dict(
            utilization=st["utilization"], makespan_s=st["makespan"], tok_s=st["tok_s"],
            wall_s=st["wall"], prefill_stages=st["prefill_stages"],
            decode_rounds=st["decode_rounds"], prefill_stall_s=st["prefill_stall_s"],
            profiler_fits=fits, fitted_cost_model=fitted,
            simulated_utilization=sim.utilization, simulated_makespan_s=sim.makespan,
            served_over_simulated=st["makespan"] / sim.makespan, lower_bound_s=lb.total,
            launches=launches[path])
        print(f"  {path} [{smi}]: served utilization {st['utilization']}, makespan "
              f"{st['makespan']} s, {st['tok_s']} tok/s, {st['prefill_stages']} prefill stages, "
              f"{st['decode_rounds']} decode rounds, prefill stall {st['prefill_stall_s']} s; "
              f"fitted ({fits} fits) {json.dumps(fitted)}; simulated under it: utilization "
              f"{sim.utilization:.6f}, makespan {sim.makespan:.6f} s; served / simulated "
              f"makespan {st['makespan'] / sim.makespan:.4f}; Eq. 32 lower bound {lb.total:.6f} s",
              flush=True)
    ranked = sorted(PAPER_MODES, key=lambda m: -res[m]["utilization"])
    print(f"  paper modes by served utilization: {', '.join(ranked)}; by simulated: "
          f"{', '.join(sorted(PAPER_MODES, key=lambda m: -res[m]['simulated_utilization']))}")
    launches["paper"] = {k: sum(launches[f"paper {m}"][k] for m in PAPER_MODES)
                         for k in launches["paper hybrid"]}
    by_variant["paper"] = {k: sum(by_variant[f"paper {m}"][k] for m in PAPER_MODES)
                           for k in by_variant["paper hybrid"]}
    phase("paper", t0)
    return launches, by_variant, res


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


def check_fleet_graphs(what, fleet, report):
    """Each replica replayed one captured dispatch a stage of its trace and
    captured nothing during the serve."""
    for i, (eng, trace) in enumerate(zip(fleet.engines, report.traces)):
        check_graphs(f"{what} r{i}", eng, len(trace.stages))


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
    check_fleet_graphs("fleet", fleet, report)

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
    check_fleet_graphs("drain", fleet, report)
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
    # kernel 4 on the RG waves: the prefills (chunked) and the decode steps
    # (one chunk), launches by the device kernel each plan runs
    ("rglru_scan", "rglru_scan", "recurrentgemma-9b", "rglru_scan/rglru_chunked_kernel", "recurrentgemma",
     "src/repro_torch/kernels/csrc/rglru.cu", "src/repro/kernels/rglru.py:81"),
    ("rglru_scan_decode", "rglru_scan", "recurrentgemma-9b decode", "rglru_scan/rglru_kernel",
     "recurrentgemma", "src/repro_torch/kernels/csrc/rglru.cu", "src/repro/kernels/rglru.py:81"),
    ("flash_attention_backward", "flash_attention_backward", "qwen3-8b train", "flash_attention_backward",
     "train", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
     "src/repro/models/attention.py:18 attention, the gradient jax.grad derives on the training path "
     "(the gradient of kernel 2's function; no Pallas kernel)"),
    ("flash_attention_dense_train", "flash_attention_dense", "qwen3-8b train", "flash_attention", "train",
     "src/repro_torch/kernels/csrc/flash_attention.cu", "src/repro/kernels/flash_attention.py:131"),
    # RecurrentGemma-9B's training: the RG-LRU backward and the flash
    # backward at head_dim 256 (launches from its train run)
    ("rglru_scan_backward", "rglru_scan_backward", "recurrentgemma-9b train", "rglru_scan_backward",
     "recurrentgemma train", "src/repro_torch/kernels/csrc/rglru_bwd.cu",
     "src/repro/models/recurrentgemma.py:179 the lax.scan of the recurrence, the gradient jax.grad "
     "derives on the training path (the gradient of kernel 4's function; no Pallas kernel)"),
    ("flash_attention_backward_recurrentgemma", "flash_attention_backward", "recurrentgemma-9b train",
     "flash_attention_backward", "recurrentgemma train", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
     "src/repro/models/attention.py:18 attention, the gradient jax.grad derives on the training path "
     "(the gradient of kernel 2's function; no Pallas kernel)"),
    # kernels 4 and 2 (with its log-sum-exp) at RecurrentGemma-9B's training shape
    ("rglru_scan_recurrentgemma_train", "rglru_scan", "recurrentgemma-9b train", "rglru_scan",
     "recurrentgemma train", "src/repro_torch/kernels/csrc/rglru.cu", "src/repro/kernels/rglru.py:81"),
    ("flash_attention_dense_recurrentgemma_train", "flash_attention_dense", "recurrentgemma-9b train",
     "flash_attention", "recurrentgemma train",
     "src/repro_torch/kernels/csrc/flash_attention.cu", "src/repro/kernels/flash_attention.py:131"),
    # Whisper-small: kernels 2 and 3 on its wave serve, the flash backward at
    # head_dim 64 on its train run
    ("flash_attention_dense_whisper", "flash_attention_dense", "whisper-small", "flash_attention", "whisper",
     "src/repro_torch/kernels/csrc/flash_attention.cu", "src/repro/kernels/flash_attention.py:131"),
    ("decode_attention_whisper", "decode_attention", "whisper-small", "decode_attention", "whisper",
     "src/repro_torch/kernels/csrc/decode_attention.cu", "src/repro/kernels/decode_attention.py:111"),
    ("flash_attention_backward_whisper", "flash_attention_backward", "whisper-small train",
     "flash_attention_backward", "whisper train", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
     "src/repro/models/attention.py:18 attention, the gradient jax.grad derives on the training path "
     "(the gradient of kernel 2's function; no Pallas kernel)"),
    # phase paper: LLaMA-65B served under the four modes (launches summed)
    ("flash_attention_dense_paper", "flash_attention_dense", "llama-65b", "flash_attention", "paper",
     "src/repro_torch/kernels/csrc/flash_attention.cu", "src/repro/kernels/flash_attention.py:131"),
    ("decode_attention_paper", "decode_attention", "llama-65b", "decode_attention", "paper",
     "src/repro_torch/kernels/csrc/decode_attention.cu", "src/repro/kernels/decode_attention.py:111"),
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
# (timed), a sliding window, LLaMA-65B's MHA, float32 at the smoke shape,
# RecurrentGemma-9B's (timed) and Whisper-small's encoder self-attention at
# its training shape (no mask; timed). Causal unless ``causal`` says not.
TRAIN_KERNEL_CASES = (
    ("qwen3-8b", dict(b=2, h=32, kv=8, s=2048, d=128, window=0, dtype="bfloat16")),
    ("qwen3-8b microbatch", dict(b=1, h=32, kv=8, s=2048, d=128, window=0, dtype="bfloat16")),
    ("window 256", dict(b=2, h=32, kv=8, s=1024, d=128, window=256, dtype="bfloat16")),
    ("llama-65b", dict(b=1, h=64, kv=64, s=2048, d=128, window=0, dtype="bfloat16")),
    ("smoke", dict(b=2, h=4, kv=2, s=64, d=16, window=0, dtype="float32")),
    # RecurrentGemma-9B's attention at its training shape: 16 query heads on
    # one KV head at head_dim 256, a window of 2048 inside 4096 tokens
    ("recurrentgemma-9b", dict(b=1, h=16, kv=1, s=4096, d=256, window=2048, dtype="bfloat16")),
    # Whisper-small's encoder at its training batch of 8 x 256 frames: 12
    # heads of 64, no GQA, no mask
    ("whisper-small", dict(b=8, h=12, kv=12, s=256, d=64, window=0, dtype="bfloat16", causal=False)),
)
TIMED_TRAIN_CASES = ("qwen3-8b", "qwen3-8b microbatch", "recurrentgemma-9b", "whisper-small")
# kernel 2's dense entry with its log-sum-exp, timed at these cases as the
# training path runs it: the kernels line's row key of each
DENSE_TRAIN_ROWS = {"qwen3-8b": "flash_attention_dense",
                    "recurrentgemma-9b": ("flash_attention_dense", "recurrentgemma-9b train")}
# RecurrentGemma-9B's training step (8 of 38 layers, 1 x 4096, remat)
# before the head_dim 256 wgmma body and the chunked RG-LRU scan: the
# median of steps 2-5 on an NVIDIA H100 80GB HBM3 at 700.00 W
RG_TRAIN_STEP_MS_BEFORE = 678.2
RG_TRAIN_SCAN = (1, 4096, 4096)   # RecurrentGemma-9B's recurrence at batch 1 x 4096 tokens
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")
TRAIN_LAYERS = 12                 # full-width Qwen3-8B cut to 12 of its 36 layers
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICROBATCHES = 8, 2, 2048, 2
TRAIN_PARITY = ("qwen3_8b", "olmoe_1b_7b", "qwen2_vl_7b", "mixtral_8x22b")


def attention_pairs(s, window):
    """(query, key) pairs a causal (windowed) self-attention of length s sees."""
    return sum(min(i + 1, window) if window else i + 1 for i in range(s))


def flash_backward_bound(q, k, window, flops_per_pair=10, causal=True):
    """Five products of the visible pairs (S, dP, dV, dQ, dK: 10 D flops a
    pair and head) against reading q, k, v, o, dO and lse once and writing
    dq, dk and dv once. With ``flops_per_pair=14`` the same count for the
    kernel's own design, whose dQ pass computes S and dP again: its floor,
    not the function's bound."""
    b, h, s, d = q.shape
    e = q.element_size()
    nbytes = (4 * q.numel() + 4 * k.numel()) * e + b * h * s * 4
    pairs = attention_pairs(s, window) if causal else s * k.shape[2]
    flops = flops_per_pair * d * h * b * pairs
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


def sdpa_times(torch, F, flush, q, k, v, do, window=0, causal=True):
    """The library yardstick, timed here only and never called by the port:
    scaled_dot_product_attention (causal; under a window, the same mask as
    a boolean band, which only backends that take a mask run, the math
    backend among them) under each backend that takes these inputs, its
    forward, forward + backward, and backward alone (one forward kept
    outside the timed region, then torch.autograd.grad with retain_graph).
    With enable_gqa where the backend takes it, else with K and V expanded
    to the query heads outside the timed region (that backward then returns
    the expanded heads' dK and dV unsummed). Returns {backend: times}."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import dense_mask

    g = q.shape[1] // k.shape[1]
    mask = dense_mask(q.shape[2], k.shape[2], True, window, q.device) if window else None
    out = {}
    for name in SDPA_BACKENDS + (("MATH",) if window else ()):
        for gqa in (True, False):
            kk, vv = (k, v) if gqa else (k.repeat_interleave(g, 1), v.repeat_interleave(g, 1))
            leaves = [x.detach().clone().requires_grad_(True) for x in (q, kk, vv)]
            fwd = lambda: F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                                         is_causal=mask is None and causal, enable_gqa=gqa)
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
    bit for bit, and at the bf16 cases with a group the wgmma body's other
    plans (the GQA group split or not; at head_dim 256 every sub-group
    count) checked and timed beside the plan's. At TIMED_TRAIN_CASES the
    cold-L2 times of the backward, its plain version, the forward with the
    log-sum-exp, our forward + backward, and SDPA on the same inputs under
    each backend (sdpa_times; the yardstick, never called by the port).
    Returns the rows of the kernels line: the backward's at the timed
    cases and kernel 2's dense entry at DENSE_TRAIN_ROWS."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb

    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    rows, timed = {}, {}
    for label, c in TRAIN_KERNEL_CASES:
        g = torch.Generator(device="cuda").manual_seed(7)
        dt = getattr(torch, c["dtype"])
        mk = lambda n: torch.randn(c["b"], c["s"], n, c["d"], device="cuda", generator=g).to(dt).transpose(1, 2)
        q, k, v, do = mk(c["h"]), mk(c["kv"]), mk(c["kv"]), mk(c["h"])
        w, scale, causal = c["window"], c["d"] ** -0.5, c.get("causal", True)
        out, lse = fa.flash_attention(q, k, v, causal=causal, window=w, return_lse=True)
        grads = fb.flash_attention_backward(q, k, v, out, lse, do, causal=causal, window=w)
        torch.cuda.synchronize()
        tol = KERNEL_TOL[c["dtype"]]
        ref_lse = fa.flash_attention_lse_plain(q, k, causal=causal, window=w)
        err_lse = float((lse - ref_lse).abs().max())
        check(err_lse <= KERNEL_TOL["float32"] * (1 + float(ref_lse.abs().max())),
              f"flash lse [{label}]: max err {err_lse:.3g}")
        refs = fb.flash_attention_backward_plain(q, k, v, out, ref_lse, do, causal=causal, window=w)
        errs = {f"d{n}": rel_err(torch, a, b, tol, f"flash_attention_backward [{label}] d{n}")
                for n, a, b in zip("qkv", grads, refs)}
        max_abs = max(float((a.float() - b.float()).abs().max()) for a, b in zip(grads, refs))
        plan = fb.backward_plan(c["b"], c["h"], c["kv"], c["s"], c["s"], c["d"], dt, causal=causal, window=w,
                                n_sms=n_sms(torch))
        fwd_names = device_kernels(torch, lambda: fa.flash_attention(
            q, k, v, causal=causal, window=w, return_lse=True))
        passes = device_kernel_us(torch, lambda: fb.flash_attention_backward(
            q, k, v, out, lse, do, causal=causal, window=w), expect=len(plan.kernels))
        names = [n for n, _ in passes]
        check(len(fwd_names) == 1, f"flash forward [{label}] ran {fwd_names}")
        check(len(names) == len(plan.kernels) and all(k_ in n for k_, n in zip(plan.kernels, names)),
              f"flash backward [{label}] ran {names}, its plan {plan.kernels}")
        again = fb.flash_attention_backward(q, k, v, out, lse, do, causal=causal, window=w)
        check(all(bool(torch.equal(a, b)) for a, b in zip(grads, again)),
              f"flash backward [{label}]: two calls differ")
        del again
        print(f"  flash_attention_backward [{label}] {tuple(q.shape)} kv {c['kv']} window {w} causal {causal} "
              f"{c['dtype']}: lse max err {err_lse:.3g}, rel err {json.dumps(errs)} (tol {tol}), forward one "
              f"device kernel, backward the plan's {len(names)} ({plan.body}, split group {plan.split_group}, "
              f"{plan.subgroups} sub-groups, scratch {plan.scratch_bytes} B), two calls equal; device µs a pass "
              f"{json.dumps([[n.split('(')[0].split('::')[-1], round(us, 1)] for n, us in passes])}",
              flush=True)
        ms_by_plan = {}
        if plan.body == "tensor_cores" and c["h"] > c["kv"]:
            # the other dK/dV grids: the GQA group split over CTAs or not
            # (at head_dim 256 every sub-group count), keyed "grouped",
            # "split" (one head a CTA) or "<n> sub-groups"
            counts = fb.subgroup_counts(c["h"] // c["kv"], c["d"])
            key = lambda p: ("grouped" if not p.split_group else "split" if len(counts) <= 2
                             else f"{p.subgroups} sub-groups")
            alt_errs = []
            for n in counts:
                p = fb.backward_plan(c["b"], c["h"], c["kv"], c["s"], c["s"], c["d"], dt, causal=causal,
                                     window=w, subgroups=n)
                if p != plan:
                    alt_grads = fb._launch(q, k, v, out, lse, do, causal, w, scale, p)
                    torch.cuda.synchronize()
                    alt_errs += [rel_err(torch, a, b, tol, f"flash_attention_backward [{label}] plan {key(p)}")
                                 for a, b in zip(alt_grads, refs)]
                    del alt_grads
                ms_by_plan[key(p)] = time_ms(torch, lambda: fb._launch(q, k, v, out, lse, do, causal, w, scale, p),
                                             flush, iters=10, warmup=2)
            print(f"  flash_attention_backward [{label}] by plan (the plan: {key(plan)}): "
                  f"{json.dumps({k_: round(ms, 4) for k_, ms in ms_by_plan.items()})} ms, the others' rel err "
                  f"{max(alt_errs):.3g}", flush=True)
        del refs
        if label in TIMED_TRAIN_CASES:
            def ours_fwd_bwd():
                o, l = fa.flash_attention(q, k, v, causal=causal, window=w, return_lse=True)
                return fb.flash_attention_backward(q, k, v, o, l, do, causal=causal, window=w)

            bound_ms, bound_by = flash_backward_bound(q, k, w, causal=causal)
            floor_ms, _ = flash_backward_bound(q, k, w, flops_per_pair=14, causal=causal)
            sdpa = sdpa_times(torch, F, flush, q, k, v, do, window=w, causal=causal)
            library_ms, library_backend = fastest(sdpa, "backward_ms")
            row = dict(
                max_abs_err=max_abs, rel_err=max(errs.values()), plan=plan._asdict(),
                pass_us=[[n, us] for n, us in passes], ms_by_plan=ms_by_plan,
                ms=time_ms(torch, lambda: fb.flash_attention_backward(
                    q, k, v, out, lse, do, causal=causal, window=w), flush, iters=10, warmup=2),
                plain_ms=time_ms(torch, lambda: fb.flash_attention_backward_plain(
                    q, k, v, out, lse, do, causal=causal, window=w), flush, iters=5, warmup=1),
                forward_lse_ms=time_ms(torch, lambda: fa.flash_attention(
                    q, k, v, causal=causal, window=w, return_lse=True), flush, iters=10, warmup=2),
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
            if label in DENSE_TRAIN_ROWS:
                # kernel 2's dense entry as the training path runs it: with
                # its log-sum-exp, against the plain forward and lse
                fwd_bound_ms, fwd_bound_by = dense_flash_bound(q, k, causal=causal, window=w)
                out_ref = fa.flash_attention_plain(q, k, v, causal=causal, window=w)
                dense = rows[DENSE_TRAIN_ROWS[label]] = dict(
                    max_abs_err=max_err(torch, out, out_ref, KERNEL_TOL[c["dtype"]]),
                    ms=row["forward_lse_ms"],
                    plain_ms=time_ms(torch, lambda: (fa.flash_attention_plain(q, k, v, causal=causal, window=w),
                                                     fa.flash_attention_lse_plain(q, k, causal=causal, window=w)),
                                     flush, iters=5, warmup=1),
                    library_ms=fastest(sdpa, "forward_ms")[0], library_backend=fastest(sdpa, "forward_ms")[1],
                    bound_ms=fwd_bound_ms, bound_by=fwd_bound_by)
                print(f"  flash_attention_dense [{label} train] timed: forward with lse {row['forward_lse_ms']:.4f} "
                      f"ms, plain {dense['plain_ms']:.4f} ms, SDPA's forward {dense['library_ms']:.4f} ms "
                      f"({dense['library_backend']}), bound {fwd_bound_ms:.4f} ms ({fwd_bound_by})", flush=True)
                del out_ref
        del q, k, v, do, out, lse, grads
        torch.cuda.empty_cache()
    rows["flash_attention_backward"] = dict(timed["qwen3-8b"], microbatch=timed["qwen3-8b microbatch"])
    rows[("flash_attention_backward", "recurrentgemma-9b train")] = timed["recurrentgemma-9b"]
    rows[("flash_attention_backward", "whisper-small train")] = timed["whisper-small"]
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
    exact flash launches; one adamw_update alone (CUDA events). Its step
    under torch.profiler is profile_train_step's. Returns the launches and
    the measured numbers."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import TrainConfig, train

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
        tokens_per_s=tokens / step_s, model_flops=model_flops, mfu=mfu, peak_gib=peak, adamw_update_ms=opt_ms,
        launches=launches, flash_launches_by_variant=flash_by_variant, card=smi,
    )
    print(f"  qwen3-8b train ({res['layers']} layers, {n_params / 1e9:.3f} B parameters, bf16, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_MICROBATCHES} microbatches, remat) on {smi}: losses "
          f"{json.dumps([round(x, 4) for x in out['losses']])}, step ms {json.dumps([round(1e3 * x, 1) for x in out['step_s']])}, "
          f"median of steps 2-{TRAIN_STEPS} {step_s * 1e3:.1f} ms, {tokens / step_s:.0f} tokens/s, "
          f"model FLOPs {model_flops / 1e12:.2f} T a step, MFU {mfu:.4f} of {BF16_FLOPS_PER_S / 1e12:.0f} TFLOPS, "
          f"peak {peak:.2f} GiB, one adamw_update {opt_ms:.1f} ms", flush=True)
    del params, state, out
    gc.collect()
    torch.cuda.empty_cache()
    return res


def profile_train_step(torch, smi):
    """One step of run_full_width_train's work (Qwen3-8B at TRAIN_LAYERS
    layers, TRAIN_BATCH x TRAIN_SEQ, TRAIN_MICROBATCHES, remat) from a
    fresh init under torch.profiler: the device busy share, device ms by
    kind (GEMM, flash forward, flash backward, the rest) and the top
    kernels. main runs it last, after every timed step. Returns the
    numbers (None where every trace came back empty)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.profile_step import _measure
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_loop import TrainConfig, synthetic_batches
    from repro_torch.train.train_step import make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("qwen3_8b"), n_layers=TRAIN_LAYERS)
    tc = TrainConfig(steps=1, batch=TRAIN_BATCH, seq=TRAIN_SEQ, microbatches=TRAIN_MICROBATCHES, remat=True)
    model = TransformerLM(cfg, device="cuda")
    params = model.init_params(tc.seed)
    state = adamw_init(params)
    step_fn = make_train_step(model, AdamWConfig(lr=1e-4, warmup_steps=2), microbatches=TRAIN_MICROBATCHES,
                              remat=True)
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
    res = dict(device_busy_share=prof["device_busy_share"], profiled_step_wall_ms=prof["traced_wall_ms"],
               profiled_step_device_ms=prof["device_ms"], top_kernels=prof["top_kernels"][:6],
               device_ms_by_kind=by_kind)
    print(f"  qwen3-8b train step profiled on {smi}: device busy share {prof['device_busy_share']} "
          f"({prof['device_ms']} of {prof['traced_wall_ms']:.1f} ms), device ms by kind {json.dumps(by_kind)}, "
          f"top kernels {json.dumps(prof['top_kernels'][:6])}", flush=True)
    del model, params, state, step_fn, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


# (arch, layers kept — None keeps them all —, batch, sequence, steps):
# RecurrentGemma-9B at its published widths cut to two periods and its
# two-layer tail (8 of 38 layers: AdamW's float32 moments of the full model
# would not fit in 80 GB), at 4096 tokens so that its window of 2048 masks;
# xLSTM-350M whole at 128 tokens (two time chunks, the state carried
# between their checkpoints); Whisper-small whole (its frames as long as
# its tokens, as the reference's synthetic batches draw them).
FAMILY_TRAINS = (
    ("recurrentgemma_9b", 8, 1, 4096, 5),
    ("xlstm_350m", None, 4, 128, 3),
    ("whisper_small", None, 8, 256, 5),
)
# AdamW as the Qwen3-8B run takes it (lr 1e-4, warmup 2)
FAMILY_TRAIN_OPT = dict(lr=1e-4, warmup_steps=2)
# steps on one batch alone (run_family_train): each train() step's loss is
# that of a new batch (one arithmetic progression a row), and the spread
# between batches hides what a few steps learn
FIXED_BATCH_STEPS = 3


def family_train_launches(model, cfg, steps):
    """The kernel launches a remat training run of ``steps`` steps implies:
    each layer's forward twice (the recompute), its backward once."""
    if cfg.family == "hybrid":
        return {"rglru_scan": 2 * model.n_rec * steps, "rglru_scan_backward": model.n_rec * steps,
                "flash_attention": 2 * model.n_periods * steps,
                "flash_attention_backward": model.n_periods * steps}
    if cfg.family == "audio":
        n = cfg.encoder_layers + 2 * cfg.n_layers
        return {"flash_attention": 2 * n * steps, "flash_attention_backward": n * steps}
    return {}


def run_family_train(torch, np, smi):
    """Each of FAMILY_TRAINS, bf16, random weights from seed 0, remat:
    ``steps`` steps of train(). Gates: every loss finite, grad_norm finite
    and > 0, count == steps, launches exact (the RG-LRU and flash backward
    kernels for RecurrentGemma, the flash backward for Whisper, none for
    xLSTM's plain cells); then, from the same init, FIXED_BATCH_STEPS steps
    on the first batch alone must bring its loss below the initial one after
    one of them (``fixed_batch_losses``; bf16 weights updated in place, so
    the loss need not fall at every step).
    Prints the losses, step ms, tokens/s and peak memory. Returns (launches
    by path, numbers by arch)."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import TrainConfig, synthetic_batches, train

    launches, res = {}, {}
    for arch, keep, batch, seq, steps in FAMILY_TRAINS:
        gc.collect()
        torch.cuda.empty_cache()
        full = get_config(arch)
        cfg = full if keep is None else dataclasses.replace(full, n_layers=keep)
        model = get_model(cfg, device="cuda")
        tc = TrainConfig(steps=steps, batch=batch, seq=seq, remat=True, log_every=0)
        torch.cuda.reset_peak_memory_stats()
        kernels = kernel_modules()
        for mod in kernels.values():
            mod.reset_launch_count()
        out = train(cfg, tc, AdamWConfig(**FAMILY_TRAIN_OPT), device="cuda")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        path = f"{arch.split('_')[0]} train"
        launches[path] = {name: mod.launch_count for name, mod in kernels.items()}
        check_launches(path, launches[path], family_train_launches(model, cfg, steps))
        by_body = kernels["flash_attention_backward"].launch_count_by_variant
        if launches[path]["flash_attention_backward"]:
            print(f"  {path} flash backward launches by body: {json.dumps(by_body)}", flush=True)
            check(by_body["tensor_cores"] == launches[path]["flash_attention_backward"],
                  f"{path}: bf16 flash backward off the tensor-core body: {by_body}")
        check(all(np.isfinite(out["losses"])), f"{path}: losses not finite: {out['losses']}")
        check(all(np.isfinite(out["grad_norms"])) and min(out["grad_norms"]) > 0,
              f"{path}: grad norms {out['grad_norms']}")
        check(int(out["opt_state"]["count"]) == steps, f"{path}: count {int(out['opt_state']['count'])}")
        n_params = sum(x.numel() for x in _leaves(out["params"]))
        step_s = statistics.median(out["step_s"][1:])
        res[arch] = dict(
            layers=f"{cfg.n_layers} of {full.n_layers}", parameters=n_params, batch=batch, seq=seq,
            flash_backward_launches_by_body=dict(by_body),
            losses=out["losses"], grad_norms=out["grad_norms"], step_s=out["step_s"],
            step_ms_median=step_s * 1e3, tokens_per_s=batch * seq / step_s, peak_gib=peak,
            opt=FAMILY_TRAIN_OPT, card=smi)
        print(f"  {path} ({res[arch]['layers']} layers, {n_params / 1e9:.3f} B parameters, bf16, batch "
              f"{batch} x {seq}, remat, lr {FAMILY_TRAIN_OPT['lr']} warmup {FAMILY_TRAIN_OPT['warmup_steps']}) "
              f"on {smi}: losses {json.dumps([round(x, 4) for x in out['losses']])}, step ms "
              f"{json.dumps([round(1e3 * x, 1) for x in out['step_s']])}, median of steps 2-{steps} "
              f"{step_s * 1e3:.1f} ms"
              + (f" (before the head_dim 256 wgmma body and the chunked RG-LRU scan: {RG_TRAIN_STEP_MS_BEFORE} "
                 f"ms on NVIDIA H100 80GB HBM3, 700.00 W)" if arch == "recurrentgemma_9b" else "")
              + f", {batch * seq / step_s:.0f} tokens/s, peak {peak:.2f} GiB", flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
        fixed = fixed_batch_losses(torch, model, next(synthetic_batches(cfg, tc, "cuda")), tc.seed)
        res[arch]["fixed_batch_losses"] = fixed
        print(f"  {path}: the first batch's loss over {FIXED_BATCH_STEPS} steps on it alone from the same "
              f"init, then after them: {json.dumps([round(x, 4) for x in fixed])}", flush=True)
        check(min(fixed[1:]) < fixed[0], f"{path}: {FIXED_BATCH_STEPS} steps on one batch never lowered "
              f"its loss: {fixed}")
        del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, res


def fixed_batch_losses(torch, model, batch, seed):
    """FIXED_BATCH_STEPS AdamW steps (FAMILY_TRAIN_OPT, remat) of ``model``
    from its init of ``seed``, each on ``batch``: the batch's loss before
    each step, then after the last."""
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_step import make_train_step

    params = model.init_params(seed)
    state = adamw_init(params)
    step_fn = make_train_step(model, AdamWConfig(**FAMILY_TRAIN_OPT), remat=True)
    losses = []
    for _ in range(FIXED_BATCH_STEPS):
        params, state, metrics = step_fn(params, state, batch)
        losses.append(float(metrics["loss"]))
    with torch.no_grad():
        losses.append(float(model.loss(params, batch)))
    del params, state
    return losses


def run_train_phase(torch, np, smi):
    """Phase train: smoke parity card against CPU, the smoke loop and resume
    on the card, full-width Qwen3-8B at 12 of 36 layers, then FAMILY_TRAINS
    (run_family_train), opening no torch.profiler session; main runs it
    first, since CUPTI, kept attached between sessions, slows host-paced
    steps after many of them (``--profiler-cost``). The kernels at the
    training shapes run in phase kernels, Qwen3's profiled step last
    (profile_train_step). Returns (the launches by path, the full-width
    numbers with the families' under "families")."""
    run_train_parity(torch, np)
    run_train_loop_checks(torch)
    full = run_full_width_train(torch, np, smi)
    launches, full["families"] = run_family_train(torch, np, smi)
    return dict(launches, train=full["launches"]), full


DP_LAYERS = 8                     # full-width Qwen3-8B cut to 8 of its 36 layers
DP_BATCH, DP_SEQ, DP_STEPS = 1, 2048, 3
DP_OPT = dict(lr=1e-3, warmup_steps=1)   # the reference's compressed-DP test
# compressed against plain after DP_STEPS steps: the reference's bars
DP_LOSS_BAR, DP_LEAF_BAR = 0.05, 9e-3


@contextlib.contextmanager
def watch_reductions(torch, keep_grads=False, check_ef=False):
    """While open, every ``reduce_gradients`` call of the DP step is watched:
    CUDA events around it (``events``: (start, end) pairs); with
    ``keep_grads``, a copy of the gradients it reduced (``grads``); with
    ``check_ef``, each leaf's largest |error feedback| over its int8 scale
    (``ef_ratio``, the largest a call: the quantization bounds it by 1/2),
    the scale read back from the reduced mean plus the error feedback (one
    rank: the mean is q x scale), and the host seconds that check took
    (``check_s``, outside the events)."""
    import types

    from repro_torch.models.layers import _leaves as leaves_of
    from repro_torch.models.layers import tree_map
    from repro_torch.train import dp_compressed as dp

    inner = dp.reduce_gradients
    seen = types.SimpleNamespace(events=[], grads=[], ef_ratio=[], check_s=0.0)

    def watched(grads, *args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if keep_grads:
            seen.grads.append(tree_map(torch.clone, grads))
        start.record()
        mean, ef = inner(grads, *args, **kw)
        end.record()
        seen.events.append((start, end))
        if check_ef:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            worst = 0.0
            for (_, m), (_, e) in zip(leaves_of(mean), leaves_of(ef)):
                scale = float((m + e).abs().max()) / 127.0
                if scale > 0:
                    worst = max(worst, float(e.abs().max()) / scale)
            seen.ef_ratio.append(worst)
            seen.check_s += time.perf_counter() - t0
        return mean, ef

    dp.reduce_gradients = watched
    try:
        yield seen
    finally:
        dp.reduce_gradients = inner


def run_dp_full_width(torch, np, smi, group):
    """Qwen3-8B at its published widths cut to DP_LAYERS of 36 layers, bf16,
    random weights from seed 0, global batch DP_BATCH x DP_SEQ, remat,
    DP_OPT: DP_STEPS steps of make_train_step(microbatches=1), then of the
    plain and the compressed make_dp_train_step on the one-rank NCCL
    ``group``, each from the same init and a fresh AdamW state. Gates: the
    plain DP step's parameters (every leaf) and loss bit-equal to
    train_step's after each step (train_step's parameters held on the host);
    the compressed run's first loss equal to the plain run's (the same
    parameters), its losses finite and falling, every leaf within
    DP_LEAF_BAR of the plain run's after DP_STEPS steps, and every leaf's
    error feedback within half its int8 scale at every step; flash forward
    and backward launches exact and the same in the three runs. The
    reference's loss bar (DP_LOSS_BAR) is printed beside the compressed
    run's gap and not gated: at Qwen3's vocabulary of 151,936 the
    reference's own compressed step misses it (0.07 after 3 steps at smoke
    widths, tests/test_torch_dp_wide_vocab.py); the bar holds at the smoke
    configs' vocabulary of 256. Prints the step ms (median of steps 2 on;
    the compressed run's without the error-feedback check; the first step
    of the process warms cuBLAS and the allocator), the reduction's ms (CUDA
    events), the bytes all-reduced a step and the peak memory of each run.
    Returns (the plain DP run's launches, numbers)."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import _leaves as leaves_of
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.train.dp_compressed import init_error_feedback, make_dp_train_step
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_step import make_train_step

    full = get_config("qwen3_8b")
    cfg = dataclasses.replace(full, n_layers=DP_LAYERS)
    model = TransformerLM(cfg, device="cuda")
    opt_cfg = AdamWConfig(**DP_OPT)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (DP_BATCH, DP_SEQ), generator=gen, device="cuda",
                           dtype=torch.int32)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    kernels = kernel_modules()
    makers = {
        "train_step": lambda: make_train_step(model, opt_cfg, microbatches=1, remat=True),
        "dp_plain": lambda: make_dp_train_step(model, group, opt_cfg, compress=False, remat=True),
        "dp_compressed": lambda: make_dp_train_step(model, group, opt_cfg, compress=True, remat=True),
    }
    snaps, res, n_params, n_leaves = [], {}, 0, 0
    for name, make in makers.items():
        gc.collect()
        torch.cuda.empty_cache()
        params = model.init_params(0)
        state = adamw_init(params)
        ef = init_error_feedback(params) if name == "dp_compressed" else None
        n_params = sum(t.numel() for _, t in leaves_of(params))
        n_leaves = len(list(leaves_of(params)))
        step = make()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for mod in kernels.values():
            mod.reset_launch_count()
        losses, step_ms, same = [], [], []
        with watch_reductions(torch, check_ef=name == "dp_compressed") as seen:
            for i in range(DP_STEPS):
                torch.cuda.synchronize()
                t0, checked = time.perf_counter(), seen.check_s
                if name == "train_step":
                    params, state, metrics = step(params, state, batch)
                else:
                    params, state, ef, metrics = step(params, state, ef, batch)
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t0 - (seen.check_s - checked)))
                losses.append(float(metrics["loss"]))
                if name == "train_step":
                    snaps.append({path: t.to("cpu") for path, t in leaves_of(params)})
                elif name == "dp_plain":
                    same.append(losses[-1] == res["train_step"]["losses"][i] and all(
                        _same_bits(torch, t, snaps[i][path].to("cuda")) for path, t in leaves_of(params)))
        launches = {k: mod.launch_count for k, mod in kernels.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        check_launches(f"qwen3-8b {name}", launches, train_launches(cfg.n_layers, DP_STEPS, True))
        res[name] = dict(losses=losses, step_ms=step_ms, step_ms_median=statistics.median(step_ms[1:]),
                         peak_gib=peak, launches=launches,
                         reduce_ms=[s.elapsed_time(e) for s, e in seen.events])
        if name == "dp_plain":
            res[name]["bit_equal_to_train_step"] = same
            check(all(same), f"qwen3-8b plain DP step vs train_step, bit-equal after each step: {same}")
        if name == "dp_compressed":
            worst = max(float((t.float() - snaps[-1][path].to("cuda").float()).abs().max())
                        for path, t in leaves_of(params))
            loss_gap = abs(losses[-1] - res["dp_plain"]["losses"][-1])
            res[name].update(worst_leaf_vs_plain=worst, loss_gap_vs_plain=loss_gap,
                             error_feedback_over_scale=seen.ef_ratio)
            check(losses[0] == res["dp_plain"]["losses"][0] and all(np.isfinite(losses))
                  and all(b < a for a, b in zip(losses, losses[1:])),
                  f"qwen3-8b compressed DP losses {losses} (plain {res['dp_plain']['losses']})")
            check(worst < DP_LEAF_BAR, f"qwen3-8b compressed DP: a leaf {worst:.3g} from the plain run's")
            check(len(seen.ef_ratio) == DP_STEPS and max(seen.ef_ratio) <= 0.5 + 1e-4,
                  f"qwen3-8b compressed DP: error feedback over its int8 scale {seen.ef_ratio}")
        del params, state, ef, step
    bytes_reduced = {"dp_plain": 4 * n_params, "dp_compressed": 4 * n_params + 4 * n_leaves}
    for name in ("dp_plain", "dp_compressed"):
        res[name]["bytes_all_reduced"] = bytes_reduced[name]
    res.update(layers=f"{cfg.n_layers} of {full.n_layers}", parameters=n_params, leaves=n_leaves,
               batch=f"{DP_BATCH} x {DP_SEQ}", opt=DP_OPT, card=smi)
    for name in makers:
        r = res[name]
        red = (f", reduction {json.dumps([round(x, 2) for x in r['reduce_ms']])} ms, "
               f"{r['bytes_all_reduced'] / 1e9:.3f} GB all-reduced a step" if name != "train_step" else "")
        print(f"  qwen3-8b {name} ({res['layers']} layers, {n_params / 1e9:.3f} B parameters, bf16, batch "
              f"{res['batch']}, remat, one rank) on {smi}: losses {json.dumps(r['losses'])}, step ms "
              f"{json.dumps([round(x, 1) for x in r['step_ms']])} (median of steps 2-{DP_STEPS} "
              f"{r['step_ms_median']:.1f}){red}, "
              f"peak {r['peak_gib']:.2f} GiB", flush=True)
    print(f"  qwen3-8b plain DP bit-equal to train_step after each of {DP_STEPS} steps: "
          f"{res['dp_plain']['bit_equal_to_train_step']}; compressed vs plain after {DP_STEPS}: loss gap "
          f"{res['dp_compressed']['loss_gap_vs_plain']:.4g} (the reference's bar {DP_LOSS_BAR}, not gated at "
          f"this vocabulary), worst leaf {res['dp_compressed']['worst_leaf_vs_plain']:.4g} (< {DP_LEAF_BAR}), "
          f"largest |error feedback| over its int8 scale a step "
          f"{json.dumps([round(x, 6) for x in res['dp_compressed']['error_feedback_over_scale']])} "
          f"(<= 1/2); all-reduce payload a step: "
          f"int32 sum {bytes_reduced['dp_compressed']} B (with {n_leaves} float32 scales) against "
          f"float32 {bytes_reduced['dp_plain']} B", flush=True)
    del snaps
    gc.collect()
    torch.cuda.empty_cache()
    return res["dp_plain"]["launches"], res


def check_dp_pair(torch, on_cpu, on_card, compress, what):
    """Gate one DP step on the CPU against the same step on the card, each
    side (loss, {path: parameter}, {path: error feedback}, {path: gradient
    the step reduced}) on the host: see run_dp_smoke. Without compression
    the error feedback stays zero on both."""
    from repro_torch.distributed.collectives import dequantize_int8, quantize_int8

    (l_cpu, pc, ec, g_cpu), (l_card, pg, eg, g_card) = on_cpu, on_card
    g_err = max(float((g_card[k] - g).abs().max() / g.abs().max().clamp_min(1e-30))
                for k, g in g_cpu.items())
    p_err = max(float((pg[k] - pc[k]).abs().max()) for k in pc)
    # each device's error feedback is the int8 residual of its own gradients
    # (recomputed here); across the devices it differs by what their
    # gradients do, and by the leaf's scale where they round an element to
    # int8 values 1 apart
    own_err, e_err, flips = 0.0, 0.0, 0
    for k, e in ec.items():
        if not compress:
            own_err = max(own_err, float(e.abs().max()), float(eg[k].abs().max()))
            continue
        q_c, s_c = quantize_int8(g_cpu[k])
        q_g, s_g = quantize_int8(g_card[k])
        for got, g, q, sc in ((e, g_cpu[k], q_c, s_c), (eg[k], g_card[k], q_g, s_g)):
            own_err = max(own_err, float((got - (g.float() - dequantize_int8(q, sc))).abs().max()))
        dq = (q_g.int() - q_c.int()).abs()
        check(int(dq.max()) <= 1, f"{what}: {'/'.join(k)} int8 values {int(dq.max())} apart")
        flips += int(dq.sum())
        room = ((g_card[k] - g_cpu[k]).abs() + q_c.abs().float() * float((s_g - s_c).abs())
                + dq.float() * float(s_c))
        e_err = max(e_err, float(((eg[k] - e).abs() - room).max()))
    bits = all(_same_bits(torch, pg[k], pc[k]) for k in pc) and all(
        _same_bits(torch, eg[k], ec[k]) for k in ec)
    check(abs(l_card - l_cpu) <= LOGITS_TOL and g_err <= TRAIN_GRAD_TOL and p_err <= LOGITS_TOL
          and own_err <= LOGITS_TOL and e_err <= LOGITS_TOL,
          f"{what} card vs CPU: loss {l_card} vs {l_cpu}, gradients {g_err:.3g}, parameters "
          f"{p_err:.3g}, error feedback against its own gradients' residual {own_err:.3g}, across the "
          f"devices past what the gradients explain {e_err:.3g}")
    print(f"  {what}, NCCL on the card vs gloo on the CPU (float32): loss {l_card:.7g} vs {l_cpu:.7g}, "
          f"reduced gradients worst leaf {g_err:.3g} (relative), parameters max err {p_err:.3g}, error "
          f"feedback vs the int8 residual of each device's own gradients {own_err:.3g}, card vs CPU "
          f"{e_err:.3g} past what the gradients explain ({flips} elements 1 int8 step apart), "
          f"bit-equal {bits}", flush=True)


def run_dp_smoke(torch, np, gloo):
    """The float32 smoke Granite (weights perturbed): one compressed and one
    plain DP step (remat, lr 1e-5, warmup 1) on the card's one-rank NCCL
    group against the same steps on the one-rank gloo group ``gloo`` on the
    CPU: the loss and the parameters within LOGITS_TOL, the gradients the
    step reduced within TRAIN_GRAD_TOL of each leaf's largest magnitude
    (whether bit-equal is printed); each device's error feedback within
    LOGITS_TOL of the int8 residual of its own gradients, recomputed on the
    CPU, and the two devices' within LOGITS_TOL of what their gradients'
    difference explains (each element's gradient difference, its int8
    value times the scales' difference, and the scale where the devices
    round it to int8 values 1 apart, counted and printed); flash launches
    exact on the card. The step's lr is small because AdamW's first step is
    sign-like: an element whose gradient the two devices round to opposite
    signs steps 2 lr apart, 2e-5 here. Then reshard_restore of a smoke Qwen3
    checkpoint onto a (1, 1) data/model mesh on the card: every leaf a
    DTensor on the card, its full_tensor() bit-equal to the saved tree."""
    import tempfile

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.elastic import build_mesh, remesh_plan, reshard_restore
    from repro_torch.models.layers import _leaves as leaves_of
    from repro_torch.models.layers import abstract_params, logical_specs, tree_map
    from repro_torch.models.registry import get_model
    from repro_torch.train.dp_compressed import init_error_feedback, make_dp_train_step
    from repro_torch.train.optimizer import AdamWConfig, adamw_init

    cfg = dataclasses.replace(get_smoke_config("granite_3_8b"), dtype="float32")
    (cpu, p_cpu), (card, p_card) = _card_and_cpu(torch, cfg, perturb=True)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(4, 32)).astype(np.int32))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    for compress in (True, False):
        outs = {}
        for dev, m, p, group in (("cpu", cpu, p_cpu, gloo), ("cuda", card, p_card, None)):
            params = tree_map(torch.clone, p)
            state, ef = adamw_init(params), init_error_feedback(params)
            step = make_dp_train_step(m, group, AdamWConfig(lr=1e-5, warmup_steps=1),
                                      compress=compress, remat=True)
            _reset_train_counts()
            with watch_reductions(torch, keep_grads=True) as seen:
                params, state, ef, metrics = step(params, state, ef,
                                                  {k: x.to(dev) for k, x in batch.items()})
            grads = seen.grads[0]
            if dev == "cuda":
                check_train_launches(f"smoke granite DP step (compress={compress})", cfg.n_layers, 1, True)
            outs[dev] = tuple([float(metrics["loss"])] + [{k: t.cpu() for k, t in leaves_of(tree)}
                                                          for tree in (params, ef, grads)])
        check_dp_pair(torch, outs["cpu"], outs["cuda"], compress, f"smoke granite DP step (compress={compress})")

    cfg = get_smoke_config("qwen3_8b")
    model = get_model(cfg, device="cuda")
    params = model.init_params(0)
    defs = model.param_defs()
    mesh = build_mesh(remesh_plan((1, 1), ("data", "model"), 1), "cuda")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        save_checkpoint(tmp, 7, params)
        tree, _ = reshard_restore(tmp, abstract_params(defs), logical_specs(defs), mesh)
    got = dict(leaves_of(tree))
    ok = all(got[k].device.type == "cuda" and _same_bits(torch, got[k].full_tensor(), t)
             for k, t in leaves_of(params))
    check(ok, "reshard_restore of smoke qwen3 onto a (1, 1) mesh on the card is not bit-equal")
    print(f"  reshard_restore of smoke qwen3 ({len(got)} leaves) onto a (1, 1) data/model mesh on the card: "
          f"DTensors bit-equal to the saved tree: {ok}", flush=True)


def run_dp_phase(torch, np, smi):
    """Phase dp: a one-rank NCCL group (its FileStore in a temp dir) and a
    gloo group beside it; run_dp_full_width, then run_dp_smoke; the groups
    are destroyed at the end. Returns (launches by path, numbers)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.train.dp_compressed import init_group

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        init_group("cuda", f"file://{tmp}/filestore", 0, 1)
        try:
            gloo = dist.new_group([0], backend="gloo")
            launches, res = run_dp_full_width(torch, np, smi, None)
            run_dp_smoke(torch, np, gloo)
        finally:
            dist.destroy_process_group()
    return {"dp": launches}, res


# torch.profiler sessions between the two timings of run_profiler_cost
PROFILER_COST_SESSIONS = 300


def run_profiler_cost(torch, smi):
    """Whether CUPTI kept attached between torch.profiler sessions
    (TEARDOWN_CUPTI=0, what main sets unless the caller set it) slows the
    training steps: Whisper-small's (as FAMILY_TRAINS runs it; paced by the
    host) and Qwen3-8B's at TRAIN_LAYERS layers (TRAIN_BATCH x TRAIN_SEQ,
    TRAIN_MICROBATCHES, 5 steps), timed before any profiler session and
    again after PROFILER_COST_SESSIONS sessions, each tracing one call of
    kernel 2's dense entry. Run it once a CUPTI mode (the environment's
    TEARDOWN_CUPTI), in turns. Returns the medians of steps 2-5 (ms), the
    steps, and the sessions whose trace held no device event."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import TrainConfig, train

    runs = {"whisper-small": (get_config("whisper_small"), dict(batch=8, seq=256)),
            "qwen3-8b": (dataclasses.replace(get_config("qwen3_8b"), n_layers=TRAIN_LAYERS),
                         dict(batch=TRAIN_BATCH, seq=TRAIN_SEQ, microbatches=TRAIN_MICROBATCHES))}

    def steps_ms():
        out = {}
        for name, (cfg, shape) in runs.items():
            gc.collect()
            torch.cuda.empty_cache()
            run = train(cfg, TrainConfig(steps=5, remat=True, log_every=0, **shape),
                        AdamWConfig(**FAMILY_TRAIN_OPT), device="cuda")
            out[name] = dict(median_ms=1e3 * statistics.median(run["step_s"][1:]),
                             step_ms=[1e3 * t for t in run["step_s"]])
            del run
        return out

    res = dict(teardown_cupti=os.environ.get("TEARDOWN_CUPTI"), card=smi, before=steps_ms())
    q, k, v = dense_prefill_case(torch, 32, 8, 128, 1, 128)
    empty = 0
    for _ in range(PROFILER_COST_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fa.flash_attention(q, k, v, causal=True)
            torch.cuda.synchronize()
        empty += not any(e.device_type.name == "CUDA" for e in prof.events())
    del q, k, v
    res.update(sessions=PROFILER_COST_SESSIONS, empty_traces=empty, after=steps_ms())
    print(f"  profiler cost, TEARDOWN_CUPTI={res['teardown_cupti']}, {smi}: median step ms before any "
          f"session / after {PROFILER_COST_SESSIONS} ({empty} traces empty): "
          + ", ".join(f"{n} {res['before'][n]['median_ms']:.1f} / {res['after'][n]['median_ms']:.1f}"
                      for n in runs), flush=True)
    return res


# --------------------------------------------------------------------------- #
# Phase dryrun: the dry-run held to the card                                  #
# --------------------------------------------------------------------------- #
#: the trace's predicted peak against max_memory_allocated, relative
DRYRUN_PEAK_TOL = 0.10
#: one cell per family, traced on the fake 16 x 16 world
DRYRUN_CELLS = (("qwen3_8b", "train_4k"), ("mixtral_8x22b", "decode_32k"),
                ("recurrentgemma_9b", "long_500k"), ("whisper_small", "prefill_32k"),
                ("qwen2_vl_7b", "prefill_32k"))
DRYRUN_SCRIPT = """
import json, sys
from repro_torch.launch import dryrun
for arch, shape in json.loads(sys.argv[1]):
    print(json.dumps(dryrun.run_cell(arch, shape, False, save=False)), flush=True)
"""


def calibrate_step(torch, what, build_real, trace_cell, smi):
    """Trace ``trace_cell`` (``dryrun.build_cell`` arguments, one card) on
    fake CUDA tensors, then run the real step ``build_real()`` returns
    twice: once under FlopCounterMode with the launch counters and the peak
    reset, once timed between CUDA events. Gates the peak, the FLOPs and the
    launches; returns the numbers."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16

    t0 = time.perf_counter()
    step, args, fake = dryrun.build_cell(**trace_cell, device="cuda")
    pred = dryrun.trace_step(step, args, fake)
    del step, args, fake
    trace_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    real_step = build_real()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = kernel_modules()
    for mod in kernels.values():
        mod.reset_launch_count()
    with FlopCounterMode(display=False) as fc:
        real_step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = {name: mod.launch_count for name, mod in kernels.items() if mod.launch_count}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    real_step()
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end)
    del real_step
    gc.collect()
    torch.cuda.empty_cache()
    mem = pred["memory"]
    bound_ms = 1e3 * max(pred["cost"]["flops"] / PEAK_FLOPS_BF16,
                         (mem["argument_bytes"] + mem["temp_bytes"]) / HBM_BW)
    calls = {k: int(v) for k, v in pred["op_calls"].items()}
    res = dict(predicted_peak_bytes=pred["peak_bytes"], peak_bytes=peak,
               peak_rel_err=pred["peak_bytes"] / peak - 1, trace_flops=pred["cost"]["registered_flops"],
               flop_counter_flops=fc.get_total_flops(), op_calls=calls, launches=launches,
               step_ms=step_ms, roofline_bound_ms=bound_ms, trace_s=trace_s, card=smi)
    print(f"  dryrun {what} on {smi}: predicted peak {pred['peak_bytes'] / 2**30:.3f} GiB, "
          f"max_memory_allocated {peak / 2**30:.3f} GiB ({100 * res['peak_rel_err']:+.2f}%); "
          f"trace FLOPs {res['trace_flops']:.6g}, FlopCounterMode {res['flop_counter_flops']:.6g}; "
          f"op calls {json.dumps(calls)}, launches {json.dumps(launches)}; step {step_ms:.2f} ms, "
          f"roofline bound {bound_ms:.2f} ms; trace {trace_s:.1f} s", flush=True)
    check(abs(res["peak_rel_err"]) <= DRYRUN_PEAK_TOL,
          f"dryrun {what}: predicted peak {pred['peak_bytes']} vs {peak} bytes")
    check(res["trace_flops"] == res["flop_counter_flops"] > 0,
          f"dryrun {what}: trace FLOPs {res['trace_flops']} vs FlopCounterMode {res['flop_counter_flops']}")
    check(calls == launches, f"dryrun {what}: op calls {calls} vs launches {launches}")
    return res


def run_dryrun_phase(torch, np, smi):
    """Phase dryrun (the module docstring, phase 9)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.distributed.sharding import ShardingConfig
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_step import make_train_step

    res = {"device": smi}
    # one cell per family on the fake 16 x 16 world, in a process that sees
    # no card, started first: it runs on the host while the card calibrates
    t_cells = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen([sys.executable, "-c", DRYRUN_SCRIPT, json.dumps(DRYRUN_CELLS)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        full = get_config("qwen3_8b")
        b, s = 8, 32768

        def decode_real():
            model = TransformerLM(full, device="cuda")
            params = model.init_params(seed=0)
            cache = model.cache_init(b, s)
            cache["length"].fill_(s - 1)
            tokens = torch.arange(b, dtype=torch.int32, device="cuda")

            def step():
                cache["length"].fill_(s - 1)
                model.decode_step(params, tokens, cache)
            return step

        plan = {"microbatches": 1, "remat": True, "sharding": ShardingConfig()}
        res["decode"] = calibrate_step(
            torch, f"qwen3-8b decode_step (B {b}, dense cache {s})", decode_real,
            dict(arch="qwen3_8b", cell=ShapeCell("decode", s, b, "decode"), mesh=None, plan=plan,
                 cfg=full), smi)

        cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)

        def train_real():
            model = TransformerLM(cfg, device="cuda")
            params = model.init_params(seed=0)
            opt = adamw_init(params)
            gen = torch.Generator(device="cuda").manual_seed(0)
            batch = {k: torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ), generator=gen,
                                      device="cuda", dtype=torch.int32) for k in ("tokens", "labels")}
            step = make_train_step(model, AdamWConfig(), microbatches=TRAIN_MICROBATCHES, remat=True)
            return lambda: step(params, opt, batch)

        plan = {"microbatches": TRAIN_MICROBATCHES, "remat": True, "sharding": ShardingConfig()}
        res["train"] = calibrate_step(
            torch, f"qwen3-8b train step ({TRAIN_LAYERS} of {full.n_layers} layers, {TRAIN_BATCH} x "
                   f"{TRAIN_SEQ}, {TRAIN_MICROBATCHES} microbatches, remat)", train_real,
            dict(arch="qwen3_8b", cell=ShapeCell("train", TRAIN_SEQ, TRAIN_BATCH, "train"), mesh=None,
                 plan=plan, cfg=cfg), smi)
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:          # a failed check above, or a hung trace
            proc.kill()
            proc.wait()
    check(proc.returncode == 0, f"dryrun cells: exit {proc.returncode}: {stderr[-2000:]}")
    cells = [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]
    check(len(cells) == len(DRYRUN_CELLS), f"dryrun cells: {len(cells)} results of {len(DRYRUN_CELLS)}")
    res["cells"] = []
    for r in cells:
        check(r["status"] == "ok", f"dryrun {r['arch']} {r['shape']}: {r.get('error')}")
        print(f"  dryrun {r['arch']} {r['shape']} on the fake {r['mesh']} world: ok, trace "
              f"{r['trace_s']} s, peak {r['peak_bytes'] / 2**30:.3f} GiB a device, microbatches "
              f"{r['microbatches']}, collective bytes {r['collective_bytes_total']:.4g} "
              f"(this process's CPU; the card named {smi})", flush=True)
        res["cells"].append({k: r[k] for k in ("arch", "shape", "mesh", "trace_s", "peak_bytes",
                                               "microbatches", "collective_bytes_total")})
    res["cells_s"] = time.perf_counter() - t_cells
    return res


def main() -> int:
    sweep = sys.argv[1:] == ["--sweep"]
    train_only = sys.argv[1:] == ["--train"]
    profiler_cost = sys.argv[1:] == ["--profiler-cost"]
    if sys.argv[1:] and not (sweep or train_only or profiler_cost):
        print("usage: chip_smoke.py [--sweep | --train | --profiler-cost]", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    # keep CUPTI attached between the many short torch.profiler sessions of
    # this process: torn down and re-attached each time, half of its traces
    # come back empty (--profiler-cost). Kept attached, it slows host-paced
    # work after many sessions, so phase train runs first
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
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
    if profiler_cost:
        t0 = time.perf_counter()
        res = run_profiler_cost(torch, smi)
        phase("profiler cost", t0)
        print(json.dumps({"profiler_cost": res}))
        return 0
    if train_only:
        import torch.nn.functional as F

        t0 = time.perf_counter()
        _, res = run_train_phase(torch, np, smi)
        phase("train", t0)
        t0 = time.perf_counter()
        _, res["dp"] = run_dp_phase(torch, np, smi)
        phase("dp", t0)
        t0 = time.perf_counter()
        rows = run_train_kernel_checks(torch, np, F)
        res.update(profile_train_step(torch, smi))
        phase("train kernels", t0)
        print(json.dumps({"train": res, **{k if isinstance(k, str) else " ".join(k): v
                                           for k, v in rows.items()}}))
        return 0

    # phase train first: its timed steps follow no torch.profiler session
    t0 = time.perf_counter()
    train_launches, train_res = run_train_phase(torch, np, smi)
    phase("train", t0)

    t0 = time.perf_counter()
    dp_launches, dp_res = run_dp_phase(torch, np, smi)
    phase("dp", t0)

    t0 = time.perf_counter()
    kres = run_kernel_checks(torch, np)
    phase("kernels", t0)

    t0 = time.perf_counter()
    run_parity(torch, np)
    run_fleet_parity(torch, np)
    run_sampler_parity(torch, np)
    run_new_family_parity(torch, np)
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
    n_keys = check_replays(torch, np, model, params)
    print(f"  replays: {n_keys} captured keys of Qwen3-8B's engines (paged and dense, greedy and "
          f"top-p) bit-equal to direct calls", flush=True)
    phase("replays", t1)
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
    paper = {}

    def paper_phase(model, params):
        paper_launches, paper_by_variant, paper["modes"] = run_paper_phase(torch, model, params, smi)
        launches.update(paper_launches)
        by_variant.update(paper_by_variant)

    family_launches, family_by_variant = run_family_serves(torch, then={"llama_65b": paper_phase})
    launches.update(family_launches)
    by_variant.update(family_by_variant)
    check(set(paper.get("modes", {})) == set(PAPER_MODES), "phase paper did not serve every mode")
    for arch in ("xlstm_350m", "whisper_small"):
        launches[arch.split("_")[0]] = run_wave_family_serve(torch, arch)
    phase("family", t0)

    launches.update(train_launches)
    launches.update(dp_launches)
    by_variant["train"] = train_res["flash_launches_by_variant"]
    t0 = time.perf_counter()
    train_res.update(profile_train_step(torch, smi))
    phase("train profile", t0)

    t0 = time.perf_counter()
    dryrun_res = run_dryrun_phase(torch, np, smi)
    phase("dryrun", t0)

    kernels = []
    for kname, key, label, count, layout, source, replaces in KERNELS:
        r = kres[(key, label)]
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[layout][count],
            "launches_by_path": {lay: launches[lay][count] for lay in launches if count in launches[lay]},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **({"launches_by_variant": by_variant.get(layout),
                "ms_by_tile": r.get("ms_by_tile")} if count == "flash_attention" else {}),
            **({k: r[k] for k in ("rel_err", "forward_lse_ms", "forward_backward_ms", "library_backend",
                                  "library_forward_backward_ms", "design_floor_ms", "ms_by_plan", "pass_us",
                                  "plan")}
               if key == "flash_attention_backward" else {}),
            **({k: r[k] for k in ("plan", "pass_us", "design_floor_ms")} if key == "rglru_scan_backward" else {}),
            **({k: r[k] for k in ("plan", "pass_us")} if key == "rglru_scan" else {}),
            **({"microbatch": {k: r["microbatch"][k] for k in (
                "ms", "ms_by_plan", "pass_us", "plan", "bound_ms", "design_floor_ms", "library_ms",
                "library_backend", "forward_backward_ms", "library_forward_backward_ms")}}
               if "microbatch" in r else {}),
        })
    print(json.dumps({"train": train_res}))
    print(json.dumps({"dp": dp_res}))
    print(json.dumps({"paper": {"device": smi, "model": "llama-65b, 32 of 80 layers, dense",
                                "modes": paper["modes"]}}))
    print(json.dumps({"dryrun": dryrun_res}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
