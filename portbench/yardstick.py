"""The benchmark's arithmetic: tokens over the window, slot and host shares,
decode step time, model FLOPs, and the roofline bound of kernel 1.

Pure functions of the run's records (``portbench.bench.Records``) and of the
program's stage records, so that the CPU tests hold each one to synthetic
traces. Times are seconds from the window's start; the window is
``[0, end]``.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

# The table of peaks: NVIDIA H100 SXM, dense, at its 700 W limit (data sheet).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12


def overlap(a: float, b: float, end: float) -> float:
    """Length of [a, b] inside [0, end]."""
    return max(0.0, min(b, end) - max(a, 0.0))


# --------------------------------------------------------------------------- #
# Requests                                                                    #
# --------------------------------------------------------------------------- #
def output_tokens(stamps: Iterable[Sequence[float]], end: float) -> int:
    """Output tokens that reached the host in the window."""
    return sum(sum(1 for t in ts if 0.0 <= t <= end) for ts in stamps)


# --------------------------------------------------------------------------- #
# Stages                                                                      #
# --------------------------------------------------------------------------- #
def slot_util(stages: Iterable, n_slots: int, end: float) -> float:
    """Busy slot-seconds (slots finishing or mid-chunk in a stage) over
    ``n_slots x end``: the paper's utilization on the wall clock."""
    busy = sum((len(s.busy) + len(s.busy_partial)) * overlap(s.t_start, s.t_end, end)
               for s in stages)
    return busy / (n_slots * end)


def host_share(stages: Iterable, end: float) -> float:
    """1 - (stage time inside the window) / window."""
    return 1.0 - sum(overlap(s.t_start, s.t_end, end) for s in stages) / end


def decode_step_ms(stages: Iterable, end: float) -> Optional[float]:
    """Fused-decode stage time per decode step, over the stages that ended
    in the window."""
    secs = steps = 0.0
    for s in stages:
        if s.kind == "decode" and s.t_end <= end:
            secs += s.t_end - s.t_start
            steps += s.rounds
    return 1e3 * secs / steps if steps else None


# --------------------------------------------------------------------------- #
# Model FLOPs                                                                 #
# --------------------------------------------------------------------------- #
def flop_counts(arch: Dict, tree_numel: Dict[str, int]) -> Dict[str, float]:
    """The model FLOPs a token needs: ``per_token`` (2 x the block weights a
    token multiplies, routed experts only: each expert leaf scaled by k / E),
    ``per_sample`` (2 x the unembedding, for each token sampled) and
    ``per_pair`` (4 x head_dim x heads x layers, for each visible (query, key)
    pair)."""
    e, k = arch.get("n_experts", 0), arch.get("experts_per_token", 0)
    block = 0.0
    for path, n in tree_numel.items():
        if not path.startswith("blocks."):
            continue
        routed = path.startswith("blocks.moe.") and not path.endswith(".router")
        block += n * (k / e if routed else 1.0)
    return {
        "per_token": 2.0 * block,
        "per_sample": 2.0 * arch["d_model"] * arch["vocab_size"],
        "per_pair": 4.0 * arch["head_dim"] * arch["n_heads"] * arch["n_layers"],
    }


def window_flops(reqs: Iterable, end: float, counts: Dict[str, float]) -> float:
    """Model FLOPs of the work that reached the host in the window: every
    prompt whose first token arrived (each prompt token, its causal pairs),
    and every later output token (one processed token at position
    ``n_prefill + i - 1`` seeing ``n_prefill + i`` keys). A prefill still in
    flight at the end counts nothing, so the sum never overstates."""
    total = 0.0
    for r in reqs:
        inside = sum(1 for t in r.stamps if t <= end)
        if inside == 0:
            continue
        p = r.n_prefill
        total += counts["per_token"] * p + counts["per_pair"] * p * (p + 1) / 2
        total += counts["per_sample"] * inside
        m = inside - 1
        total += counts["per_token"] * m + counts["per_pair"] * (m * p + m * (m + 1) / 2)
    return total


# --------------------------------------------------------------------------- #
# Kernel 1's bound (the formula of chip_smoke.py's decode_bound, frozen here  #
# on plain numbers)                                                           #
# --------------------------------------------------------------------------- #
def decode_bound_ms(b: int, h: int, d: int, kv: int, elem: int, table_numel: int,
                    lengths: Sequence[int]) -> float:
    """Kernel 1, one call over ``b`` slots: q (b, 1, h, d) read and written
    once, the block table and the b lengths once, the K and V of every live
    token (``lengths``: the slots that hold any) once; 4 d h FLOPs a (query
    head, key)."""
    toks = int(sum(lengths))
    nbytes = 2 * b * h * d * elem + table_numel * 4 + b * 4
    nbytes += 2 * toks * kv * d * elem
    flops = 4 * d * h * toks
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3


def kernel_calls(steps: Sequence, n_prefill: Dict[int, int], engine: Dict,
                 arch: Dict) -> List[float]:
    """The bounds (ms) of every kernel 1 call of ``steps``, in order, from what the host knows: each stage's kind, its slots (finishing,
    mid-chunk, prefilled) and the tokens each request received in it.

    A slot's KV length is its prompt tokens written so far, plus one for
    each token decoded after the first (``n_prefill + emitted - 1`` once
    bound). Kernel 1 runs once a layer a decode step over every slot, and
    reads every slot that holds tokens (a lane that stopped within a fused
    horizon keeps its length; a slot mid-prefill keeps its chunks)."""
    slots, c = engine["n_slots"], engine["prefill_chunk"]
    page = engine["page_size"]
    max_pages = -(-engine["max_len"] // page)
    table_numel = slots * max_pages
    h, kv, d, layers = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"], arch["n_layers"]
    elem = 2
    k1: List[float] = []
    done: Dict[int, int] = {}          # prompt tokens written, per rid in prefill
    kvlen: Dict[int, int] = {}         # KV length of each bound rid
    for st in steps:
        s = st.stage
        new = st.new_tokens
        if s.kind in ("prefill", "mixed"):
            rows = list(s.busy_partial.values())
            rows += list(s.prefilled.values()) if s.kind == "mixed" else list(s.busy.values())
            lens = [min(c, n_prefill[rid] - done.get(rid, 0)) for rid in rows]
            if s.kind == "mixed":
                lanes = [rid for rid in s.busy.values() if rid not in s.prefilled.values()]
                lengths = [kvlen[rid] + 1 for rid in lanes]
                lengths += [n for rid, n in done.items() if n > 0]
                k1 += [decode_bound_ms(slots, h, d, kv, elem, table_numel, lengths)] * layers
                for rid in lanes:
                    kvlen[rid] += 1
            for rid, n in zip(rows, lens):
                done[rid] = done.get(rid, 0) + n
                if done[rid] >= n_prefill[rid]:
                    del done[rid]
                    kvlen[rid] = n_prefill[rid]
        elif s.kind == "decode":
            lanes = list(s.busy.values())
            mid = [n for n in done.values() if n > 0]
            for i in range(s.rounds):
                lengths = [kvlen[rid] + min(i + 1, new.get(rid, 0)) for rid in lanes] + mid
                k1 += [decode_bound_ms(slots, h, d, kv, elem, table_numel, lengths)] * layers
            for rid in lanes:
                kvlen[rid] += new.get(rid, 0)
        for rid in st.finished:
            kvlen.pop(rid, None)
    return k1
