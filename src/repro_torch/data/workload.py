"""Synthetic workload generation matching the paper's Table III statistics.

GSM8K inputs:  N_i^p ~ N(68.43, 25.04²), clipped to [1, ∞)
LLaMA-65B out: N_i^d ~ N(344.83, 187.99²), clipped to [1, 512]

The scheduler plans with *estimates* of the decode length; we model the
estimate as the distribution mean (what an offline profiler would predict)
unless ``estimate_noise_std`` injects a per-request estimator.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..core.types import Request


@dataclass(frozen=True)
class WorkloadSpec:
    """Workload distribution spec.

    ``output_mean/std`` are the *post-cap* sample moments the paper reports
    (their outputs were generated with max_output_length=512, so the
    published moments already include the cap). ``output_mu0/sigma0`` are the
    pre-clip normal parameters calibrated so that clip(N(mu0, sigma0), 1,
    512) reproduces those moments exactly (solved numerically; ~40% of
    outputs hit the cap, which is what a hard cap at 0.9 sigma above the
    mean implies).
    """

    n_requests: int = 1319
    input_mean: float = 68.43
    input_std: float = 25.04
    output_mean: float = 344.83
    output_std: float = 187.99
    output_max: int = 512
    input_max: Optional[int] = None
    output_mu0: float = 423.508
    output_sigma0: float = 340.894


PAPER_WORKLOAD_SPEC = WorkloadSpec()

# Output-length predictor error (std, tokens) used for the offline planner's
# T_i estimates. The paper does not publish its predictor; σ=40 is calibrated
# once so the *offline* configuration reproduces the paper's Fig. 7 result,
# and the online/hybrid numbers then fall out untuned (see EXPERIMENTS.md).
PAPER_PREDICTOR_NOISE_STD = 40.0


def gsm8k_like_workload(
    spec: WorkloadSpec = PAPER_WORKLOAD_SPEC,
    seed: int = 0,
    known_lengths: bool = False,
    estimate_noise_std: float = 0.0,
    ttft_slo_s: Optional[float] = None,
    tbt_slo_s: Optional[float] = None,
) -> List[Request]:
    """Draw a request set from the paper's published moments.

    ``known_lengths=True`` gives the scheduler oracle decode lengths (used to
    isolate the value of uncertainty); default plans with the mean.
    ``ttft_slo_s``/``tbt_slo_s`` stamp every request with a latency deadline
    (``ScheduleTrace`` then reports goodput and SLO attainment next to
    throughput); the default leaves the workload deadline-free.
    """
    rng = np.random.default_rng(seed)
    p = rng.normal(spec.input_mean, spec.input_std, size=spec.n_requests)
    p = np.clip(np.round(p), 1, spec.input_max or np.inf).astype(int)
    d = rng.normal(spec.output_mu0, spec.output_sigma0, size=spec.n_requests)
    d = np.clip(np.round(d), 1, spec.output_max).astype(int)

    requests = []
    for i in range(spec.n_requests):
        if known_lengths:
            est = int(d[i])
        elif estimate_noise_std > 0:
            est = int(
                np.clip(
                    round(d[i] + rng.normal(0, estimate_noise_std)),
                    1,
                    spec.output_max,
                )
            )
        else:
            est = int(round(spec.output_mean))
        requests.append(
            Request(
                rid=i, n_prefill=int(p[i]), n_decode=int(d[i]),
                n_decode_est=est, ttft_slo_s=ttft_slo_s, tbt_slo_s=tbt_slo_s,
            )
        )
    return requests


def shared_prefix_workload(
    spec: WorkloadSpec = PAPER_WORKLOAD_SPEC,
    seed: int = 0,
    n_groups: int = 4,
    prefix_mean: float = 48.0,
    prefix_std: float = 12.0,
    zipf_a: float = 1.5,
    known_lengths: bool = False,
) -> List[Request]:
    """GSM8K-shaped requests whose prompts share per-group prefixes — the
    system-prompt / few-shot-template workload prefix caching exists for.

    Each request joins one of ``n_groups`` prefix groups, Zipf-skewed
    (``zipf_a``) so a few hot templates dominate — the regime where a
    content-addressed prefix cache pays. Group ``g`` owns a prefix of
    ``clip(N(prefix_mean, prefix_std²))`` tokens (drawn once per group);
    every member's prompt opens with it, and ``n_prefill`` is stretched to
    at least prefix + 1 so at least one token is always unique per request.
    The engine derives the actual token content from ``(prefix_group,
    prefix_len, rid)`` alone, so the sharing survives migration/restore."""
    rng = np.random.default_rng(seed)
    requests = gsm8k_like_workload(spec, seed=seed, known_lengths=known_lengths)
    plens = np.clip(
        np.round(rng.normal(prefix_mean, prefix_std, size=n_groups)), 8, None
    ).astype(int)
    # Zipf over group ranks, folded into [0, n_groups)
    groups = (rng.zipf(zipf_a, size=len(requests)) - 1) % n_groups
    for r, g in zip(requests, groups):
        r.prefix_group = int(g)
        r.prefix_len = int(plens[g])
        if r.n_prefill <= r.prefix_len:
            r.n_prefill = r.prefix_len + 1
    return requests


def attach_slos(
    requests: List[Request],
    ttft_slo_s: Optional[float] = None,
    tbt_slo_s: Optional[float] = None,
    online_only: bool = True,
) -> List[Request]:
    """Stamp latency SLOs onto an existing request set, in place.

    ``online_only=True`` (default) deadlines only requests with a positive
    arrival time — the offline backlog keeps ``None`` so overload policies
    can defer it freely (deadline-free work is the degradation budget).
    Returns the same list for chaining.
    """
    for r in requests:
        if online_only and r.arrival <= 0:
            continue
        if ttft_slo_s is not None:
            r.ttft_slo_s = ttft_slo_s
        if tbt_slo_s is not None:
            r.tbt_slo_s = tbt_slo_s
    return requests
