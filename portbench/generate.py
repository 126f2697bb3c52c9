"""The one traffic generator: turns a mix file (``portbench/traffic/<mix>.json``)
and a seed into requests.

A mix is ``"kind": "backlog"``: rounds of ``round_size`` requests, all due
at the round's start (the next round is due when the last one finishes).
A length is ``{"dist": "normal", "mean", "std"}``, rounded and clipped to
``[min, max]``. The n lengths of a round are the n quantiles
``(i + 0.5) / n`` of their distribution, in an order drawn from the mix's
``order_seed`` and the round's number; ``estimate_noise_std`` adds the
planner's error, drawn from the same generator, to the output lengths it
sees (``n_decode_est``). Every run
serves the same work in the same order: the run's seed changes only what is
served (the weights, and the prompts through the request ids).

Request ids are ``base + i`` with ``base`` drawn from the run's seed; the
program derives each prompt's tokens from its id (``prompt_tokens``), and so
does the benchmark's check.
"""
from __future__ import annotations

from statistics import NormalDist
from typing import Dict, List

import numpy as np

RIDS_PER_SEED = 4096              # ids of one seed: base .. base + 4095


def rid_base(seed: int) -> int:
    """The first request id of a seed's traffic (int32-safe)."""
    return (seed % 400_000) * RIDS_PER_SEED


def _quantile(dist: Dict, u: float) -> float:
    if dist["dist"] == "normal":
        return dist["mean"] + dist["std"] * NormalDist().inv_cdf(u)
    raise ValueError(f"unknown distribution {dist['dist']!r}")


def lengths(dist: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """The n quantiles of ``dist``, in an order drawn from ``rng``."""
    x = np.array([_quantile(dist, (i + 0.5) / n) for i in range(n)])
    x = x[rng.permutation(n)]
    return np.clip(np.round(x), dist["min"], dist["max"]).astype(np.int64)


def backlog_round(mix: Dict, seed: int, rnd: int) -> List[Dict]:
    """Round ``rnd`` of a backlog mix: dicts with rid, n_prefill, n_decode,
    n_decode_est (arrival 0: due at the round's start)."""
    n = mix["round_size"]
    if (rnd + 1) * n > RIDS_PER_SEED:
        raise ValueError(f"round {rnd} runs past the seed's {RIDS_PER_SEED} request ids")
    rng = np.random.default_rng([mix["order_seed"], rnd])
    p = lengths(mix["prompt"], n, rng)
    d = lengths(mix["output"], n, rng)
    noise = rng.normal(0.0, mix.get("estimate_noise_std", 0.0), n)
    est = np.clip(np.round(d + noise), 1, mix["output"]["max"]).astype(np.int64)
    base = rid_base(seed) + rnd * n
    return [dict(rid=base + i, n_prefill=int(p[i]), n_decode=int(d[i]),
                 n_decode_est=int(est[i]), arrival=0.0) for i in range(n)]


def requests(mix: Dict, seed: int, rnd: int = 0) -> List[Dict]:
    if mix["kind"] == "backlog":
        return backlog_round(mix, seed, rnd)
    raise ValueError(f"unknown traffic kind {mix['kind']!r}")


def prompt_tokens(rid: int, n: int, vocab: int) -> np.ndarray:
    """A request's prompt: ``n`` ids in [1, vocab) from a generator seeded
    with its id (the derivation the program's engine uses for its synthetic
    prompts)."""
    return np.random.default_rng(rid).integers(1, vocab, size=n).astype(np.int64)
