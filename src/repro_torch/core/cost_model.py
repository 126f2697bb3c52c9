"""Linear prefill/decode cost model and prefill level table.

The paper measures (over 400 data groups, LLaMA-65B on an 8-device node):

    prefill_time(total_tokens)   = 25 ms + 0.13 ms * total_tokens
    decode_round_time(n_clients) = 29 ms + 0.21 ms * n_clients

and quantizes prefill stages into *levels* l ∈ L with token capacity N_l^cap
and duration T_l^p. Levels serve two purposes here:

  1. faithfulness to the paper's MIP (y_{k,l} indicator per stage), and
  2. in the real JAX engine, each level is one padded compilation shape, so
     the level table doubles as the jit bucketing table.

``CostModel.fit`` reproduces the paper's calibration: a least-squares linear
fit of measured stage times vs token counts, used by the engine's online
profiler to adapt the model to whatever hardware it actually runs on.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class PrefillLevel:
    """One prefill level: capacity in tokens and stage duration in seconds."""

    index: int
    cap_tokens: int
    duration_s: float


@dataclass
class CostModel:
    """Linear PD-competition cost model (all times in seconds).

    Defaults are the paper's Table III / §V-A measurements.
    """

    prefill_per_token: float = 0.13e-3
    prefill_overhead: float = 25e-3
    decode_per_token: float = 0.21e-3
    decode_overhead: float = 29e-3
    # Fixed host-side cost of *dispatching* one decode call (python loop,
    # jit-call overhead, host↔device sync) — the part a fused K-iteration
    # decode pays once instead of K times. The paper's per-round constants
    # fold it into decode_overhead; it only becomes separately identifiable
    # once the profiler sees fused stages of differing horizons (the
    # 3-parameter fit below). The default is a typical single-process
    # dispatch+sync cost, refined online.
    decode_dispatch: float = 2e-3
    # Mixed-batch (continuous-batching) timing model: one mixed round that
    # decodes n_d rows while co-processing n_p prefill-chunk tokens in the
    # same dispatch costs
    #
    #     t(n_d, n_p) = mixed_overhead
    #                   + mixed_decode_per_row · n_d
    #                   + mixed_prefill_per_token · n_p
    #
    # (separable: round overhead + per-decode-row + per-prefill-token). The
    # ``None`` defaults derive the mixed constants from the stage-level
    # model — a mixed round is a decode round whose duration inflates
    # linearly with the piggybacked prefill tokens — until the profiler's
    # fit (``mixed_samples`` below) replaces them with measured values.
    mixed_overhead: Optional[float] = None
    mixed_decode_per_row: Optional[float] = None
    mixed_prefill_per_token: Optional[float] = None
    level_caps: Tuple[int, ...] = (512, 1024, 2048, 3072, 4096, 5000)

    def __post_init__(self) -> None:
        if any(c <= 0 for c in self.level_caps):
            raise ValueError("level capacities must be positive")
        if list(self.level_caps) != sorted(set(self.level_caps)):
            raise ValueError("level capacities must be strictly increasing")

    # ------------------------------------------------------------------ #
    # Heterogeneous replicas                                             #
    # ------------------------------------------------------------------ #
    def scaled(self, speed_factor: float) -> "CostModel":
        """This model on a machine running ``speed_factor`` × as fast: every
        duration constant divides by the factor (2.0 → half the time per
        stage, 0.5 → twice). Level capacities are token counts, not times,
        and stay put. Used to seed per-replica cost-model priors for a
        mixed-generation fleet (``core.hetero.ReplicaSpec``)."""
        if speed_factor <= 0:
            raise ValueError("speed_factor must be positive")
        s = float(speed_factor)

        def scale(x: Optional[float]) -> Optional[float]:
            return None if x is None else x / s

        return CostModel(
            prefill_per_token=self.prefill_per_token / s,
            prefill_overhead=self.prefill_overhead / s,
            decode_per_token=self.decode_per_token / s,
            decode_overhead=self.decode_overhead / s,
            decode_dispatch=self.decode_dispatch / s,
            mixed_overhead=scale(self.mixed_overhead),
            mixed_decode_per_row=scale(self.mixed_decode_per_row),
            mixed_prefill_per_token=scale(self.mixed_prefill_per_token),
            level_caps=self.level_caps,
        )

    # ------------------------------------------------------------------ #
    # Raw linear model                                                   #
    # ------------------------------------------------------------------ #
    def prefill_time(self, total_tokens: int) -> float:
        """Un-quantized prefill stage duration for a packed token batch."""
        if total_tokens <= 0:
            return 0.0
        return self.prefill_overhead + self.prefill_per_token * total_tokens

    def decode_round_time(self, n_active_clients: int) -> float:
        """One decode round: every active client emits one token."""
        if n_active_clients <= 0:
            return 0.0
        return self.decode_overhead + self.decode_per_token * n_active_clients

    def fused_decode_time(self, n_active_clients: int, rounds: int) -> float:
        """One fused decode *stage* of ``rounds`` iterations: the dispatch
        cost is paid once, the per-round compute ``rounds`` times."""
        if n_active_clients <= 0 or rounds <= 0:
            return 0.0
        return self.decode_dispatch + rounds * self.decode_round_time(
            n_active_clients
        )

    # ------------------------------------------------------------------ #
    # Mixed-batch model (continuous batching: prefill inside decode)     #
    # ------------------------------------------------------------------ #
    @property
    def mixed_overhead_time(self) -> float:
        return (
            self.mixed_overhead
            if self.mixed_overhead is not None else self.decode_overhead
        )

    @property
    def mixed_decode_row_time(self) -> float:
        return (
            self.mixed_decode_per_row
            if self.mixed_decode_per_row is not None else self.decode_per_token
        )

    @property
    def mixed_prefill_token_time(self) -> float:
        """Decode-latency inflation per co-scheduled prefill token — the
        marginal price the ``prefill_share`` policies trade against."""
        return (
            self.mixed_prefill_per_token
            if self.mixed_prefill_per_token is not None
            else self.prefill_per_token
        )

    def mixed_round_time(self, n_decode: int, n_prefill_tokens: int) -> float:
        """One mixed round: ``n_decode`` decode rows plus ``n_prefill_tokens``
        prefill-chunk tokens in a single dispatch."""
        if n_decode <= 0 and n_prefill_tokens <= 0:
            return 0.0
        return (
            self.mixed_overhead_time
            + self.mixed_decode_row_time * max(n_decode, 0)
            + self.mixed_prefill_token_time * max(n_prefill_tokens, 0)
        )

    # ------------------------------------------------------------------ #
    # Levels (y_{k,l} in the MIP; jit buckets in the engine)             #
    # ------------------------------------------------------------------ #
    @property
    def levels(self) -> List[PrefillLevel]:
        return [
            PrefillLevel(index=l, cap_tokens=cap, duration_s=self.prefill_time(cap))
            for l, cap in enumerate(self.level_caps)
        ]

    @property
    def max_level(self) -> PrefillLevel:
        """Level L = argmax_l N_l^cap (used by the lower bound, Eq. 31)."""
        return self.levels[-1]

    def level_for(self, total_tokens: int) -> PrefillLevel:
        """Smallest level whose capacity fits ``total_tokens``.

        Raises if the batch exceeds the largest capacity — callers must split
        batches to the max level first (the simulator/engine do).
        """
        for lv in self.levels:
            if total_tokens <= lv.cap_tokens:
                return lv
        raise ValueError(
            f"prefill batch of {total_tokens} tokens exceeds max level "
            f"capacity {self.max_level.cap_tokens}"
        )

    def quantized_prefill_time(self, total_tokens: int) -> float:
        """T_l^p of the level the batch lands in (Eq. 5)."""
        return self.level_for(total_tokens).duration_s

    # ------------------------------------------------------------------ #
    # Aggregates used by schedulers                                      #
    # ------------------------------------------------------------------ #
    def decode_time_per_token_amortized(self, n_clients: int) -> float:
        """System-time to decode one token when n_clients run in parallel."""
        if n_clients <= 0:
            raise ValueError("n_clients must be positive")
        return self.decode_round_time(n_clients) / n_clients

    def estimated_decode_completion(self, n_decode: int, n_clients: int) -> float:
        """T_i of the offline model (Eq. 28): a client's *wall-clock* decode
        time for a request. Clients decode in lockstep rounds (one token per
        round), so a request of N_i^d tokens occupies its client for N_i^d
        rounds, each of the full-batch round duration."""
        return n_decode * self.decode_round_time(n_clients)

    # ------------------------------------------------------------------ #
    # Calibration (the paper's 400-group linear fit; engine profiler)    #
    # ------------------------------------------------------------------ #
    @staticmethod
    def fit_mixed_params(
        mixed_samples: Sequence[Tuple[int, int, float]],
    ) -> Optional[Tuple[float, float, float]]:
        """Separable mixed-batch fit → (overhead, per_decode_row,
        per_prefill_token), or None when the samples cannot identify the
        model (fewer than 3, or no variation in one of the regressors —
        lstsq on a collinear column returns a silently wrong minimum-norm
        solution)."""
        if len(mixed_samples) < 3:
            return None
        nd = np.asarray([s[0] for s in mixed_samples], dtype=np.float64)
        npf = np.asarray([s[1] for s in mixed_samples], dtype=np.float64)
        ym = np.asarray([s[2] for s in mixed_samples], dtype=np.float64)
        if len(set(nd.tolist())) < 2 or len(set(npf.tolist())) < 2:
            return None
        a = np.vstack([np.ones_like(nd), nd, npf]).T
        (oh, row, tok), *_ = np.linalg.lstsq(a, ym, rcond=None)
        return float(max(oh, 0.0)), float(max(row, 0.0)), float(max(tok, 0.0))

    @staticmethod
    def fit(
        prefill_samples: Sequence[Tuple[int, float]],
        decode_samples: Sequence[Tuple],
        level_caps: Sequence[int] = (512, 1024, 2048, 3072, 4096, 5000),
        decode_dispatch: float = 2e-3,
        mixed_samples: Sequence[Tuple[int, int, float]] = (),
    ) -> "CostModel":
        """Least-squares fit of measured stage samples → CostModel.

        ``prefill_samples``: (total_tokens, stage_seconds) pairs.
        ``decode_samples``: (n_active_clients, stage_seconds) pairs (one
        round) or (n_active_clients, rounds, stage_seconds) triples (fused
        stages). With ≥ 2 distinct horizons the fit is the 3-parameter model

            T(n, K) = dispatch + K · (overhead + per_token · n)

        which separates the per-dispatch host cost from per-round compute —
        the quantity the horizon-pricing policy needs. With a single horizon
        the dispatch column is collinear with the overhead column, so the fit
        degrades to the paper's 2-parameter per-round model and keeps
        ``decode_dispatch`` at the caller-provided prior.

        ``mixed_samples``: (n_decode_rows, n_prefill_tokens, seconds) triples
        from mixed-step stages. With enough variation in *both* regressors
        (≥ 3 samples, ≥ 2 distinct values each) the separable model
        ``t(n_d, n_p) = overhead + per_row·n_d + per_token·n_p`` is fit and
        the share-pricing policy adapts online; otherwise the mixed constants
        stay derived from the stage-level model.
        """

        def linfit(samples: Sequence[Tuple[int, float]]) -> Tuple[float, float]:
            if len(samples) < 2:
                raise ValueError("need >= 2 samples for a linear fit")
            x = np.asarray([s[0] for s in samples], dtype=np.float64)
            y = np.asarray([s[1] for s in samples], dtype=np.float64)
            a = np.vstack([x, np.ones_like(x)]).T
            (slope, intercept), *_ = np.linalg.lstsq(a, y, rcond=None)
            return float(slope), float(max(intercept, 0.0))

        p_slope, p_int = linfit(prefill_samples)

        tri = [(s[0], 1, s[1]) if len(s) == 2 else tuple(s) for s in decode_samples]
        if len(tri) < 2:
            raise ValueError("need >= 2 samples for a linear fit")
        n = np.asarray([s[0] for s in tri], dtype=np.float64)
        k = np.asarray([s[1] for s in tri], dtype=np.float64)
        y = np.asarray([s[2] for s in tri], dtype=np.float64)
        # the 3-parameter model needs ≥ 3 samples AND ≥ 2 distinct horizons
        # to be determined; lstsq on fewer returns a silently wrong
        # minimum-norm solution
        if len(tri) >= 3 and len(set(k.tolist())) >= 2:
            a = np.vstack([np.ones_like(k), k, k * n]).T
            (disp, d_int, d_slope), *_ = np.linalg.lstsq(a, y, rcond=None)
            decode_dispatch = float(max(disp, 0.0))
            d_int, d_slope = float(max(d_int, 0.0)), float(d_slope)
        else:
            # normalize to per-round times and fit the 2-parameter model
            d_slope, d_int = linfit(list(zip(n.tolist(), (y / k).tolist())))

        m_oh = m_row = m_tok = None
        mixed_fit = CostModel.fit_mixed_params(mixed_samples)
        if mixed_fit is not None:
            m_oh, m_row, m_tok = mixed_fit
        return CostModel(
            prefill_per_token=p_slope,
            prefill_overhead=p_int,
            decode_per_token=d_slope,
            decode_overhead=d_int,
            decode_dispatch=decode_dispatch,
            mixed_overhead=m_oh,
            mixed_decode_per_row=m_row,
            mixed_prefill_per_token=m_tok,
            level_caps=tuple(level_caps),
        )


# Paper Table III constants, importable by name.
PAPER_COST_MODEL = CostModel()
