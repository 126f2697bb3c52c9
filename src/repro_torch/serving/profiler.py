"""Online profiler — the paper's calibration loop, live.

Measures every executed stage ((tokens, seconds) pairs for prefill stages;
(active clients, fused rounds, seconds) triples for decode stages) and
refits the linear ``CostModel`` the iteration policy consumes. This is how
the scheduler adapts to whatever hardware it actually runs on (the paper fit
400 groups offline; we fit continuously with the same least-squares model) —
and how the per-dispatch cost that prices the fused decode horizon becomes
identifiable, once stages of differing horizons have been observed.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.cost_model import CostModel


class OnlineProfiler:
    def __init__(
        self,
        initial: Optional[CostModel] = None,
        refit_every: int = 20,
        max_samples: int = 2000,
    ):
        self.cost_model = initial or CostModel()
        self.prefill_samples: List[Tuple[int, float]] = []
        # (n_active, rounds, seconds) per decode stage
        self.decode_samples: List[Tuple[int, int, float]] = []
        # (n_decode_rows, n_prefill_tokens, seconds) per mixed stage — the
        # separable mixed-batch model t(n_d, n_p) the share-pricing rule
        # consumes (see CostModel.mixed_round_time)
        self.mixed_samples: List[Tuple[int, int, float]] = []
        self.refit_every = refit_every
        self.max_samples = max_samples
        self._since_fit = 0
        self.fits = 0
        # Full prefill+decode refits only — the mixed-constants-only
        # fallback below bumps ``fits`` but leaves the prefill/decode
        # constants at the prior, so cross-replica pricing must not treat
        # it as "this replica has measured itself" (see
        # ``Fleet.pricing_cost_models``).
        self.full_fits = 0

    def record_prefill(self, total_tokens: int, seconds: float) -> None:
        self.prefill_samples.append((total_tokens, seconds))
        self._tick()

    def record_decode(self, n_active: int, seconds: float, rounds: int = 1) -> None:
        """One decode *stage*: ``rounds`` fused iterations over ``n_active``
        clients in ``seconds``. Mixed horizons are what lets the fit separate
        per-dispatch cost from per-round compute (see ``CostModel.fit``)."""
        self.decode_samples.append((n_active, rounds, seconds))
        self._tick()

    def record_mixed(
        self, n_decode: int, n_prefill_tokens: int, seconds: float
    ) -> None:
        """One mixed-step stage: ``n_decode`` decode rows co-dispatched with
        ``n_prefill_tokens`` prefill-chunk tokens in ``seconds``. Variation
        in both counts identifies the per-decode-row and per-prefill-token
        slopes the ``prefill_share`` pricing adapts to."""
        self.mixed_samples.append((n_decode, n_prefill_tokens, seconds))
        self._tick()

    def _tick(self) -> None:
        self._since_fit += 1
        if len(self.prefill_samples) > self.max_samples:
            self.prefill_samples = self.prefill_samples[-self.max_samples :]
        if len(self.decode_samples) > self.max_samples:
            self.decode_samples = self.decode_samples[-self.max_samples :]
        if len(self.mixed_samples) > self.max_samples:
            self.mixed_samples = self.mixed_samples[-self.max_samples :]
        if self._since_fit < self.refit_every:
            return
        if (
            len(set(s[0] for s in self.prefill_samples)) >= 2
            and len(set(s[0] for s in self.decode_samples)) >= 2
        ):
            try:
                self.cost_model = CostModel.fit(
                    self.prefill_samples,
                    self.decode_samples,
                    level_caps=self.cost_model.level_caps,
                    decode_dispatch=self.cost_model.decode_dispatch,
                    mixed_samples=self.mixed_samples,
                )
                self.fits += 1
                self.full_fits += 1
            except Exception:  # noqa: BLE001 — keep serving on a bad fit
                pass
            self._since_fit = 0
            return
        # The full refit needs variation in the prefill AND decode stage
        # samples, which a steady mixed-schedule serve may never produce
        # (nearly every stage feeds record_mixed) — refit just the mixed
        # constants so the share pricing still adapts online.
        params = CostModel.fit_mixed_params(self.mixed_samples)
        if params is not None:
            self.cost_model = dataclasses.replace(
                self.cost_model,
                mixed_overhead=params[0],
                mixed_decode_per_row=params[1],
                mixed_prefill_per_token=params[2],
            )
            self.fits += 1
            self._since_fit = 0

    # ------------------------------------------------------------------ #
    # Checkpoint / restore (per-replica fleet state)                     #
    # ------------------------------------------------------------------ #
    def state_dict(self) -> Dict[str, Any]:
        """The profiler's durable state as fixed-dtype numpy leaves: sample
        windows, fit counters, and the fitted cost-model constants. A
        restored heterogeneous fleet must resume each replica's *own* fit —
        reseeding from the construction prior would forget everything the
        replica learned about its hardware. Optional mixed constants encode
        as NaN (checkpoint leaves must be arrayable)."""
        cm = self.cost_model

        def opt(x: Optional[float]) -> float:
            return float("nan") if x is None else float(x)

        return {
            "prefill_samples": np.asarray(
                self.prefill_samples, dtype=np.float64
            ).reshape(-1, 2),
            "decode_samples": np.asarray(
                self.decode_samples, dtype=np.float64
            ).reshape(-1, 3),
            "mixed_samples": np.asarray(
                self.mixed_samples, dtype=np.float64
            ).reshape(-1, 3),
            "fits": self.fits,
            "full_fits": self.full_fits,
            "since_fit": self._since_fit,
            "cost_model": np.asarray(
                [
                    cm.prefill_per_token,
                    cm.prefill_overhead,
                    cm.decode_per_token,
                    cm.decode_overhead,
                    cm.decode_dispatch,
                    opt(cm.mixed_overhead),
                    opt(cm.mixed_decode_per_row),
                    opt(cm.mixed_prefill_per_token),
                ],
                dtype=np.float64,
            ),
            "level_caps": np.asarray(cm.level_caps, dtype=np.int64),
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        c = np.asarray(state["cost_model"], dtype=np.float64)

        def opt(x: float) -> Optional[float]:
            return None if np.isnan(x) else float(x)

        self.cost_model = CostModel(
            prefill_per_token=float(c[0]),
            prefill_overhead=float(c[1]),
            decode_per_token=float(c[2]),
            decode_overhead=float(c[3]),
            decode_dispatch=float(c[4]),
            mixed_overhead=opt(c[5]),
            mixed_decode_per_row=opt(c[6]),
            mixed_prefill_per_token=opt(c[7]),
            level_caps=tuple(
                int(x) for x in np.asarray(state["level_caps"])
            ),
        )
        self.prefill_samples = [
            (int(t), float(s))
            for t, s in np.asarray(state["prefill_samples"]).reshape(-1, 2)
        ]
        self.decode_samples = [
            (int(n), int(k), float(s))
            for n, k, s in np.asarray(state["decode_samples"]).reshape(-1, 3)
        ]
        self.mixed_samples = [
            (int(n), int(p), float(s))
            for n, p, s in np.asarray(state["mixed_samples"]).reshape(-1, 3)
        ]
        self.fits = int(state["fits"])
        # older checkpoints predate the counter split; treat every recorded
        # fit as full (the conservative reading would permanently hold the
        # fleet on priors instead)
        self.full_fits = int(state.get("full_fits", state["fits"]))
        self._since_fit = int(state["since_fit"])
