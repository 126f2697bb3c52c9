"""Failure detection without an oracle: heartbeat/suspicion health monitoring
(counterpart of ``repro.serving.health``, numpy-free and copied near
verbatim).

Everything the fleet knew about failures through PR 7 came from a fault
*plan*: ``Fleet._apply_due_faults`` fired each ``ReplicaFault`` at its
declared instant, so recovery was triggered by an oracle. Production fleets
mostly die the other way — hangs and gray failures, a replica that stops
making progress (or degrades ×4) without ever announcing it. This module is
the observer that replaces the oracle:

  * **Heartbeats** — the fleet stamps one per replica at every stage
    boundary, in fleet virtual time (``beat``). Replicas idling with no
    work beat passively when the fleet advances their clocks; a hung
    replica stamps nothing, which is the whole signal.
  * **Adaptive suspicion** — per replica, the monitor learns the observed
    inter-beat gap distribution (windowed mean + deviation, phi-accrual
    style) and scores the current silence against it:
    ``score = (now - last_beat - mean) / spread``. SUSPECT at
    ``suspect_sigma``, CONDEMNED at ``condemn_sigma``. Thresholds adapt to
    the workload: a replica running long prefill chunks earns a wide
    expected gap, one running tight decode rounds a narrow one — which is
    exactly what a fixed timeout cannot do.
  * **Degraded (gray) detection** — each work-beat also carries the stage's
    measured duration and the duration the replica's own ``CostModel``
    predicted for that stage's composition. The ratio (observed/predicted)
    is a dimensionless slowdown sample; its running level is compared
    against a baseline captured from the replica's own early samples, so
    systematic model-fit error cancels and an intrinsically slow replica is
    NOT flagged — only a *change* is. A replica whose recent slowdown
    exceeds ``degraded_factor`` × its baseline is flagged degraded and
    moved to SUSPECT even while technically progressing.
  * **State machine** — ``ALIVE → SUSPECT → CONDEMNED``. SUSPECT is
    reversible: a beat that arrives while suspicion is below the suspect
    threshold clears the replica back to ALIVE and counts one false
    suspicion (the detector's honest error metric). CONDEMNED is terminal
    and one-way — the fleet bumps the replica's epoch and evacuates; if the
    replica was merely stalled, epoch fencing (not the detector) is what
    keeps its zombie harmless.
  * **Fixed-timeout ablation** — ``detector="fixed"`` scores silence
    against a constant ``fixed_timeout_s`` (suspect at 1×, condemn at
    ``condemn_factor``×): the naive detector an operator without gap
    statistics would deploy. ``benchmarks/detection.py`` gates that the
    adaptive detector strictly beats it on time-to-recover at token parity.

The monitor never reads the fault plan, the fault log, or any injection
state — it sees only beats and the clock. ``state_dict``/``load_state_dict``
round-trip every cursor so a restored fleet resumes suspicion where it left
off (a SUSPECT replica must not wake up ALIVE).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

ALIVE = "alive"
SUSPECT = "suspect"
CONDEMNED = "condemned"


@dataclasses.dataclass
class HealthConfig:
    """Detector selection + thresholds (all in fleet virtual seconds).

    ``detector="adaptive"`` scores silence against the learned per-replica
    gap distribution; ``"fixed"`` against ``fixed_timeout_s`` (the naive
    ablation). ``warmup_beats`` gates condemnation until the gap window has
    real samples — before that the monitor may suspect but never condemns.
    ``redispatch_backoff_s`` is the grace a SUSPECT replica's queued work
    waits before re-placement, in case the suspicion clears; a request
    whose TTFT deadline would expire within ``deadline_slack_s`` skips the
    backoff (deadline-aware redispatch)."""

    detector: str = "adaptive"            # "adaptive" | "fixed"
    suspect_sigma: float = 6.0            # adaptive: suspicion z to SUSPECT
    condemn_sigma: float = 12.0           # adaptive: suspicion z to CONDEMN
    min_spread_frac: float = 0.25         # spread floor, as fraction of mean
    gap_window: int = 32                  # gap samples kept per replica
    warmup_beats: int = 4                 # beats before condemnation allowed
    fixed_timeout_s: float = 0.25         # fixed: silence to SUSPECT
    condemn_factor: float = 2.0           # fixed: condemn at factor × timeout
    degraded_factor: float = 3.0          # slowdown vs own baseline
    degraded_window: int = 8              # slowdown rolling-median window
    baseline_beats: int = 6               # slowdown samples fixing baseline
    redispatch_backoff_s: float = 0.05    # SUSPECT queue re-placement grace
    deadline_slack_s: float = 0.0         # TTFT margin that skips the backoff

    def __post_init__(self) -> None:
        if self.detector not in ("adaptive", "fixed"):
            raise ValueError(f"unknown detector {self.detector!r}")
        if self.condemn_sigma <= self.suspect_sigma:
            raise ValueError("condemn_sigma must exceed suspect_sigma")
        if self.fixed_timeout_s <= 0:
            raise ValueError("fixed_timeout_s must be positive")
        if self.condemn_factor <= 1.0:
            raise ValueError("condemn_factor must exceed 1.0")
        if self.degraded_factor <= 1.0:
            raise ValueError("degraded_factor must exceed 1.0")


@dataclasses.dataclass
class _ReplicaHealth:
    """Per-replica monitor cursors (one heartbeat ledger)."""

    state: str = ALIVE
    last_beat_s: float = 0.0
    beats: int = 0
    gaps: List[float] = dataclasses.field(default_factory=list)
    suspect_since: Optional[float] = None
    suspect_reason: str = ""
    degraded: bool = False
    # slowdown = observed stage duration / cost-model-predicted duration;
    # ``baseline`` is the median of the replica's own first samples, so a
    # systematically mispredicted (or intrinsically slow) replica is not
    # flagged — only a departure from its own normal is.
    slowdown_level: Optional[float] = None
    slowdown_baseline: Optional[float] = None
    slowdown_samples: List[float] = dataclasses.field(default_factory=list)
    # cost-model fit the baseline was captured under (profiler refit
    # counter); a refit invalidates the baseline — see ``_note_slowdown``
    model_version: int = -1


class ReplicaHealthMonitor:
    def __init__(self, n_replicas: int, cfg: Optional[HealthConfig] = None):
        self.cfg = cfg or HealthConfig()
        self.n_replicas = n_replicas
        self.replicas = [_ReplicaHealth() for _ in range(n_replicas)]
        self.suspect_events = 0
        self.false_suspicions = 0
        self.condemned_events = 0
        self.degraded_events = 0
        self.transitions: List[Dict[str, Any]] = []
        # observability sink (repro_torch.obs.Observation), set by the fleet
        # when a serve opts in; None executes zero obs callbacks
        self.obs = None

    # ------------------------------------------------------------------ #
    # Observation                                                        #
    # ------------------------------------------------------------------ #
    def reset(self) -> None:
        self.__init__(self.n_replicas, self.cfg)

    def state(self, i: int) -> str:
        return self.replicas[i].state

    def is_healthy(self, i: int) -> bool:
        """Dispatch/steal eligibility: ALIVE and not flagged degraded."""
        return self.replicas[i].state == ALIVE

    def beat(
        self,
        i: int,
        t: float,
        duration_s: Optional[float] = None,
        predicted_s: Optional[float] = None,
        model_version: int = 0,
    ) -> None:
        """One heartbeat for replica ``i`` at fleet virtual time ``t``.

        Work-beats (a stage completed) pass the stage's measured
        ``duration_s`` and, when the replica's cost model could price the
        stage, its ``predicted_s`` — feeding the gray-failure slowdown
        signal. ``model_version`` identifies the cost-model fit the
        prediction came from (the profiler's refit counter): when it
        changes, the slowdown baseline is recaptured, because a baseline
        taken under the old fit no longer cancels the new fit's systematic
        error. Idle beats (no work, clock advanced by the fleet) pass
        neither: they assert liveness without polluting the duration
        statistics."""
        r = self.replicas[i]
        if r.state == CONDEMNED:
            return                        # terminal; late beats are fenced
        gap = max(t - r.last_beat_s, 0.0)
        # same-instant beats (an idle replica re-asserting liveness before
        # fleet time moved) carry no cadence information — recording their
        # zero gaps would collapse the learned distribution toward 0 and
        # make any real stage look like silence
        if r.beats > 0 and gap > 0.0:
            r.gaps.append(gap)
            if len(r.gaps) > self.cfg.gap_window:
                del r.gaps[: len(r.gaps) - self.cfg.gap_window]
        r.last_beat_s = max(r.last_beat_s, t)
        r.beats += 1
        if duration_s is not None and predicted_s is not None and predicted_s > 0:
            self._note_slowdown(i, duration_s / predicted_s, t, model_version)
        # a beat while SUSPECT (and not degraded) clears the suspicion if
        # the silence score has dropped back under the suspect threshold
        if r.state == SUSPECT and not r.degraded:
            if self.suspicion(i, t) < self._suspect_threshold():
                self._transition(i, ALIVE, t, "beat resumed")
                self.false_suspicions += 1
                r.suspect_since = None
                r.suspect_reason = ""

    def _note_slowdown(
        self, i: int, slowdown: float, t: float, model_version: int
    ) -> None:
        r = self.replicas[i]
        cfg = self.cfg
        if model_version != r.model_version:
            # the cost model was refit: predictions changed scale, so the
            # baseline (whose whole job is cancelling the fit's systematic
            # error) must be recaptured under the new fit. Note this also
            # means a refit that has absorbed a degradation un-flags it —
            # the detector targets the transition window, the period before
            # the profiler normalizes the new slowness into "expected".
            r.model_version = model_version
            r.slowdown_baseline = None
            r.slowdown_samples = []
        if r.slowdown_baseline is None:
            r.slowdown_samples.append(slowdown)
            if len(r.slowdown_samples) >= cfg.baseline_beats:
                ordered = sorted(r.slowdown_samples)
                r.slowdown_baseline = max(ordered[len(ordered) // 2], 1e-9)
                r.slowdown_samples = []
                r.slowdown_level = r.slowdown_baseline
            return
        # rolling median over the recent window, NOT an EWMA: measured
        # stage durations carry one-off spikes (first-hit compiles, host
        # jitter) large enough to drag any mean past the threshold — a
        # median needs half the window genuinely slow before it moves
        r.slowdown_samples.append(slowdown)
        if len(r.slowdown_samples) > cfg.degraded_window:
            del r.slowdown_samples[
                : len(r.slowdown_samples) - cfg.degraded_window
            ]
        ordered = sorted(r.slowdown_samples)
        r.slowdown_level = ordered[len(ordered) // 2]  # reported level
        was = r.degraded
        r.degraded = (
            len(r.slowdown_samples) >= cfg.degraded_window
            and r.slowdown_level > cfg.degraded_factor * r.slowdown_baseline
        )
        if r.degraded and not was:
            self.degraded_events += 1
            if r.state == ALIVE:
                self._suspect(i, t, "degraded")
        elif was and not r.degraded and r.state == SUSPECT and (
            r.suspect_reason == "degraded"
        ):
            self._transition(i, ALIVE, t, "slowdown recovered")
            self.false_suspicions += 1
            r.suspect_since = None
            r.suspect_reason = ""

    # ------------------------------------------------------------------ #
    # Scoring                                                            #
    # ------------------------------------------------------------------ #
    def _gap_stats(self, i: int) -> tuple:
        r = self.replicas[i]
        if not r.gaps:
            return 0.0, self.cfg.fixed_timeout_s
        mean = sum(r.gaps) / len(r.gaps)
        var = sum((g - mean) ** 2 for g in r.gaps) / len(r.gaps)
        spread = max(var ** 0.5, self.cfg.min_spread_frac * mean, 1e-9)
        return mean, spread

    def _suspect_threshold(self) -> float:
        return (
            self.cfg.suspect_sigma
            if self.cfg.detector == "adaptive" else 1.0
        )

    def _condemn_threshold(self) -> float:
        return (
            self.cfg.condemn_sigma
            if self.cfg.detector == "adaptive" else self.cfg.condemn_factor
        )

    def suspicion(self, i: int, now: float) -> float:
        """The continuous suspicion score for replica ``i`` at ``now``.

        Adaptive: the silence z-score against the learned gap distribution.
        Fixed: silence / fixed_timeout_s. Both are 0-anchored — a replica
        beating at its usual cadence scores ~0 regardless of detector."""
        r = self.replicas[i]
        silence = max(now - r.last_beat_s, 0.0)
        if self.cfg.detector == "fixed":
            return silence / self.cfg.fixed_timeout_s
        mean, spread = self._gap_stats(i)
        return (silence - mean) / spread

    # ------------------------------------------------------------------ #
    # Evaluation (the fleet calls this once per step)                    #
    # ------------------------------------------------------------------ #
    def evaluate(self, now: float, replicas: Optional[List[int]] = None) -> List[int]:
        """Score every (given) replica's silence at fleet time ``now`` and
        run the state machine. Returns the replicas newly CONDEMNED this
        call — the fleet fences + evacuates them. Degraded flags move
        through ``beat``; this pass handles pure silence."""
        newly_condemned: List[int] = []
        for i in (replicas if replicas is not None else range(self.n_replicas)):
            r = self.replicas[i]
            if r.state == CONDEMNED:
                continue
            score = self.suspicion(i, now)
            if r.state == ALIVE and score >= self._suspect_threshold():
                self._suspect(i, now, "silence")
            if (
                r.state == SUSPECT
                and score >= self._condemn_threshold()
                and r.beats >= self.cfg.warmup_beats
            ):
                self._transition(i, CONDEMNED, now, r.suspect_reason or "silence")
                self.condemned_events += 1
                newly_condemned.append(i)
        return newly_condemned

    def _suspect(self, i: int, now: float, reason: str) -> None:
        r = self.replicas[i]
        self._transition(i, SUSPECT, now, reason)
        self.suspect_events += 1
        r.suspect_since = now
        r.suspect_reason = reason

    def _transition(self, i: int, state: str, now: float, reason: str) -> None:
        prev = self.replicas[i].state
        self.replicas[i].state = state
        self.transitions.append(
            {"replica": i, "state": state, "at_s": now, "reason": reason}
        )
        if self.obs is not None:
            self.obs.instant(
                "health_transition", now, replica=i,
                state=state, prev=prev, reason=reason,
            )
            self.obs.audit_record(
                "health_transition", now, i,
                {"prev": prev, "reason": reason}, state,
            )

    def condemn(self, i: int, now: float, reason: str = "external") -> None:
        """Force-condemn (fleet-initiated, e.g. an operator decision)."""
        r = self.replicas[i]
        if r.state == CONDEMNED:
            return
        self._transition(i, CONDEMNED, now, reason)
        self.condemned_events += 1

    # ------------------------------------------------------------------ #
    # Checkpoint                                                         #
    # ------------------------------------------------------------------ #
    def state_dict(self) -> str:
        """JSON string (fleet checkpoints flatten leaves through
        ``np.asarray``; a string survives, nested dicts would not)."""
        return json.dumps({
            "replicas": [dataclasses.asdict(r) for r in self.replicas],
            "suspect_events": self.suspect_events,
            "false_suspicions": self.false_suspicions,
            "condemned_events": self.condemned_events,
            "degraded_events": self.degraded_events,
            "transitions": self.transitions,
        })

    def load_state_dict(self, state: str) -> None:
        data = json.loads(state)
        if len(data["replicas"]) != self.n_replicas:
            raise ValueError(
                f"health checkpoint covers {len(data['replicas'])} replicas, "
                f"monitor has {self.n_replicas}"
            )
        self.replicas = [_ReplicaHealth(**r) for r in data["replicas"]]
        self.suspect_events = int(data["suspect_events"])
        self.false_suspicions = int(data["false_suspicions"])
        self.condemned_events = int(data["condemned_events"])
        self.degraded_events = int(data["degraded_events"])
        self.transitions = list(data["transitions"])
