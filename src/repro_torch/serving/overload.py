"""Overload control: throttle *offline* backlog admission under SLO pressure.

The hybrid serve co-locates an offline backlog (arrival <= 0, no deadline
pressure) with latency-sensitive online arrivals. Under KV-pool or arrival
overload the right degradation is to defer offline work — it has no deadline
to miss — rather than let it occupy slots and pages that online requests need
to hit their TTFT SLOs (HyGen, arXiv 2501.14808: goodput, not throughput, is
the objective once SLOs exist).

An ``OverloadPolicy`` sits on the engine's admission path: every admission
round the engine offers it the list of (client, request) pairs it is about to
start, and the policy may defer some of them back to the queue. The base
class is a pass-through (SLO-blind ablation); ``SLOAwareOverloadPolicy``
defers *offline* pairs whenever recent online TTFT attainment is close to the
SLO boundary, or an already-queued online request has waited long enough that
admitting more offline work would push it over its deadline.

Only offline requests are ever deferred — online admission is never throttled
here (shedding online load is a policy decision this repo leaves to the
caller), so the policy can only improve online TTFT at the cost of offline
completion time.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, List, Tuple

from ..core.types import Request

# (client, request) admission pair as the engine builds it; typed loosely so
# this module does not import the engine.
AdmissionPair = Tuple[object, Request]


def is_offline(req: Request) -> bool:
    """Offline backlog = present at t=0 with no TTFT deadline attached."""
    return req.arrival <= 0.0 and req.ttft_slo_s is None


class OverloadPolicy:
    """Admission filter. Base class admits everything (SLO-blind)."""

    name = "none"

    def filter_admissions(
        self, pairs: List[AdmissionPair], now: float, engine
    ) -> List[AdmissionPair]:
        """Return the subset of ``pairs`` to admit this round (order
        preserved). Deferred pairs stay queued and are re-offered next
        round — deferral is never a drop."""
        return pairs

    def record_ttft(self, ttft: float, slo: float) -> None:
        """Engine callback at each first-token completion of an SLO-carrying
        request."""


class SLOAwareOverloadPolicy(OverloadPolicy):
    """Defer offline admission when online TTFT nears its SLO.

    Two triggers, either one defers all offline pairs in the round:

      * **Attainment pressure** — the p95 of the last ``window`` observed
        online TTFT/SLO ratios is at or above ``headroom`` (deadlines are
        within (1 - headroom) of being missed on the recent record).
      * **Queue pressure** — some arrived, still-queued online request has
        already waited ``headroom`` of its TTFT budget; giving a slot to
        offline work now would likely push it over. Before any TTFT has
        been observed, an arrived waiting online request triggers this
        unconditionally (cold-start conservatism: with no evidence the
        SLO is being met, the policy does not gamble the first arrival).

    Offline requests are only deferred while pressure persists; once online
    TTFTs recover the backlog drains normally, so every request still
    completes (graceful degradation, not load shedding).
    """

    name = "slo_aware"

    def __init__(self, headroom: float = 0.85, window: int = 32):
        if not 0.0 < headroom <= 1.0:
            raise ValueError("headroom must be in (0, 1]")
        self.headroom = headroom
        self.window = window
        self._ratios: Deque[float] = deque(maxlen=window)
        self.deferrals = 0

    def record_ttft(self, ttft: float, slo: float) -> None:
        if slo > 0:
            self._ratios.append(ttft / slo)

    def _attainment_pressure(self) -> bool:
        if not self._ratios:
            return False
        ratios = sorted(self._ratios)
        p95 = ratios[min(len(ratios) - 1, int(0.95 * len(ratios)))]
        return p95 >= self.headroom

    def _queue_pressure(self, now: float, engine) -> bool:
        for req in engine.queued_requests():
            if req.ttft_slo_s is None or req.arrival <= 0:
                continue
            if req.arrival > now:
                continue                    # not arrived yet in virtual time
            if not self._ratios:
                # cold start: an online request is waiting and there is no
                # attainment evidence yet — defer conservatively until the
                # first measured TTFTs show the SLO is comfortably met
                # (without this the first arrival always rides blind, and
                # one guaranteed miss is exactly what the policy exists to
                # prevent)
                return True
            if now - req.arrival >= self.headroom * req.ttft_slo_s:
                return True
        return False

    def _online_still_coming(self, engine) -> bool:
        """Any online request still queued (arrived or future)? Deferral
        with nothing left to protect would only idle slots and stretch the
        makespan — once the last online request is admitted, the offline
        backlog drains at full speed regardless of past attainment."""
        return any(not is_offline(r) for r in engine.queued_requests())

    def filter_admissions(
        self, pairs: List[AdmissionPair], now: float, engine
    ) -> List[AdmissionPair]:
        if not any(is_offline(req) for _, req in pairs):
            return pairs
        if not self._online_still_coming(engine):
            return pairs
        att = self._attainment_pressure()
        queue = att or self._queue_pressure(now, engine)
        if att or queue:
            kept = [(c, r) for c, r in pairs if not is_offline(r)]
            deferred = [r.rid for _, r in pairs if is_offline(r)]
            self.deferrals += len(deferred)
            obs = getattr(engine, "obs", None)
            if obs is not None:
                obs.audit_record(
                    "overload_defer", now, getattr(engine, "obs_replica", 0),
                    {
                        "deferred_rids": deferred,
                        "attainment_pressure": bool(att),
                        "queue_pressure": bool(queue and not att),
                        "headroom": self.headroom,
                        "observed_ttft_ratios": len(self._ratios),
                    },
                    "defer_offline",
                )
            return kept
        return pairs
