"""Online iteration scheduling — when to preempt decode and insert prefill.

The decision runs at every decode-round boundary (the paper's ~50 ms cadence)
and must return within the real-time budget (<10 ms; measured <5 ms, see
``benchmarks``). Policies:

  * ``PrefillFirstPolicy``   — the vLLM-style baseline: insert a prefill stage
    whenever any client is idle and a request is waiting.
  * ``LagrangianPolicy``     — the paper's rule (Eqs. 41–43): compare the
    marginal makespan cost of a prefill stage, C_p = T_l^p (the *level*
    duration of the candidate batch — levels quantize the decision exactly as
    y_{k,l} does in the MIP), against the waited decode value it unlocks,
    C_d = T^d Σ_{i∈batch} N_i^d. Prefill iff C_p < C_d.
  * Beyond-paper policies (§EXPERIMENTS.md §Beyond-paper):
      - ``UtilizationWeightedPolicy`` — weighs the prefill stall by the number
        of clients it stalls vs the idleness it cures.
      - ``DynamicBatchPolicy`` — the paper's future-work #3: caps concurrent
        clients dynamically from the memory/throughput trade-off.

All policies are pure functions of a small ``SystemSnapshot``, so the same
code runs in the simulator and in the real engine's dispatch loop.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

from .cost_model import CostModel
from .types import Request


@dataclass
class CandidateBatch:
    """Prefill batch the request scheduler proposes for the idle clients.

    ``chunk_tokens`` is set by the chunked-prefill engine: the tokens the
    *next stage* would actually process (one chunk per request), which may be
    far fewer than the batch's full prompts. Policies must price the stage
    they are deciding on, so cost comparisons use
    ``effective_prefill_tokens`` — with whole-prompt prefill the two are
    identical, with chunking the marginal stage is one chunk round (this is
    what lets a Lagrangian-style rule interleave prefill work without
    stalling decode for a whole prompt; HyGen §4)."""

    requests: List[Request]
    client_ids: List[int]
    chunk_tokens: Optional[int] = None
    # Prompt tokens across the batch the prefix cache will supply (the
    # engine probes its index when building the candidate; 0 with no cache
    # or under the cache-blind pricing ablation). Cached tokens are never
    # computed, so policies pricing outstanding prefill work must charge
    # ``uncached_prefill_tokens``, not the nominal prompt lengths.
    cached_tokens: int = 0

    @property
    def total_prefill_tokens(self) -> int:
        return sum(r.n_prefill for r in self.requests)

    @property
    def uncached_prefill_tokens(self) -> int:
        """Outstanding prefill tokens that actually need compute — nominal
        prompt lengths minus what the prefix cache covers."""
        return max(self.total_prefill_tokens - self.cached_tokens, 0)

    @property
    def effective_prefill_tokens(self) -> int:
        """Tokens the next prefill stage would run: one chunk round when the
        engine chunks, the full prompts otherwise."""
        if self.chunk_tokens is not None:
            return self.chunk_tokens
        return self.total_prefill_tokens

    @property
    def total_decode_est(self) -> int:
        return sum(int(r.n_decode_est or r.n_decode) for r in self.requests)

    def __bool__(self) -> bool:
        return bool(self.requests)


@dataclass
class SystemSnapshot:
    """Everything an iteration policy may look at (cheap scalars only)."""

    n_clients: int
    n_active: int                     # clients currently decoding
    n_idle: int
    active_remaining_est: int         # Σ estimated remaining decode tokens (active)
    pending_requests: int             # requests not yet prefilled (global)
    candidate: CandidateBatch         # what a prefill stage would run *now*
    now: float                        # current sim/wall time (seconds)


@dataclass(frozen=True)
class Decision:
    """One iteration-level scheduling decision.

    ``prefill`` chooses the stage kind (the paper's binary choice);
    ``horizon`` is how many decode iterations to commit to one fused
    on-device dispatch when ``prefill`` is False. Horizon 1 reproduces the
    per-token baseline (one host sync per decoded token).

    ``chunk_tokens`` carries the *mixed-step* split: how many prefill-chunk
    tokens to co-schedule inside the next decode round (one unified
    dispatch — prefill piggybacks on decode instead of preempting it). It
    is only set when the engine offers a mixed budget; > 0 means "run a
    mixed round with this share", 0 falls through to pure (fused) decode.
    The binary ``prefill`` choice is the degenerate case: share = whole
    budget when there is nothing to decode, share = 0 when there is nothing
    to prefill."""

    prefill: bool
    horizon: int = 1
    chunk_tokens: int = 0


class IterationPolicy:
    name = "base"
    # SLO-urgency coupling for the mixed-step share (see ``_slo_urgency``).
    # Instances may set False for the SLO-blind ablation — requests still
    # *carry* their SLOs for goodput accounting; the scheduler just stops
    # looking at them.
    slo_urgency: bool = True

    def decide_prefill(self, snap: SystemSnapshot, cost_model: CostModel) -> bool:
        """True → insert a prefill stage now; False → run a decode round."""
        raise NotImplementedError

    def _slo_urgency(self, snap: SystemSnapshot) -> float:
        """How close the candidate's most-pressed request is to blowing its
        TTFT deadline: max over candidates of elapsed / ttft_slo (0.0 with
        no deadlines in view). Crossing 1.0 means a deadline already passed.
        The share pricing multiplies its admission-pressure weight w by
        (1 + urgency), so a request nearing its deadline outbids the decode
        latency it inflates — the graceful-degradation half of overload
        control (the other half, offline admission throttling, lives in
        ``serving.overload``)."""
        if not self.slo_urgency:
            return 0.0
        u = 0.0
        for r in snap.candidate.requests:
            if r.ttft_slo_s is not None and r.ttft_slo_s > 0:
                u = max(u, (snap.now - r.arrival) / r.ttft_slo_s)
        return max(0.0, u)

    def decode_horizon(
        self, snap: SystemSnapshot, cost_model: CostModel, k_max: int = 1
    ) -> int:
        """Decode iterations to fuse into the next dispatch (1 ≤ K ≤ k_max).

        Default: the Lagrangian-style marginal rule shared by every policy.
        Fusing one more iteration saves amortized dispatch cost
        d/dK [C_dispatch·(1−1/K)] = C_dispatch/K², but commits the engine one
        round longer before it can reconsider — if prefill-ready work exists
        (or can appear when a slot frees mid-horizon), that delay costs an
        expected  w·t_round/2  of stalled prefill, with w the admission
        pressure (pending work per client slot). Equating the marginals
        prices the horizon in closed form:

            K* = sqrt(2·C_dispatch / (w·t_round))

        With no pending work there is nothing to preempt for (w→0, K*→∞) and
        the horizon saturates at ``k_max``; under heavy admission pressure
        K*→1 recovers the paper's per-iteration granularity.
        """
        if k_max <= 1:
            return 1
        # Prefill-ready work = queued requests OR an already-materialized
        # candidate (e.g. a long prompt's remaining chunks after the queue
        # drained) — either one makes delaying the next decision costly.
        waiters = max(snap.pending_requests, len(snap.candidate.requests))
        if waiters <= 0:
            return k_max
        w = min(1.0, waiters / max(snap.n_clients, 1))
        t_round = cost_model.decode_round_time(max(snap.n_active, 1))
        if t_round <= 0 or cost_model.decode_dispatch <= 0:
            return 1
        k_star = (2.0 * cost_model.decode_dispatch / (w * t_round)) ** 0.5
        return max(1, min(k_max, int(k_star)))

    def prefill_share(
        self,
        snap: SystemSnapshot,
        cost_model: CostModel,
        budget: int,
        explain: Optional[dict] = None,
    ) -> int:
        """Prefill-chunk tokens to co-schedule into the next *mixed* round
        (0 ≤ share ≤ budget) — the Lagrangian turned from a binary stage
        switch into a continuous knob.

        In a mixed batch nothing stalls: co-scheduling n prefill tokens
        merely inflates the round by t_p·n (every active decoder waits that
        much longer for its next token), while the waiting prompts' time to
        first token shrinks as their P outstanding tokens flow at n per
        round. The marginal decode-latency cost of the n-th chunk token is
        flat, n_active·t_p; the marginal queueing gain is diminishing,
        w·P·t_0/n² (finishing P tokens takes P·t_0/n + P·t_p seconds of
        round overhead, weighted by the admission pressure w = waiters per
        slot). Equating the marginals prices the share in closed form:

            n* = sqrt(w · P · t_0 / (n_active · t_p))

        with t_0 the pure-decode round time and t_p the cost model's fitted
        per-prefill-token inflation. With no active decoders there is no
        latency to protect (n*→∞ — take the whole budget); under heavy
        decode load with a trickle of prefill work n*→0 and the engine runs
        pure fused decode. The paper's binary choice survives as the two
        saturated ends of this knob.
        """
        def _out(share: int, rule: str, **priced) -> int:
            # audit-log hook: when the engine passes an ``explain`` dict the
            # priced inputs and chosen share are recorded alongside it
            if explain is not None:
                explain.update(
                    rule=rule, budget=budget, share=share,
                    n_active=snap.n_active, pending=snap.pending_requests,
                    candidate=len(snap.candidate.requests), **priced,
                )
            return share

        if budget <= 0:
            return _out(0, "no_budget")
        if snap.n_active == 0:
            # nothing decoding — nothing to inflate
            return _out(budget, "no_active_decoders")
        waiters = max(snap.pending_requests, len(snap.candidate.requests))
        if waiters <= 0:
            return _out(0, "no_waiters")
        w = min(1.0, waiters / max(snap.n_clients, 1))
        # SLO-urgency: a candidate nearing its TTFT deadline raises the
        # admission-pressure weight past its nominal [0, 1] cap, so the
        # priced share grows ~sqrt(1 + urgency) and the deadline outbids
        # the decode latency it inflates.
        urgency = self._slo_urgency(snap)
        w = w * (1.0 + urgency)
        t0 = cost_model.mixed_round_time(snap.n_active, 0)
        tp = cost_model.mixed_prefill_token_time
        if tp <= 0:
            # a noisy fit can clamp the mixed slope to exactly 0 — fall
            # back to the stage-level slope rather than pricing chunk
            # tokens as free (which would take the max share every round)
            tp = cost_model.prefill_per_token
        if t0 <= 0:
            t0 = cost_model.decode_round_time(snap.n_active)
        # P = outstanding prefill tokens that will actually flow through
        # mixed rounds: cache-adopted tokens never run, so pricing them
        # would buy decode-latency inflation for work that does not exist
        p_out = max(
            snap.candidate.uncached_prefill_tokens,
            snap.candidate.effective_prefill_tokens,
        )
        if t0 <= 0 or tp <= 0:
            return _out(budget, "degenerate_fit", w=w, t0=t0, tp=tp)
        n_star = (w * p_out * t0 / (snap.n_active * tp)) ** 0.5
        return _out(
            min(budget, int(n_star)), "lagrangian_share",
            w=w, urgency=urgency, p_out=p_out, t0=t0, tp=tp, n_star=n_star,
        )

    def decide(
        self,
        snap: SystemSnapshot,
        cost_model: CostModel,
        k_max: int = 1,
        mixed_budget: Optional[int] = None,
        explain: Optional[dict] = None,
    ) -> Decision:
        """Stage choice plus the decode horizon to run if decoding.

        ``mixed_budget`` switches to mixed-step semantics: instead of the
        binary prefill-vs-decode choice the policy prices the prefill-token
        share of one unified dispatch (``chunk_tokens``); 0 falls back to a
        pure fused-decode stage at the priced horizon. ``explain``, when a
        dict, is filled with the share evaluation's priced inputs (the
        engine forwards it to the observability audit log)."""
        if mixed_budget is not None:
            share = min(
                self.prefill_share(snap, cost_model, mixed_budget, explain),
                mixed_budget,
            )
            if share > 0:
                return Decision(prefill=False, horizon=1, chunk_tokens=share)
            return Decision(
                prefill=False,
                horizon=self.decode_horizon(snap, cost_model, k_max),
            )
        if self(snap, cost_model):
            return Decision(prefill=True)
        return Decision(
            prefill=False, horizon=self.decode_horizon(snap, cost_model, k_max)
        )

    def __call__(self, snap: SystemSnapshot, cost_model: CostModel) -> bool:
        # Progress guarantees, shared by all policies:
        if not snap.candidate:
            return False                      # nothing to prefill
        if snap.n_active == 0:
            return True                       # nothing to decode — must prefill
        return self.decide_prefill(snap, cost_model)


class PrefillFirstPolicy(IterationPolicy):
    """Baseline: prefill whenever possible (FCFS prefill-first, §I)."""

    name = "prefill_first"

    def decide_prefill(self, snap: SystemSnapshot, cost_model: CostModel) -> bool:
        return True

    def prefill_share(
        self,
        snap: SystemSnapshot,
        cost_model: CostModel,
        budget: int,
        explain: Optional[dict] = None,
    ) -> int:
        # mixed-step analogue of "prefill whenever possible": take the
        # whole chunk budget every round, regardless of latency inflation
        share = max(budget, 0)
        if explain is not None:
            explain.update(rule="prefill_first", budget=budget, share=share)
        return share


class DecodeFirstPolicy(IterationPolicy):
    """Anti-baseline for ablations: only prefill when forced."""

    name = "decode_first"

    def decide_prefill(self, snap: SystemSnapshot, cost_model: CostModel) -> bool:
        return False

    def prefill_share(
        self,
        snap: SystemSnapshot,
        cost_model: CostModel,
        budget: int,
        explain: Optional[dict] = None,
    ) -> int:
        # only co-schedule prefill when there is nothing to decode at all
        share = max(budget, 0) if snap.n_active == 0 else 0
        if explain is not None:
            explain.update(
                rule="decode_first", budget=budget, share=share,
                n_active=snap.n_active,
            )
        return share


class LagrangianPolicy(IterationPolicy):
    """The paper's heuristic (Eqs. 41–43).

    C_p = T_l^p for the smallest level fitting the candidate batch (Eq. 42 —
    the marginal makespan cost of opening prefill stage k at level l).
    C_d = T^d Σ_i N_i^d over the candidate's requests (Eq. 43 — the decode
    time the batch will contribute; inserting the prefill *now* unlocks it).

    If C_p ≥ C_d: continue decoding and accumulate more waiters (the stage
    overhead isn't amortized yet); else execute the prefill stage.

    Progress refinement: when no further waiters can arrive (pending ≤ idle
    slots — the drain phase of an offline batch), waiting is pointless and
    the candidate is admitted immediately. Without this the rule strands the
    last sub-threshold request until all decodes finish, serializing its
    entire decode onto the makespan.
    """

    name = "lagrangian"

    def decide_prefill(self, snap: SystemSnapshot, cost_model: CostModel) -> bool:
        if snap.pending_requests <= snap.n_idle:
            return True  # drain phase: no future waiters to amortize with
        batch_tokens = snap.candidate.effective_prefill_tokens
        if batch_tokens >= cost_model.max_level.cap_tokens:
            return True  # batch already fills the largest level
        c_p = cost_model.quantized_prefill_time(batch_tokens)
        c_d = cost_model.decode_per_token * snap.candidate.total_decode_est
        return c_p < c_d


class BalancedLagrangianPolicy(IterationPolicy):
    """Beyond-paper fix of the Lagrangian rule's starvation mode.

    The paper's rule compares C_p (level duration) to C_d (decode work of the
    *candidate batch*). The candidate is capacity-capped at N_L^cap tokens,
    so C_d ≤ T^d · N_L^cap · (N̄_d / N̄_p): for prompt-heavy workloads
    (N_d/N_p below T_L^p / (T^d·N_L^cap) ≈ 0.64 at the paper's constants)
    C_d can NEVER exceed C_p and the system starves — refills only happen
    through the n_active==0 guard, and utilization collapses (measured 39.9%
    vs 64.9% prefill-first on a long-prompt workload; EXPERIMENTS.md
    §Beyond-paper).

    Fix: when the candidate is *capacity-saturated* (more waiters exist than
    the batch can take), waiting cannot grow the batch — fire immediately.
    On decode-heavy workloads (GSM8K) the guard never triggers and behaviour
    is identical to the paper's rule.
    """

    name = "balanced_lagrangian"

    def decide_prefill(self, snap: SystemSnapshot, cost_model: CostModel) -> bool:
        if snap.pending_requests <= snap.n_idle:
            return True
        cand = snap.candidate
        # capacity saturation: idle clients + pending work exist beyond the
        # batch → the batch cannot grow by waiting
        if snap.n_idle > len(cand.requests) and snap.pending_requests > len(cand.requests):
            return True
        batch_tokens = cand.effective_prefill_tokens
        if batch_tokens >= cost_model.max_level.cap_tokens:
            return True
        c_p = cost_model.quantized_prefill_time(batch_tokens)
        c_d = cost_model.decode_per_token * cand.total_decode_est
        return c_p < c_d


class AmortizedPolicy(IterationPolicy):
    """Beyond-paper: fire at the analytically-optimal batch size k*.

    Deferring a prefill by one decode round wastes k · t_r of idle
    client-time (k waiters idle for the round) but saves stage overhead by
    batching more waiters. With completion rate λ per round, gathering k
    waiters costs ≈ k²·t_r/(2λ) of idle time while merging saves
    (k−1)·T_oh·n_active of stall; balancing marginals gives

        k* = sqrt(2 · λ · n_active · T_oh / t_r)

    (≈9 at the paper's constants vs the Lagrangian's ≈2). Inherits the
    saturation and drain guards.
    """

    name = "amortized"

    def decide_prefill(self, snap: SystemSnapshot, cost_model: CostModel) -> bool:
        if snap.pending_requests <= snap.n_idle:
            return True
        cand = snap.candidate
        if snap.n_idle > len(cand.requests) and snap.pending_requests > len(cand.requests):
            return True
        if cand.effective_prefill_tokens >= cost_model.max_level.cap_tokens:
            return True
        t_r = cost_model.decode_round_time(max(snap.n_active, 1))
        # completion rate: active clients finishing per round
        mean_remaining = snap.active_remaining_est / max(snap.n_active, 1)
        lam = snap.n_active / max(mean_remaining, 1.0)
        k_star = (2.0 * lam * snap.n_active * cost_model.prefill_overhead / t_r) ** 0.5
        return len(cand.requests) >= max(1.0, k_star)


class UtilizationWeightedPolicy(IterationPolicy):
    """Beyond-paper: weigh stall and idleness by the clients they touch.

    Inserting a prefill of duration C_p stalls the n_active decoders:
    wasted client-time = n_active * C_p. NOT inserting leaves the candidate's
    n_cand clients idle for at least one more decode round t_r, and (if we
    never insert) forfeits C_d of useful decode: waste ≈ n_cand * t_r
    accumulating each round. Prefill when the per-round idle waste exceeds
    the amortized stall:

        n_cand * t_r  ≥  n_active * C_p / max(1, E[rounds between prefills])

    We approximate the amortization horizon by the candidate's mean decode
    length (a batch admitted now keeps its clients busy that long).
    """

    name = "utilization_weighted"

    def decide_prefill(self, snap: SystemSnapshot, cost_model: CostModel) -> bool:
        cand = snap.candidate
        batch_tokens = cand.effective_prefill_tokens
        if batch_tokens >= cost_model.max_level.cap_tokens:
            return True
        c_p = cost_model.quantized_prefill_time(batch_tokens)
        t_r = cost_model.decode_round_time(snap.n_active)
        n_cand = len(cand.requests)
        mean_decode = cand.total_decode_est / max(1, n_cand)
        horizon_rounds = max(1.0, mean_decode)
        idle_waste_per_round = n_cand * t_r
        stall_amortized = snap.n_active * c_p / horizon_rounds
        return idle_waste_per_round >= stall_amortized


class DynamicBatchPolicy(IterationPolicy):
    """Beyond-paper (paper §VI future work #3): dynamic client count.

    Wraps an inner policy but refuses to admit new requests once the active
    count reaches a dynamically-chosen cap. The cap maximizes decode
    throughput per round: tokens/s = n / (T_oh + T_tok * n) is increasing in
    n, so the cap is only binding when the *tail* is near — then admitting
    more requests prolongs the tail; we cap admission so the last requests
    finish together (see EXPERIMENTS.md §Beyond-paper).
    """

    name = "dynamic_batch"

    def __init__(self, inner: Optional[IterationPolicy] = None):
        self.inner = inner or LagrangianPolicy()
        self.name = f"dynamic_batch({self.inner.name})"

    def decide_prefill(self, snap: SystemSnapshot, cost_model: CostModel) -> bool:
        # Tail detection: fewer pending requests than idle slots means the
        # run is draining; admit immediately to keep the tail short.
        if snap.pending_requests <= snap.n_idle:
            return True
        return self.inner.decide_prefill(snap, cost_model)

    def prefill_share(
        self,
        snap: SystemSnapshot,
        cost_model: CostModel,
        budget: int,
        explain: Optional[dict] = None,
    ) -> int:
        if snap.pending_requests <= snap.n_idle:
            share = max(budget, 0)         # drain phase: admit immediately
            if explain is not None:
                explain.update(rule="drain_phase", budget=budget, share=share)
            return share
        return self.inner.prefill_share(snap, cost_model, budget, explain)


class TimedPolicy(IterationPolicy):
    """Decorator measuring per-decision wall time (the <5 ms claim)."""

    def __init__(self, inner: IterationPolicy):
        self.inner = inner
        self.name = inner.name
        self.decision_times_ms: List[float] = []

    def __call__(self, snap: SystemSnapshot, cost_model: CostModel) -> bool:
        t0 = time.perf_counter()
        out = self.inner(snap, cost_model)
        self.decision_times_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def decide(
        self,
        snap: SystemSnapshot,
        cost_model: CostModel,
        k_max: int = 1,
        mixed_budget: Optional[int] = None,
        explain: Optional[dict] = None,
    ) -> Decision:
        # time the full engine-facing decision: under mixed-step scheduling
        # the binary __call__ path never runs, so without this override a
        # mixed serve would record no decision times at all
        t0 = time.perf_counter()
        out = self.inner.decide(snap, cost_model, k_max, mixed_budget, explain)
        self.decision_times_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def decide_prefill(self, snap: SystemSnapshot, cost_model: CostModel) -> bool:
        return self.inner.decide_prefill(snap, cost_model)

    def decode_horizon(
        self, snap: SystemSnapshot, cost_model: CostModel, k_max: int = 1
    ) -> int:
        return self.inner.decode_horizon(snap, cost_model, k_max)

    def prefill_share(
        self,
        snap: SystemSnapshot,
        cost_model: CostModel,
        budget: int,
        explain: Optional[dict] = None,
    ) -> int:
        return self.inner.prefill_share(snap, cost_model, budget, explain)


POLICIES = {
    "prefill_first": PrefillFirstPolicy,
    "decode_first": DecodeFirstPolicy,
    "lagrangian": LagrangianPolicy,
    "balanced_lagrangian": BalancedLagrangianPolicy,
    "amortized": AmortizedPolicy,
    "utilization_weighted": UtilizationWeightedPolicy,
    "dynamic_batch": DynamicBatchPolicy,
}


def make_policy(name: str) -> IterationPolicy:
    if name not in POLICIES:
        raise KeyError(f"unknown policy {name!r}; have {sorted(POLICIES)}")
    return POLICIES[name]()
