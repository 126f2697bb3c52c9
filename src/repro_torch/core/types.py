"""Core datatypes for the hybrid offline-online LLM inference scheduler.

These types are framework-agnostic (pure Python) so the same scheduler code
drives both the event-driven simulator (paper reproduction) and the real JAX
serving engine (``repro.serving.engine``).

Notation follows the paper (TABLE II):
  I  — set of requests, each with prefill tokens N_i^p and decode tokens N_i^d
  J  — set of clients (= decode batch slots in the engine)
  K  — bins; bin k = one prefill stage followed by one decode stage
  L  — prefill levels (token-capacity buckets with duration T_l^p)
"""
from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field, asdict
from typing import Dict, List, Optional, Sequence, Tuple


class Phase(enum.Enum):
    """Lifecycle phase of a request."""

    WAITING = "waiting"      # not yet prefilled
    PREFILL = "prefill"      # currently in a prefill stage
    DECODE = "decode"        # prefilled, decoding (possibly preempted)
    DONE = "done"


class StageKind(enum.Enum):
    """PD-Competition stage type — the system runs exactly one at a time.

    ``MIXED`` is the continuous-batching stage the mixed-step engine path
    dispatches: one decode round for every active slot *plus* a budget of
    prefill-chunk tokens co-processed in the same call, so prefill
    piggybacks on decode instead of preempting it.
    """

    PREFILL = "prefill"
    DECODE = "decode"
    MIXED = "mixed"


@dataclass
class Request:
    """One inference request.

    ``n_decode`` is the *true* output length (unknown to the scheduler until
    the EOS materializes); ``n_decode_est`` is what offline planning may use
    (the paper plans with estimates and executes under uncertainty).
    """

    rid: int
    n_prefill: int
    n_decode: int
    n_decode_est: Optional[int] = None
    arrival: float = 0.0
    # Latency SLOs (None = no deadline declared). ``ttft_slo_s`` bounds
    # time-to-first-token (first token time − arrival); ``tbt_slo_s`` bounds
    # the request's mean time-between-tokens. Goodput counts only the output
    # tokens of requests that met every SLO they declared (HyGen's metric).
    ttft_slo_s: Optional[float] = None
    tbt_slo_s: Optional[float] = None
    # Shared-prefix identity: the first ``prefix_len`` prompt tokens are
    # drawn from the group's stream instead of the request's own, so
    # requests in the same group share a byte-identical prompt prefix the
    # prefix cache can serve. Both are workload identity (like n_prefill),
    # not execution bookkeeping — reset() leaves them alone and prompts
    # stay reconstructible from the Request after migration or restore.
    prefix_group: Optional[int] = None
    prefix_len: int = 0

    # Execution bookkeeping (filled by simulator/engine).
    client: Optional[int] = None
    prefill_bin: Optional[int] = None
    decoded: int = 0
    t_prefill_start: Optional[float] = None
    t_prefill_end: Optional[float] = None
    t_done: Optional[float] = None
    # First-token time: set at the FIRST prefill completion only. Preemption
    # recomputes a prefill (t_prefill_end moves), but TTFT is pinned to when
    # the request's first token actually emerged.
    t_first_token: Optional[float] = None
    # Times this request was preempted from a bound slot (pages evicted,
    # re-queued with its generated prefix). A preempted request re-prefills,
    # so trace validation expects 1 + preemptions prefill completions.
    preemptions: int = 0
    # Times this request was pulled off a SUSPECT replica's queue and
    # re-placed on a healthy one (deadline-aware backoff redispatch). The
    # request never started on the suspect, so redispatch — unlike
    # preemption — changes no prefill accounting.
    redispatches: int = 0
    # Prompt tokens served from the prefix cache at the last admission
    # (pages adopted instead of recomputed). Execution bookkeeping for
    # cache-aware pricing — every layer that prices prefill should charge
    # ``uncached_prefill``, not the nominal prompt length.
    cached_prefill: int = 0

    def __post_init__(self) -> None:
        if self.n_prefill <= 0:
            raise ValueError(f"request {self.rid}: n_prefill must be positive")
        if self.n_decode <= 0:
            raise ValueError(f"request {self.rid}: n_decode must be positive")
        if not 0 <= self.prefix_len <= self.n_prefill:
            raise ValueError(
                f"request {self.rid}: prefix_len {self.prefix_len} outside "
                f"[0, n_prefill={self.n_prefill}]"
            )
        if self.n_decode_est is None:
            self.n_decode_est = self.n_decode

    @property
    def total_tokens(self) -> int:
        return self.n_prefill + self.n_decode

    @property
    def est_total_tokens(self) -> int:
        return self.n_prefill + int(self.n_decode_est or self.n_decode)

    @property
    def remaining_decode(self) -> int:
        return self.n_decode - self.decoded

    @property
    def uncached_prefill(self) -> int:
        """Prompt tokens that actually need compute given the last cache
        probe/admission — what cache-aware pricing charges for prefill."""
        return max(self.n_prefill - self.cached_prefill, 0)

    def _t_first(self) -> Optional[float]:
        # executors that predate first-token tracking (the simulator) only
        # stamp t_prefill_end — equivalent when nothing is ever preempted
        if self.t_first_token is not None:
            return self.t_first_token
        return self.t_prefill_end

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token (None until the first token emerges)."""
        t1 = self._t_first()
        if t1 is None:
            return None
        return t1 - self.arrival

    @property
    def mean_tbt(self) -> Optional[float]:
        """Mean time between tokens over the decode phase, preemption gaps
        included (an evicted request honestly pays its recompute delay
        here). None until done; 0.0 for single-token outputs."""
        t1 = self._t_first()
        if self.t_done is None or t1 is None:
            return None
        if self.n_decode <= 1:
            return 0.0
        return (self.t_done - t1) / (self.n_decode - 1)

    @property
    def has_slo(self) -> bool:
        return self.ttft_slo_s is not None or self.tbt_slo_s is not None

    @property
    def slo_attained(self) -> bool:
        """True when every declared SLO was met (vacuously true with none
        declared). An unfinished request with a deadline counts as missed."""
        if self.ttft_slo_s is not None:
            if self.ttft is None or self.ttft > self.ttft_slo_s:
                return False
        if self.tbt_slo_s is not None:
            tbt = self.mean_tbt
            if tbt is None or tbt > self.tbt_slo_s:
                return False
        return True

    def reset(self) -> None:
        """Clear execution bookkeeping (so one workload can be re-simulated)."""
        self.client = None
        self.prefill_bin = None
        self.decoded = 0
        self.t_prefill_start = None
        self.t_prefill_end = None
        self.t_done = None
        self.t_first_token = None
        self.preemptions = 0
        self.redispatches = 0
        self.cached_prefill = 0


@dataclass
class ClientState:
    """State of one client (batch slot)."""

    cid: int
    current: Optional[Request] = None        # request being decoded
    backlog: List[Request] = field(default_factory=list)  # offline-assigned queue
    busy_time: float = 0.0                   # accumulated busy client-time

    @property
    def idle(self) -> bool:
        return self.current is None

    def remain_token(self) -> int:
        """Expected remaining tokens in this client's backlog (Algorithm 1)."""
        return sum(r.est_total_tokens for r in self.backlog)


@dataclass
class StageRecord:
    """One executed stage, for the Gantt chart and utilization accounting."""

    kind: StageKind
    t_start: float
    t_end: float
    bin_index: int
    # Clients busy during this stage and the request they worked on.
    busy: Dict[int, int] = field(default_factory=dict)  # cid -> rid
    # Clients running a *non-final* prefill chunk (chunked-prefill engine):
    # they are busy for utilization accounting but the request is not yet
    # fully prefilled — validate() counts a request's prefill at the stage
    # where its last chunk lands (the stage that puts it in ``busy``).
    busy_partial: Dict[int, int] = field(default_factory=dict)  # cid -> rid
    tokens: int = 0          # tokens processed in this stage
    rounds: int = 0          # decode rounds contained (decode stages only)
    level: Optional[int] = None  # prefill level index (prefill stages only)
    # Mixed stages: prefill-chunk tokens co-processed with the decode round
    # (tokens - chunk_tokens = decode tokens emitted), and the requests whose
    # *final* chunk landed here (validate counts their prefill at this stage;
    # a mixed stage's ``busy`` also holds slots that were merely decoding).
    chunk_tokens: int = 0
    prefilled: Dict[int, int] = field(default_factory=dict)  # cid -> rid
    # True when prefill work was pending or in flight while this stage ran —
    # the "during a prefill burst" tag the latency benchmarks slice on.
    burst: bool = False

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start


@dataclass
class ScheduleTrace:
    """Full execution trace of one simulated (or real) serve run."""

    num_clients: int
    stages: List[StageRecord] = field(default_factory=list)
    requests: List[Request] = field(default_factory=list)
    decision_times_ms: List[float] = field(default_factory=list)
    policy_name: str = ""
    # Executor-side counters that have no stage-level representation (the
    # engine fills e.g. mixed_rounds / prefill_stall_time_s); merged into
    # ``summary()`` so serve() results carry them without schema changes.
    meta: Dict[str, float] = field(default_factory=dict)
    # rid -> prefill completions the request performed on OTHER traces
    # before it was live-migrated (KV page-copy) into this one. A migrated
    # request arrives mid-decode without ever prefilling here, so validate()
    # credits these against the 1 + preemptions expectation; the exporter
    # drops the request from its own trace, keeping fleet-level accounting
    # exactly-once.
    external_prefills: Dict[int, int] = field(default_factory=dict)

    @property
    def makespan(self) -> float:
        return self.stages[-1].t_end if self.stages else 0.0

    @property
    def total_prefill_time(self) -> float:
        """Wall-clock spent on prefill work; a MIXED stage contributes its
        duration weighted by the chunk-token share of the batch."""
        out = 0.0
        for s in self.stages:
            if s.kind is StageKind.PREFILL:
                out += s.duration
            elif s.kind is StageKind.MIXED and s.tokens > 0:
                out += s.duration * s.chunk_tokens / s.tokens
        return out

    @property
    def total_decode_time(self) -> float:
        """Wall-clock spent on decode work (MIXED stages weighted by their
        decode-token share)."""
        out = 0.0
        for s in self.stages:
            if s.kind is StageKind.DECODE:
                out += s.duration
            elif s.kind is StageKind.MIXED and s.tokens > 0:
                out += s.duration * (s.tokens - s.chunk_tokens) / s.tokens
        return out

    @property
    def busy_client_time(self) -> float:
        """Σ over stages of (busy clients × stage duration)."""
        return sum(
            (len(s.busy) + len(s.busy_partial)) * s.duration for s in self.stages
        )

    @property
    def idle_gap_time(self) -> float:
        """Wall-clock inside the makespan during which NO stage ran.

        Closed-loop serves tile the timeline and report 0 here. Open-loop
        serves fast-forward the stage clock across empty arrival gaps (the
        engine idles until ``next_arrival``), which leaves real holes between
        consecutive stages — forced idle the *workload* caused, not the
        scheduler. Splitting it out lets ``utilization`` (the paper's
        closed-loop Gantt metric, gaps included) and
        ``busy_window_utilization`` (gaps excluded — how well the scheduler
        used the time it actually had work) be reported side by side instead
        of silently conflated.
        """
        if not self.stages:
            return 0.0
        gap = max(self.stages[0].t_start, 0.0)
        prev_end = self.stages[0].t_end
        for s in self.stages[1:]:
            gap += max(s.t_start - prev_end, 0.0)
            prev_end = s.t_end
        return gap

    @property
    def busy_window(self) -> float:
        """Makespan minus forced-idle arrival gaps: the wall-clock during
        which at least one stage was running."""
        return self.makespan - self.idle_gap_time

    @property
    def utilization(self) -> float:
        """Busy client-time over total client-time — the paper's Gantt metric.

        Includes forced-idle arrival gaps in the denominator (an open-loop
        serve that waits for traffic reports lower utilization); see
        ``busy_window_utilization`` for the gap-excluded view.
        """
        if not self.stages:
            return 0.0
        return self.busy_client_time / (self.makespan * self.num_clients)

    @property
    def busy_window_utilization(self) -> float:
        """Busy client-time over the busy window (arrival gaps excluded) —
        the scheduler-quality metric an open-loop run should be judged on.
        Equal to ``utilization`` for closed-loop serves (no gaps)."""
        window = self.busy_window
        if window <= 0:
            return 0.0
        return self.busy_client_time / (window * self.num_clients)

    @property
    def computed_prefill_tokens(self) -> int:
        """Prefill tokens that actually ran through the model: PREFILL-stage
        tokens plus the chunk share of MIXED stages. Cached (prefix-cache
        adopted) tokens never enter a stage, so utilization accounting sees
        only real work — the cached count is reported beside this
        (``cached_prefill_tokens`` in meta / summary), never inside it."""
        return sum(
            s.tokens if s.kind is StageKind.PREFILL else s.chunk_tokens
            for s in self.stages
            if s.kind in (StageKind.PREFILL, StageKind.MIXED)
        )

    @property
    def cached_prefill_tokens(self) -> int:
        """Prompt tokens served from the prefix cache instead of computed
        (engine-filled meta counter; 0 for executors without a cache)."""
        return int(self.meta.get("cached_prefill_tokens", 0))

    @property
    def total_generated_tokens(self) -> int:
        return sum(r.n_decode for r in self.requests)

    @property
    def generation_speed(self) -> float:
        """Output tokens per second (the paper's Fig. 11 metric). Divides by
        the full makespan, arrival gaps included — the open-loop analogue is
        ``busy_window_generation_speed``."""
        if self.makespan <= 0:
            return 0.0
        return self.total_generated_tokens / self.makespan

    @property
    def busy_window_generation_speed(self) -> float:
        """Output tokens per second of *busy* wall-clock (arrival gaps
        excluded) — what the engine sustains while it actually has work."""
        window = self.busy_window
        if window <= 0:
            return 0.0
        return self.total_generated_tokens / window

    @property
    def num_bins(self) -> int:
        return 1 + max((s.bin_index for s in self.stages), default=-1)

    # -- SLO attainment + goodput (the overload-control objective) ------ #
    @property
    def slo_tracked_requests(self) -> List[Request]:
        """Requests that declared at least one SLO."""
        return [r for r in self.requests if r.has_slo]

    @property
    def slo_attainment(self) -> float:
        """Fraction of SLO-declaring requests that met every declared SLO
        (1.0 when none declared any — nothing to miss)."""
        tracked = self.slo_tracked_requests
        if not tracked:
            return 1.0
        return sum(r.slo_attained for r in tracked) / len(tracked)

    @property
    def goodput_tokens(self) -> int:
        """Output tokens of requests that met their SLOs (requests with no
        SLO count in full — there was no deadline to miss)."""
        return sum(r.n_decode for r in self.requests if r.slo_attained)

    @property
    def goodput(self) -> float:
        """SLO-attaining output tokens per second of makespan (HyGen's
        goodput). Equals ``generation_speed`` when every SLO is met or no
        request declared one; the gap between the two is the throughput
        the serve delivered too late to count."""
        if self.makespan <= 0:
            return 0.0
        return self.goodput_tokens / self.makespan

    def ttft_p95(self) -> float:
        """p95 TTFT over SLO-tracked requests (0.0 with none tracked)."""
        vals = sorted(
            r.ttft for r in self.slo_tracked_requests if r.ttft is not None
        )
        if not vals:
            return 0.0
        return vals[min(len(vals) - 1, int(0.95 * len(vals)))]

    @property
    def preemption_count(self) -> int:
        return sum(r.preemptions for r in self.requests)

    def summary(self) -> Dict[str, float]:
        return {
            "policy": self.policy_name,
            "num_requests": len(self.requests),
            "num_clients": self.num_clients,
            "num_bins": self.num_bins,
            "makespan_s": round(self.makespan, 4),
            "utilization": round(self.utilization, 6),
            "busy_window_utilization": round(self.busy_window_utilization, 6),
            "idle_gap_s": round(self.idle_gap_time, 4),
            "generation_speed_tok_s": round(self.generation_speed, 3),
            "busy_window_generation_speed_tok_s": round(
                self.busy_window_generation_speed, 3
            ),
            "goodput_tok_s": round(self.goodput, 3),
            "slo_attainment": round(self.slo_attainment, 6),
            "slo_tracked": len(self.slo_tracked_requests),
            "preemptions": self.preemption_count,
            "prefill_time_s": round(self.total_prefill_time, 4),
            "decode_time_s": round(self.total_decode_time, 4),
            # cached vs computed prefill: cached tokens were adopted from
            # the prefix cache, not processed — they are not "busy" work
            "computed_prefill_tokens": self.computed_prefill_tokens,
            "cached_prefill_tokens": self.cached_prefill_tokens,
            "max_decision_ms": round(max(self.decision_times_ms), 4)
            if self.decision_times_ms
            else 0.0,
            "mean_decision_ms": round(
                sum(self.decision_times_ms) / len(self.decision_times_ms), 5
            )
            if self.decision_times_ms
            else 0.0,
            # meta is declared Dict[str, float] and summary() guarantees it:
            # only scalar leaves pass through. Structured event records
            # (fault logs, fenced logs, ...) belong in the observability
            # registry's typed log side-channel (repro.obs), never here.
            **{
                k: v for k, v in self.meta.items()
                if isinstance(v, (int, float, bool))
            },
        }

    def validate(self) -> None:
        """Invariant checks (used by tests and after every simulation).

        - stages tile the timeline with no overlap and no negative durations
        - every request decoded exactly n_decode tokens and completed a
          prefill exactly 1 + preemptions times (each preemption-by-eviction
          recomputes the prefill from the generated prefix)
        - a client is never busy with two requests in one stage
        """
        t = 0.0
        for s in self.stages:
            if s.t_start < t - 1e-9:
                raise AssertionError(f"stage overlap at t={s.t_start} (< {t})")
            if s.duration < -1e-12:
                raise AssertionError("negative stage duration")
            t = s.t_end
        prefilled: Dict[int, int] = {}
        for s in self.stages:
            if s.busy.keys() & s.busy_partial.keys():
                raise AssertionError(
                    "client both finishing and mid-chunk in one stage"
                )
            if s.kind is StageKind.PREFILL:
                for cid, rid in s.busy.items():
                    prefilled[rid] = prefilled.get(rid, 0) + 1
            elif s.kind is StageKind.MIXED:
                # a mixed stage's ``busy`` mixes decoders with finishing
                # prefills — only ``prefilled`` names completed prefills
                for cid, rid in s.prefilled.items():
                    prefilled[rid] = prefilled.get(rid, 0) + 1
        for r in self.requests:
            expected = 1 + r.preemptions
            actual = prefilled.get(r.rid, 0) + self.external_prefills.get(r.rid, 0)
            if actual != expected:
                raise AssertionError(
                    f"request {r.rid} prefilled {actual} "
                    f"times (expected {expected} for {r.preemptions} "
                    f"preemptions; "
                    f"{self.external_prefills.get(r.rid, 0)} external)"
                )
            if r.decoded != r.n_decode:
                raise AssertionError(
                    f"request {r.rid} decoded {r.decoded}/{r.n_decode} tokens"
                )
            if r.t_done is None:
                raise AssertionError(f"request {r.rid} never finished")

    def to_json(self) -> str:
        return json.dumps(
            {
                "summary": self.summary(),
                "stages": [
                    {
                        "kind": s.kind.value,
                        "t_start": s.t_start,
                        "t_end": s.t_end,
                        "bin": s.bin_index,
                        "busy": s.busy,
                        "tokens": s.tokens,
                        "rounds": s.rounds,
                        "level": s.level,
                        "chunk_tokens": s.chunk_tokens,
                    }
                    for s in self.stages
                ],
            }
        )


@dataclass
class FleetReport:
    """Aggregate of N replica ``ScheduleTrace``s — one fleet-level serve.

    Replicas run in parallel wall-clock (each trace's stage clock starts at
    0), so the fleet makespan is the *max* replica makespan, fleet busy
    client-time is the *sum* of replica busy client-times, and utilization
    divides speed-weighted busy time by makespan × speed-weighted capacity.
    ``lower_bound_s`` is ``theoretical_lower_bound`` evaluated at
    n_clients = replicas × slots for a homogeneous fleet — the whole fleet
    treated as one flat pool of clients, exactly the paper's bound — and
    ``core.hetero.hetero_theoretical_lower_bound`` (the R||Cmax
    generalization, which recovers the flat-pool bound at equal speeds)
    whenever replicas differ. Either way it is a floor no partitioned
    execution can beat (``lb_ratio`` ≥ 1 up to cost-model fit error).
    """

    policy_name: str
    n_replicas: int
    slots_per_replica: int
    traces: List[ScheduleTrace] = field(default_factory=list)
    lower_bound_s: float = 0.0
    steal_events: int = 0
    offline_solver: str = ""
    offline_gap: float = 0.0
    # Per-replica relative speeds (1.0 = baseline). Empty means homogeneous.
    # Utilization weights busy time and capacity by these factors: a
    # replica's capacity is speed × slots, and a busy-second on it is worth
    # speed × one baseline busy-second — so an idle *slow* replica wastes
    # proportionally less fleet capacity than an idle fast one, and a
    # deliberately-slow replica no longer deflates fleet utilization on an
    # otherwise well-balanced run.
    speed_factors: List[float] = field(default_factory=list)
    meta: Dict[str, float] = field(default_factory=dict)

    @property
    def total_slots(self) -> int:
        return self.n_replicas * self.slots_per_replica

    def _replica_speeds(self) -> List[float]:
        if self.speed_factors and len(self.speed_factors) == len(self.traces):
            return [float(s) for s in self.speed_factors]
        return [1.0] * len(self.traces)

    @property
    def makespan(self) -> float:
        return max((t.makespan for t in self.traces), default=0.0)

    @property
    def busy_client_time(self) -> float:
        return sum(t.busy_client_time for t in self.traces)

    @property
    def weighted_busy_client_time(self) -> float:
        """Busy client-time in *capacity units*: each replica's busy time
        weighted by its speed (a speed-0.5 replica busy for 1 s did half a
        baseline-replica-second of work)."""
        return sum(
            s * t.busy_client_time
            for s, t in zip(self._replica_speeds(), self.traces)
        )

    @property
    def weighted_capacity_slots(self) -> float:
        """Speed-weighted slot count: Σ_j speed_j × slots — the fleet's
        aggregate capacity per unit wall-clock. Equals ``total_slots`` for
        a homogeneous fleet."""
        return self.slots_per_replica * sum(self._replica_speeds())

    @property
    def utilization(self) -> float:
        """Speed-weighted fleet busy time over makespan × speed-weighted
        capacity — the paper's Gantt metric lifted to replica granularity,
        with both numerator and denominator in capacity units so mixed-speed
        fleets are judged against what they could actually do. Reduces
        exactly to Σ busy / (makespan × N·slots) when all speeds are 1.0. A
        straggler replica drags this down for everyone, which is what the
        offline bin packing + work stealing exist to prevent."""
        span = self.makespan
        cap = self.weighted_capacity_slots
        if span <= 0 or cap <= 0:
            return 0.0
        return self.weighted_busy_client_time / (span * cap)

    @property
    def busy_window_utilization(self) -> float:
        """Gap-excluded fleet utilization: speed-weighted busy client-time
        over the fleet-wide max busy window × speed-weighted capacity (see
        ``ScheduleTrace.busy_window_utilization``)."""
        window = max((t.busy_window for t in self.traces), default=0.0)
        cap = self.weighted_capacity_slots
        if window <= 0 or cap <= 0:
            return 0.0
        return self.weighted_busy_client_time / (window * cap)

    @property
    def generation_speed(self) -> float:
        span = self.makespan
        if span <= 0:
            return 0.0
        return sum(t.total_generated_tokens for t in self.traces) / span

    @property
    def goodput(self) -> float:
        """Fleet goodput: SLO-attaining output tokens across every replica
        per second of fleet makespan (replicas run in parallel)."""
        span = self.makespan
        if span <= 0:
            return 0.0
        return sum(t.goodput_tokens for t in self.traces) / span

    @property
    def slo_attainment(self) -> float:
        tracked = [r for t in self.traces for r in t.slo_tracked_requests]
        if not tracked:
            return 1.0
        return sum(r.slo_attained for r in tracked) / len(tracked)

    @property
    def preemption_count(self) -> int:
        return sum(t.preemption_count for t in self.traces)

    @property
    def lb_ratio(self) -> float:
        """Fleet makespan over the flat-pool lower bound (≥ 1 ideally)."""
        if self.lower_bound_s <= 0:
            return 0.0 if self.makespan <= 0 else float("inf")
        return self.makespan / self.lower_bound_s

    def summary(self) -> Dict[str, float]:
        per_replica = [t.summary() for t in self.traces]
        return {
            "policy": self.policy_name,
            "n_replicas": self.n_replicas,
            "slots_per_replica": self.slots_per_replica,
            "num_requests": sum(len(t.requests) for t in self.traces),
            "makespan_s": round(self.makespan, 4),
            "fleet_utilization": round(self.utilization, 6),
            "busy_window_utilization": round(self.busy_window_utilization, 6),
            "generation_speed_tok_s": round(self.generation_speed, 3),
            "goodput_tok_s": round(self.goodput, 3),
            "slo_attainment": round(self.slo_attainment, 6),
            "preemptions": self.preemption_count,
            "lower_bound_s": round(self.lower_bound_s, 4),
            "lb_ratio": round(self.lb_ratio, 4),
            "steal_events": self.steal_events,
            "offline_solver": self.offline_solver,
            "offline_gap": round(self.offline_gap, 6),
            "speed_factors": [round(s, 4) for s in self.speed_factors],
            "replica_makespans_s": [round(t.makespan, 4) for t in self.traces],
            "replica_requests": [len(t.requests) for t in self.traces],
            "replica_summaries": per_replica,
            # scalar leaves only — structured logs live in the observability
            # registry's typed side-channel (repro.obs), never in meta
            **{
                k: v for k, v in self.meta.items()
                if isinstance(v, (int, float, bool))
            },
        }

    def validate(self) -> None:
        """Fleet-level invariants: every replica trace is internally valid,
        and no request appears in (was served by) two replicas."""
        seen: Dict[int, int] = {}
        for idx, t in enumerate(self.traces):
            t.validate()
            for r in t.requests:
                if r.rid in seen:
                    raise AssertionError(
                        f"request {r.rid} served by replicas "
                        f"{seen[r.rid]} and {idx}"
                    )
                seen[r.rid] = idx


def make_requests(
    prefill_lens: Sequence[int],
    decode_lens: Sequence[int],
    decode_ests: Optional[Sequence[int]] = None,
) -> List[Request]:
    """Convenience constructor used by tests and workload generators."""
    if len(prefill_lens) != len(decode_lens):
        raise ValueError("prefill/decode length mismatch")
    reqs = []
    for i, (p, d) in enumerate(zip(prefill_lens, decode_lens)):
        est = None if decode_ests is None else int(decode_ests[i])
        reqs.append(Request(rid=i, n_prefill=int(p), n_decode=int(d), n_decode_est=est))
    return reqs
