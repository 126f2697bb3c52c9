"""Fleet-scale serving: N ``Engine`` replicas under the paper's hybrid
offline-online scheduler, lifted one level up (counterpart of
``repro.serving.fleet``).

The paper's hybrid assigns an offline backlog across *clients* (Minimizing
Makespan Bin Packing, Eqs. 26–30) and then runs online sorting/preemptive
scheduling per client. In this repo the offline layer had only ever driven
the event-driven simulator while the real engine stayed a single replica;
the ``Fleet`` closes that gap by applying the same two ideas at replica
granularity:

  * **offline** — ``solve_offline`` (LPT + local search) partitions the
    backlog across replicas, treating each replica as one of the paper's
    "clients" (``round_robin_assign`` is the unbalanced baseline ablation,
    Fig. 6 at fleet scale). Each replica then serves its partition
    longest-first (Algorithm 1's sort).
  * **online** — arrivals route through a pluggable
    ``ReplicaDispatchPolicy``: least-estimated-load priced through each
    replica's *live fitted* cost model (HyGen-style replica-level
    dispatch), or round-robin. When a replica drains early it *steals* the
    longest not-yet-started request from the most-loaded replica's queue —
    Algorithm 1's request-level straggler mitigation, applied across
    replicas so one straggler cannot set the fleet makespan. A steal is
    only taken when the R||Cmax-priced finish time improves: the candidate
    is priced through the thief's AND the donor's own cost models before
    it moves.

**Heterogeneous fleets** (``core.hetero``): each replica owns its own
``CostModel`` + ``OnlineProfiler`` — seeded from a per-replica prior
(``ReplicaSpec.speed_factor`` scaling the base model, or an explicit
per-replica model) and refit from that replica's own stage timings. A
replica's ``speed_factor`` also scales its virtual-time stage durations,
so a mixed-generation fleet is emulatable and deterministically testable
on one host. When replicas differ, the offline partition solves R||Cmax
(``solve_hetero``: speed-scaled LPT + local search re-priced through each
replica's model) and the fleet floor is
``hetero_theoretical_lower_bound`` — both recover the paper's P||Cmax
forms exactly in the homogeneous case.

Execution model: all replicas share one set of model weights (the same
``params`` tensors on one device) but own independent KV pools / slot
managers.
One process executes every stage, interleaved in *virtual time*: the fleet
always steps the replica whose session clock is lowest, so cross-replica
decisions (arrival routing, stealing) are made at a consistent fleet-wide
"now" even though stages run sequentially. Each replica's trace clock
starts at 0 — "replicas run in parallel" — so the fleet makespan is the
max replica makespan, and fleet utilization divides the summed busy
client-time by makespan × total slots. ``FleetReport`` compares that
makespan against ``theoretical_lower_bound`` evaluated on the whole fleet
as one flat pool of N·slots clients (Eqs. 31–32), the floor no partitioned
execution can beat.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from .. import resolve_device
from ..core.cost_model import CostModel
from ..core.hetero import (
    ReplicaSpec,
    evaluate_hetero_assignment,
    hetero_theoretical_lower_bound,
    replica_request_weight,
    replica_resume_weight,
    solve_hetero,
)
from ..core.iteration import IterationPolicy, LagrangianPolicy
from ..core.offline import (
    evaluate_assignment,
    round_robin_assign,
    solve_offline,
    split_requests,
    theoretical_lower_bound,
)
from ..core.online import GlobalQueueScheduler, build_clients
from ..core.types import FleetReport, Request, StageKind
from .engine import Engine, EngineConfig
from .health import (
    ALIVE,
    CONDEMNED,
    SUSPECT,
    HealthConfig,
    ReplicaHealthMonitor,
)
from .kv_slots import PageIntegrityError
from .profiler import OnlineProfiler
from .sampler import greedy

Tree = Any

# Weight-column multiplier pricing a SUSPECT replica out of the offline
# R||Cmax solve: large enough that any trusted replica wins every
# assignment comparison, finite so a degenerate all-suspect fleet still
# partitions instead of dividing by infinity.
HEALTH_SUSPECT_PENALTY = 1024.0


# --------------------------------------------------------------------------- #
# Online replica dispatch                                                     #
# --------------------------------------------------------------------------- #
class ReplicaDispatchPolicy:
    """Chooses the replica an online arrival is admitted to."""

    name = "base"

    def choose(self, fleet: "Fleet", req: Request) -> int:
        raise NotImplementedError


class LeastLoadDispatch(ReplicaDispatchPolicy):
    """Route to the replica with the least estimated outstanding work
    (queued + in-flight, priced by each replica's *current fitted* cost
    model — so a replica whose profiler has learned it is slow prices its
    own queue accordingly) — the replica-level analogue of LPT's
    least-loaded-client rule, made speed-aware. SUSPECT replicas are
    priced out entirely (``dispatchable_replicas``): new work never lands
    on a replica the health monitor distrusts."""

    name = "least_load"

    def choose(self, fleet: "Fleet", req: Request) -> int:
        return min(
            fleet.dispatchable_replicas,
            key=lambda i: (fleet.estimated_load_s(i), i),
        )


class RoundRobinDispatch(ReplicaDispatchPolicy):
    """FCFS round-robin across replicas — the unbalanced baseline.

    The cursor is part of serve state: ``Fleet.begin_serve`` resets it and
    checkpoints carry it, so arrival routing is reproducible across serves
    and across a checkpoint/restore."""

    name = "round_robin"

    def __init__(self) -> None:
        self.cursor = 0

    def reset(self) -> None:
        self.cursor = 0

    def choose(self, fleet: "Fleet", req: Request) -> int:
        ok = set(fleet.dispatchable_replicas)
        for _ in range(fleet.n_replicas):
            i = self.cursor % fleet.n_replicas
            self.cursor += 1
            if i in ok:
                return i
        raise RuntimeError("no alive replica to dispatch to")


DISPATCH_POLICIES = {
    "least_load": LeastLoadDispatch,
    "round_robin": RoundRobinDispatch,
}


# --------------------------------------------------------------------------- #
# Fault injection                                                             #
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ReplicaFault:
    """One fault event at a virtual-time instant.

    ``kind="kill"`` removes the replica from the fleet at ``at_s``: its
    queued AND in-flight requests are recovered onto survivors (see
    ``Fleet._kill_replica``); work it had already *completed* stays
    completed — recovery is exactly-once, never re-serving a finished
    request. ``kind="slow"`` multiplies the replica's ``speed_factor`` by
    ``speed_factor`` (< 1 degrades it — e.g. thermal throttling, a noisy
    neighbor), which both stretches its virtual-time stages and, through
    its profiler's refits, repels future dispatch and invites stealing.

    ``kind="drain"`` gracefully decommissions the replica at ``at_s``
    (rolling restart): dispatch stops, its in-flight slots live-migrate to
    survivors by KV page-copy, its queued work is re-placed through the
    R||Cmax pricing, and the replica retires with zero dropped or
    recomputed tokens. ``pool_readable=True`` on a kill marks a soft
    failure (process exit, host and KV pool still reachable): recovery
    then prefers the same page-copy path, falling back to
    recompute-on-resume only when no survivor can host the pages; a hard
    kill (the default) always recomputes — the pool died with the
    replica.

    **Undeclared faults** — the failure modes the oracle never announces,
    which only the health monitor (``serving.health``) can catch:

      * ``kind="hang"`` stops the replica's progress at ``at_s`` and
        silently resumes it at ``until_s``. The fleet is NOT told: no
        ``fault_log`` entry fires, no recovery is triggered by the plan.
        The replica simply stops heartbeating; detection, condemnation,
        and evacuation are entirely the monitor's job. If it is condemned
        before ``until_s``, the wake-up is a *zombie*: its stale
        completions arrive carrying a fenced epoch and are discarded.
      * ``kind="degrade"`` multiplies the replica's ``speed_factor``
        silently (gray failure: ``speed_factor=0.25`` makes it ×4-slow but
        still progressing), restoring the original speed at ``until_s``
        when given. Unlike ``kind="slow"`` — the declared ablation —
        nothing is logged at apply time; the monitor must notice the
        observed/predicted stage-duration ratio departing from the
        replica's own baseline."""

    replica: int
    at_s: float
    kind: str = "kill"        # "kill" | "slow" | "drain" | "hang" | "degrade"
    speed_factor: float = 0.5             # for kind="slow" / "degrade"
    pool_readable: bool = False           # for kind="kill" only
    until_s: Optional[float] = None       # hang resume / degrade restore time

    def __post_init__(self):
        if self.kind not in ("kill", "slow", "drain", "hang", "degrade"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.at_s < 0:
            raise ValueError("fault time must be >= 0")
        if self.kind in ("slow", "degrade") and self.speed_factor <= 0:
            raise ValueError(f"{self.kind} fault needs a positive speed_factor")
        if self.kind == "hang":
            if self.until_s is None or self.until_s <= self.at_s:
                raise ValueError("hang fault needs until_s > at_s")
        if self.kind == "degrade" and self.until_s is not None:
            if self.until_s <= self.at_s:
                raise ValueError("degrade restore needs until_s > at_s")


@dataclasses.dataclass
class FaultPlan:
    """A deterministic schedule of replica faults, applied as the fleet's
    virtual clock crosses each ``at_s``. Determinism is the point: the same
    plan against the same workload yields the same recovery decisions, so
    fault tolerance is regression-testable (token streams must match the
    no-fault serve bit for bit)."""

    faults: List[ReplicaFault] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.faults = sorted(self.faults, key=lambda f: (f.at_s, f.replica))


@dataclasses.dataclass
class FleetConfig:
    """Fleet shape + scheduling knobs.

    ``assign`` picks the offline backlog partitioner:

      * "lpt"        — the full hybrid: ``solve_offline`` (P||Cmax LPT +
                       local search) on a homogeneous fleet, upgrading to
                       ``solve_hetero`` (R||Cmax, priced through each
                       replica's own live cost model) when replicas differ;
      * "lpt_blind"  — always the P||Cmax solve on the shared base model,
                       ignoring replica speed — the speed-blind ablation a
                       heterogeneous fleet is benchmarked against;
      * "round_robin" — the unbalanced baseline ablation.

    ``dispatch`` picks the online arrival router. Work stealing moves
    queued (not-yet-started) requests from loaded to drained replicas,
    gated on the R||Cmax-priced finish time actually improving; token
    streams are unaffected (prompts and sampling are pure functions of
    (seed, rid), independent of which replica runs them).
    """

    n_replicas: int = 2
    assign: str = "lpt"                  # "lpt" | "lpt_blind" | "round_robin"
    dispatch: str = "least_load"         # key into DISPATCH_POLICIES
    work_stealing: bool = True
    local_search_rounds: int = 200
    # In-flight rebalancing: when a starving replica finds no profitable
    # QUEUED steal, allow it to live-migrate the longest-remaining RUNNING
    # request off the most-loaded donor by KV page-copy — same double-gated
    # R||Cmax makespan check as queued stealing, but priced decode-only
    # (``replica_resume_weight``: the import skips the prefill entirely).
    # Off by default: queued-only stealing is the paper's Algorithm 1
    # baseline; ``benchmarks/chaos.py`` gates that this flag strictly
    # improves fleet makespan on the straggler-tail workload.
    steal_running: bool = False
    # Oracle-free failure detection (serving.health): when set, the fleet
    # stamps per-replica heartbeats at every stage boundary, scores silence
    # through the configured detector, prices SUSPECT replicas out of
    # dispatch/stealing, and condemns + epoch-fences + evacuates replicas
    # the monitor gives up on. None (the default) keeps the PR-7 behavior:
    # only declared faults (the plan / drain_replica calls) trigger
    # recovery.
    health: Optional[HealthConfig] = None


class Fleet:
    def __init__(
        self,
        model,
        params: Tree,
        engine_config: EngineConfig,
        fleet_config: Optional[FleetConfig] = None,
        cost_model: Optional[CostModel] = None,
        sampler: Callable = greedy,
        profiler_factory: Optional[Callable[[], OnlineProfiler]] = None,
        replica_specs: Optional[Sequence[ReplicaSpec]] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.cfg = fleet_config or FleetConfig()
        if self.cfg.n_replicas <= 0:
            raise ValueError("n_replicas must be positive")
        if self.cfg.assign not in ("lpt", "lpt_blind", "round_robin"):
            raise ValueError(f"unknown assign method {self.cfg.assign!r}")
        if self.cfg.dispatch not in DISPATCH_POLICIES:
            raise ValueError(
                f"unknown dispatch policy {self.cfg.dispatch!r}; "
                f"have {sorted(DISPATCH_POLICIES)}"
            )
        self.engine_cfg = engine_config
        # the shared *base* CostModel: the speed-1.0 prior every per-replica
        # model derives from, and what the speed-blind paths price with
        self.cost_model = cost_model or CostModel()
        if replica_specs is None:
            replica_specs = [ReplicaSpec() for _ in range(self.cfg.n_replicas)]
        self.specs: List[ReplicaSpec] = list(replica_specs)
        if len(self.specs) != self.cfg.n_replicas:
            raise ValueError(
                f"replica_specs has {len(self.specs)} entries for "
                f"{self.cfg.n_replicas} replicas"
            )
        # N replicas over ONE set of weights: `params` is passed by
        # reference, so every replica calls the model on the same tensors.
        # Each Engine owns its KV pool / slot manager AND its own profiler,
        # seeded from its replica's prior cost model — per-replica fits are
        # what make dispatch, stealing, and the R||Cmax solve speed-aware.
        # The replicas also share the decode kernels' split scratch (one a
        # device, kernels/decode_split.py): the fleet runs one replica's
        # stage at a time on one stream, so no two launches use it at once.
        # Keep it so — a second stream would race on the scratch.
        self.engines = [
            Engine(
                model, params, engine_config,
                profiler=(
                    profiler_factory()
                    if profiler_factory is not None
                    else OnlineProfiler(
                        initial=spec.resolve_cost_model(self.cost_model)
                    )
                ),
                sampler=sampler,
                speed_factor=spec.speed_factor,
                device=self.device,
            )
            for spec in self.specs
        ]
        # shared observability sink (repro_torch.obs.Observation), threaded
        # from EngineConfig.observe: ONE instance across all replicas, so a
        # request's span chain stays causal as it migrates between them
        self.obs = engine_config.observe
        for i, eng in enumerate(self.engines):
            eng.obs_replica = i
            if engine_config.kv_layout == "paged":
                eng.slots.obs_replica = i
        self.dispatcher: ReplicaDispatchPolicy = (
            DISPATCH_POLICIES[self.cfg.dispatch]()
        )
        self.steal_events = 0
        self.steal_log: List[Dict[str, int]] = []
        self._central: List[Request] = []     # future arrivals, sorted
        self._all_requests: List[Request] = []
        self._offline_result = None
        self._resumed = False
        # fault-injection state (per serve; see begin_serve / ReplicaFault)
        self._dead: set = set()
        self._drained: set = set()
        self._pending_faults: List[ReplicaFault] = []
        self.fault_log: List[Dict[str, Any]] = []
        self.recovered_requests = 0
        self._lost_preemptions = 0
        # live-migration accounting (drain / rebalancing / soft-kill paths)
        self.migration_events = 0
        self.migrated_pages = 0
        self.migration_log: List[Dict[str, Any]] = []
        # fault/drain events whose displaced requests are not all re-admitted
        # yet: entries {"entry": fault_log row, "t0": s, "pending": {rid: req}}
        # — drained when ``_note_recoveries`` sees every displaced request
        # bound/chunking on a survivor (or finished), stamping the event's
        # ``recover_s`` (time-to-recover)
        self._recovery_watch: List[Dict[str, Any]] = []
        # pricing_cost_models memo (invalidated by refits/restores via key)
        self._pricing_key: Optional[tuple] = None
        self._pricing_models: List[CostModel] = []
        # --- oracle-free health monitoring + epoch fencing (PR 8) ------- #
        self.monitor: Optional[ReplicaHealthMonitor] = (
            ReplicaHealthMonitor(self.cfg.n_replicas, self.cfg.health)
            if self.cfg.health is not None else None
        )
        if self.monitor is not None:
            self.monitor.obs = self.obs
        # per-serve frozen prediction models for the gray-failure signal:
        # the live profiler keeps refitting to *measured* stages, so a ×4
        # slowdown would be normalized into the very model it is judged
        # against within one refit cycle — predictions for health come from
        # the model as-of-serve-start instead (None until first full fit)
        self._health_cms: List[Optional[CostModel]] = (
            [None] * self.cfg.n_replicas
        )
        # per-replica fencing epoch: bumped BEFORE any evacuation moves
        # state, so every lease granted under the old epoch is dead the
        # instant recovery begins — a zombie's late completions/exports
        # carry a stale epoch and are discarded, never double-served
        self.epochs: List[int] = [0] * self.cfg.n_replicas
        # rid -> (replica, epoch): which replica may complete each request
        self._leases: Dict[int, tuple] = {}
        self.fenced_completions = 0
        self.fenced_exports = 0
        self.fenced_log: List[Dict[str, Any]] = []
        self.redispatch_events = 0
        self.redispatch_log: List[Dict[str, Any]] = []
        self.integrity_rejections = 0
        # undeclared-fault injection state (the monitor NEVER reads these)
        self._hangs: Dict[int, ReplicaFault] = {}
        self._restores: List[Dict[str, Any]] = []
        self._ghosts: Dict[int, Dict[str, Any]] = {}
        self.injected_log: List[Dict[str, Any]] = []

    @property
    def n_replicas(self) -> int:
        return self.cfg.n_replicas

    @property
    def alive_replicas(self) -> List[int]:
        """Replica indices still serving (killed ones are excluded from
        dispatch, stealing, and the step loop; their traces survive)."""
        return [i for i in range(self.cfg.n_replicas) if i not in self._dead]

    @property
    def alive_set(self) -> set:
        return set(range(self.cfg.n_replicas)) - self._dead

    @property
    def healthy_replicas(self) -> List[int]:
        """Alive replicas the health monitor currently trusts (ALIVE, not
        SUSPECT). Falls back to all alive replicas when the monitor
        distrusts everyone — work has to land somewhere."""
        alive = self.alive_replicas
        if self.monitor is None:
            return alive
        ok = [i for i in alive if self.monitor.is_healthy(i)]
        return ok or alive

    @property
    def dispatchable_replicas(self) -> List[int]:
        """Where new work may be routed: healthy replicas, which prices
        SUSPECT replicas out of dispatch entirely (they keep serving what
        they already hold until cleared or condemned)."""
        return self.healthy_replicas

    @property
    def dispatchable_set(self) -> set:
        return set(self.dispatchable_replicas)

    def health_penalties(self) -> Optional[List[float]]:
        """Per-replica weight-column multipliers for the R||Cmax solve
        (``core.hetero.hetero_weights``): 1.0 for trusted replicas, a
        large penalty for SUSPECT ones so the offline partition only
        assigns them work when capacity leaves no alternative."""
        if self.monitor is None:
            return None
        return [
            1.0 if self.monitor.is_healthy(i) else HEALTH_SUSPECT_PENALTY
            for i in range(self.cfg.n_replicas)
        ]

    @property
    def heterogeneous(self) -> bool:
        """True when any replica's construction spec differs from the
        speed-1.0 shared-model default — the trigger for the R||Cmax solver
        and lower bound. (Dispatch and stealing price through
        ``pricing_cost_models`` regardless, homogeneous or not: even
        nominally identical replicas drift apart as their profilers
        refit.)"""
        return any(
            s.speed_factor != 1.0 or s.cost_model is not None
            for s in self.specs
        )

    def pricing_cost_models(self) -> List[CostModel]:
        """The per-replica cost models every cross-replica comparison
        (dispatch load, steal gate, R||Cmax solve, fleet lower bound)
        prices through: each replica's *current fitted* model once every
        replica has FULLY refit (prefill + decode constants) from its own
        measured stages, the per-replica priors until then. The gate
        matters: paper-prior constants can sit orders of magnitude above a
        model fitted to this host, so a fleet where only SOME replicas have
        refit would compare incommensurate scales — the fitted
        (cheap-looking) replicas would absorb the whole backlog and the
        still-on-prior replicas would be starved out of ever collecting
        enough samples to fit. ``full_fits`` (not ``fits``) is the gate: a
        mixed-constants-only refit leaves the prefill/decode constants at
        the prior, which is exactly the half-measured state the gate
        exists to exclude."""
        # memoized per (full-fit counters, live model identities): dispatch
        # and stealing call this once per replica per decision, and the
        # prior branch would otherwise re-construct R scaled models each
        # time — O(R²) allocations per arrival
        key = tuple(
            (eng.profiler.fits, eng.profiler.full_fits,
             id(eng.profiler.cost_model))
            for eng in self.engines
        )
        if key == self._pricing_key:
            return self._pricing_models
        fitted = [eng.profiler.full_fits > 0 for eng in self.engines]
        if any(fitted) and not all(fitted):
            models = [
                spec.resolve_cost_model(self.cost_model) for spec in self.specs
            ]
        else:
            # all fully fitted (live, commensurate: measured on this host)
            # — or none, where each profiler still holds exactly its prior
            models = [eng.profiler.cost_model for eng in self.engines]
        self._pricing_key = key
        self._pricing_models = models
        return models

    def replica_cost_model(self, i: int) -> CostModel:
        """Replica ``i``'s current pricing model (see
        ``pricing_cost_models`` for the live-fit-vs-prior gate)."""
        return self.pricing_cost_models()[i]

    # ------------------------------------------------------------------ #
    # Load estimation (per-replica live-cost-model pricing)              #
    # ------------------------------------------------------------------ #
    def _request_weight_s(
        self, req: Request, remaining_decode: int, cm: CostModel
    ) -> float:
        # the ONE per-request pricing rule, shared with the offline weight
        # matrix (core.hetero) so solve and dispatch can never diverge
        return replica_request_weight(
            req, cm, self.engine_cfg.n_slots, remaining_decode=remaining_decode
        )

    def estimated_load_s(self, i: int) -> float:
        """Estimated seconds of outstanding work per slot on replica ``i``:
        queued requests (full weight), in-flight chunked prefills, and the
        remaining decode of every bound slot, spread over the slot count —
        the replica-level ``remain_token`` of Algorithm 1, in seconds,
        priced through replica ``i``'s own fitted cost model (a slow
        replica's queue is worth more seconds than the same queue on a
        fast one)."""
        eng = self.engines[i]
        cm = self.replica_cost_model(i)
        total = 0.0
        for r in eng._sv.scheduler.queued:
            total += self._request_weight_s(
                r, int(r.n_decode_est or r.n_decode), cm
            )
        for st in eng._chunking.values():
            total += self._request_weight_s(
                st.req, int(st.req.n_decode_est or st.req.n_decode), cm
            )
        for slot in eng.slots.active_slots:
            req = eng.slots.request_of[slot]
            rem = int(req.n_decode_est or req.n_decode) - eng.slots.emitted[slot]
            total += cm.estimated_decode_completion(
                max(rem, 0), eng.cfg.n_slots
            )
        return total / eng.cfg.n_slots

    # ------------------------------------------------------------------ #
    # Serve lifecycle                                                    #
    # ------------------------------------------------------------------ #
    def begin_serve(
        self,
        requests: Sequence[Request],
        iteration_policy_factory: Callable[[], IterationPolicy] = LagrangianPolicy,
        policy_name: str = "",
        fault_plan: Optional[FaultPlan] = None,
    ) -> None:
        """Partition the offline backlog, open every replica's serve
        session, and queue online arrivals for dispatch-on-arrival.
        ``fault_plan`` schedules replica kill/slow events against the
        fleet's virtual clock (see ``ReplicaFault``)."""
        for r in requests:
            r.reset()
        self._all_requests = list(requests)
        self.steal_events = 0
        self.steal_log = []
        self._resumed = False
        self._dead = set()
        self._pending_faults = list(fault_plan.faults) if fault_plan else []
        for f in self._pending_faults:
            if not 0 <= f.replica < self.cfg.n_replicas:
                raise ValueError(
                    f"fault targets replica {f.replica} of a "
                    f"{self.cfg.n_replicas}-replica fleet"
                )
        if len({f.replica for f in self._pending_faults
                if f.kind in ("kill", "drain")}) >= self.cfg.n_replicas:
            raise ValueError("fault plan kills or drains every replica")
        self.fault_log = []
        self.recovered_requests = 0
        self._lost_preemptions = 0
        self._drained = set()
        self.migration_events = 0
        self.migrated_pages = 0
        self.migration_log = []
        self._recovery_watch = []
        # health/fencing state is per serve: replica clocks restart at 0,
        # so heartbeat cursors and epochs from an earlier serve would be in
        # a different timebase (checkpoint restore — load_state_dict —
        # keeps them instead, which is satellite-tested)
        if self.monitor is not None:
            self.monitor.reset()
            # reset() re-runs __init__, which drops the obs attribute
            self.monitor.obs = self.obs
        self._health_cms = [
            eng.profiler.cost_model if eng.profiler.full_fits > 0 else None
            for eng in self.engines
        ]
        self.epochs = [0] * self.cfg.n_replicas
        self._leases = {}
        self.fenced_completions = 0
        self.fenced_exports = 0
        self.fenced_log = []
        self.redispatch_events = 0
        self.redispatch_log = []
        self.integrity_rejections = 0
        self._hangs = {}
        self._restores = []
        self._ghosts = {}
        self.injected_log = []
        if hasattr(self.dispatcher, "reset"):
            self.dispatcher.reset()
        offline = [r for r in requests if r.arrival <= 0.0]
        online = sorted(
            (r for r in requests if r.arrival > 0.0),
            key=lambda r: (r.arrival, r.rid),
        )
        n = self.cfg.n_replicas
        slots = self.engine_cfg.n_slots
        live_cms = self.pricing_cost_models()
        if self.cfg.assign == "lpt" and self.heterogeneous:
            # R||Cmax: the partition prices each request through every
            # replica's OWN live fit (speed-scaled LPT + local search)
            self._offline_result = solve_hetero(
                offline, live_cms, slots,
                local_search_rounds=self.cfg.local_search_rounds,
                replica_penalties=self.health_penalties(),
            )
        elif self.cfg.assign in ("lpt", "lpt_blind"):
            blind = solve_offline(
                offline, n, self.cost_model,
                local_search_rounds=self.cfg.local_search_rounds,
            )
            if self.heterogeneous:
                # speed-blind ablation on a mixed fleet: keep the P||Cmax
                # partition but report honest per-replica loads and the
                # R||Cmax bound, so blind-vs-aware runs compare like for like
                self._offline_result = evaluate_hetero_assignment(
                    offline, blind.assignment, live_cms, slots,
                    solver="lpt_blind",
                )
            else:
                self._offline_result = blind
        else:
            rr = round_robin_assign(offline, n)
            if self.heterogeneous:
                self._offline_result = evaluate_hetero_assignment(
                    offline, rr, live_cms, slots, solver="round_robin",
                )
            else:
                self._offline_result = evaluate_assignment(
                    offline, rr, n, self.cost_model, solver="round_robin",
                )
        parts = split_requests(offline, self._offline_result.assignment)
        self._central = online
        base = policy_name or f"fleet/{self.cfg.assign}"
        for i, eng in enumerate(self.engines):
            clients = build_clients(eng.cfg.n_slots, [], None)
            # per-replica FCFS queue over the partition, longest-first
            # (Algorithm 1's sort); fleet dispatch/stealing push into it
            sched = GlobalQueueScheduler(parts[i], sort_longest_first=True)
            for r in parts[i]:
                self._grant_lease(r.rid, i)
            eng.begin_serve(
                [], clients, sched, iteration_policy_factory(),
                policy_name=f"{base}/r{i}", track_requests=True,
            )

    def _grant_lease(self, rid: int, replica: int) -> None:
        """Record that ``replica`` (at its CURRENT epoch) owns ``rid``.
        Every ownership transfer — offline partition, dispatch, steal,
        migration, recovery placement, redispatch — re-grants, so exactly
        one ``(replica, epoch)`` pair may ever complete the request."""
        self._leases[rid] = (replica, self.epochs[replica])

    def _route_arrivals(self, now: float) -> None:
        """Admit every central request whose arrival has passed, each to the
        replica the dispatch policy picks *at this moment* (load changes as
        earlier arrivals land, so routing is one-at-a-time)."""
        while self._central and self._central[0].arrival <= now:
            req = self._central.pop(0)
            i = self.dispatcher.choose(self, req)
            if self.obs is not None:
                # the priced inputs the dispatcher chose over: every
                # candidate's estimated outstanding work at this instant
                self.obs.audit_record(
                    "dispatch", now, i,
                    {
                        "rid": req.rid,
                        "arrival": round(req.arrival, 6),
                        "policy": self.dispatcher.name,
                        "loads_s": {
                            str(j): round(self.estimated_load_s(j), 6)
                            for j in self.dispatchable_replicas
                        },
                    },
                    i,
                )
            self._grant_lease(req.rid, i)
            self.engines[i]._sv.scheduler.push(req)

    def _earliest_slot_free_s(self, j: int) -> float:
        """Cost-model estimate of the absolute fleet time at which replica
        ``j`` next frees a slot: its clock plus the smallest remaining
        per-slot work (decode rounds left, or chunk tokens + decode for a
        mid-prefill slot), priced through replica ``j``'s own fitted model.
        The steal gate compares this against the thief's clock — measured
        clocks alone are not comparable when one replica's stages carried
        one-off costs (e.g. first-hit compiles)."""
        eng = self.engines[j]
        cm = self.replica_cost_model(j)
        waits = []
        for slot in eng.slots.active_slots:
            req = eng.slots.request_of[slot]
            rem = int(req.n_decode_est or req.n_decode) - eng.slots.emitted[slot]
            waits.append(
                cm.estimated_decode_completion(max(rem, 0), eng.cfg.n_slots)
            )
        for st in eng._chunking.values():
            waits.append(
                cm.prefill_time(st.remaining)
                + cm.estimated_decode_completion(
                    int(st.req.n_decode_est or st.req.n_decode), eng.cfg.n_slots
                )
            )
        return eng.clock + (min(waits) if waits else 0.0)

    def _steal_improves(
        self, thief: int, donor: int, victim: Request,
        explain: Optional[dict] = None,
    ) -> bool:
        """The R||Cmax steal gate: the move is taken only when BOTH

          * the victim's estimated finish time improves — the thief starts
            it now (its own clock) and runs it at its own speed, versus
            waiting for the donor's earliest freed slot and running at the
            donor's speed; and
          * the pair's estimated *completion* makespan improves — moving
            work onto a slower starving replica can finish the victim
            sooner yet make the thief the fleet's new straggler, which is
            exactly the regression R||Cmax pricing exists to prevent.

        Every term is priced through that replica's own fitted cost model,
        so a fast drained replica readily steals from a slow loaded one
        while the reverse steal prices itself out unless the donor's queue
        is deep enough that the move helps even at the thief's speed."""
        cms = self.pricing_cost_models()
        est = int(victim.n_decode_est or victim.n_decode)
        w_thief = self._request_weight_s(victim, est, cms[thief])
        w_donor = self._request_weight_s(victim, est, cms[donor])
        thief_finish = self.engines[thief].clock + w_thief
        donor_finish = self._earliest_slot_free_s(donor) + w_donor
        if explain is not None:
            explain.update(
                rid=victim.rid, thief=thief, donor=donor,
                thief_finish_s=round(thief_finish, 6),
                donor_finish_s=round(donor_finish, 6),
            )
        if thief_finish >= donor_finish:
            if explain is not None:
                explain["rejected_by"] = "finish_time"
            return False
        n = self.engine_cfg.n_slots
        thief_done = self.engines[thief].clock + self.estimated_load_s(thief)
        donor_done = self.engines[donor].clock + self.estimated_load_s(donor)
        before = max(thief_done, donor_done)
        after = max(thief_done + w_thief / n, donor_done - w_donor / n)
        ok = after < before - 1e-12
        if explain is not None:
            explain.update(
                makespan_before_s=round(before, 6),
                makespan_after_s=round(after, 6),
            )
            if not ok:
                explain["rejected_by"] = "pair_makespan"
        return ok

    def _migration_improves(
        self, thief: int, donor: int, victim: Request, remaining: int,
        explain: Optional[dict] = None,
    ) -> bool:
        """The in-flight analogue of ``_steal_improves``, priced decode-only
        (``replica_resume_weight`` — a page-copy import re-pays no prefill).
        The victim is RUNNING on the donor right now, so its status-quo
        finish is the donor's clock plus its remaining decode at the donor's
        speed (no slot wait); both the finish-time gate and the pair-makespan
        gate must still improve for the migration to commit — on a
        homogeneous pair neither can, which is exactly right: moving a
        running request between equal machines buys nothing."""
        cms = self.pricing_cost_models()
        n = self.engine_cfg.n_slots
        w_thief = replica_resume_weight(victim, cms[thief], n, remaining)
        w_donor = replica_resume_weight(victim, cms[donor], n, remaining)
        thief_finish = self.engines[thief].clock + w_thief
        donor_finish = self.engines[donor].clock + w_donor
        if explain is not None:
            explain.update(
                rid=victim.rid, thief=thief, donor=donor,
                remaining_decode=remaining,
                thief_finish_s=round(thief_finish, 6),
                donor_finish_s=round(donor_finish, 6),
            )
        if thief_finish >= donor_finish:
            if explain is not None:
                explain["rejected_by"] = "finish_time"
            return False
        thief_done = self.engines[thief].clock + self.estimated_load_s(thief)
        donor_done = self.engines[donor].clock + self.estimated_load_s(donor)
        before = max(thief_done, donor_done)
        after = max(thief_done + w_thief / n, donor_done - w_donor / n)
        ok = after < before - 1e-12
        if explain is not None:
            explain.update(
                makespan_before_s=round(before, 6),
                makespan_after_s=round(after, 6),
            )
            if not ok:
                explain["rejected_by"] = "pair_makespan"
        return ok

    def _try_steal_running(self, thief: int) -> bool:
        """In-flight rebalancing (``FleetConfig.steal_running``): migrate
        the longest-remaining RUNNING request off the most-loaded donor onto
        the starving thief by KV page-copy, when the double-gated makespan
        check approves. This is the straggler-tail case queued-only stealing
        structurally cannot touch: once every queue is empty, the only work
        left to rebalance is already bound to a slot. Donors must be
        healthy: a page-copy export is exactly the operation a replica the
        monitor distrusts should not be performing."""
        for j in sorted(
            (
                k for k in self.healthy_replicas
                if k != thief and k not in self._hangs
            ),
            key=lambda k: (-self.estimated_load_s(k), k),
        ):
            donor = self.engines[j]
            best: Optional[tuple] = None     # (remaining, slot, req)
            for slot in donor.slots.active_slots:
                req = donor.slots.request_of[slot]
                rem = (
                    int(req.n_decode_est or req.n_decode)
                    - donor.slots.emitted[slot]
                )
                if rem <= 1:
                    continue                 # nothing meaningful left to move
                if best is None or rem > best[0]:
                    best = (rem, slot, req)
            if best is None:
                continue
            rem, slot, req = best
            now = self.engines[thief].clock
            explain = {} if self.obs is not None else None
            improved = self._migration_improves(thief, j, req, rem, explain)
            if explain is not None:
                self.obs.audit_record(
                    "migration_gate", now, thief, explain,
                    "migrate" if improved else "reject",
                )
            if not improved:
                continue
            if not self.migrate_slot(j, slot, thief):
                continue
            self.steal_log.append(
                {"rid": req.rid, "from": j, "to": thief, "running": 1}
            )
            if self.obs is not None:
                self.obs.instant(
                    "steal", now, replica=thief, rid=req.rid,
                    donor=j, running=1,
                )
            return True
        return False

    def _try_steal(self) -> None:
        """Move the longest queued request from the most-loaded replica to
        each starving one (idle slot, empty queue). Queued work cannot start
        on its owner (all donor slots busy — otherwise it would not be
        queued); the steal commits only when the R||Cmax-priced finish time
        improves (``_steal_improves``). With ``steal_running`` on, a thief
        that finds no profitable queued steal escalates to migrating a
        running slot (``_try_steal_running``).

        A thief must be healthy (stealing INTO a SUSPECT replica would pile
        work onto a machine the monitor distrusts) and not hung (a stalled
        process cannot execute its steal loop). Queued-steal *donors* may be
        SUSPECT — draining a distrusted replica's queue is desirable."""
        for i, eng in enumerate(self.engines):
            if i in self._dead or i in self._hangs:
                continue
            if self.monitor is not None and not self.monitor.is_healthy(i):
                continue
            sched = eng._sv.scheduler
            idle_slots = [
                s for s in eng.slots.free_slots if s not in eng._chunking
            ]
            if sched.queued or not idle_slots:
                continue
            donors = [
                j for j, other in enumerate(self.engines)
                if j != i and j not in self._dead
                and other._sv.scheduler.queued
                # a donor with a genuinely free slot runs its own queue next
                # step — only steal from replicas whose slots are all busy
                and all(
                    s in other._chunking for s in other.slots.free_slots
                )
            ]
            stole = False
            # most-loaded donors first (Algorithm 1's argmax remain_token)
            for j in sorted(
                donors, key=lambda k: (-self.estimated_load_s(k), k)
            ):
                donor_sched = self.engines[j]._sv.scheduler
                victim = donor_sched.peek_longest()
                if victim is None:
                    continue
                explain = {} if self.obs is not None else None
                improved = self._steal_improves(i, j, victim, explain)
                if explain is not None:
                    self.obs.audit_record(
                        "steal_gate", self.engines[i].clock, i, explain,
                        "steal" if improved else "reject",
                    )
                if not improved:
                    continue
                stolen = donor_sched.steal_longest()
                assert stolen is victim
                sched.push(stolen)
                self._grant_lease(stolen.rid, i)
                self.steal_events += 1
                self.steal_log.append({"rid": stolen.rid, "from": j, "to": i})
                if self.obs is not None:
                    self.obs.instant(
                        "steal", self.engines[i].clock, replica=i,
                        rid=stolen.rid, donor=j, running=0,
                    )
                stole = True
                break
            if not stole and self.cfg.steal_running:
                self._try_steal_running(i)

    # ------------------------------------------------------------------ #
    # Fault injection / recovery                                          #
    # ------------------------------------------------------------------ #
    def _apply_due_faults(self, now: float) -> int:
        """Fire every pending fault whose instant the fleet clock has
        reached. Returns how many fired (the step loop re-derives its
        worker set when membership changed).

        Declared kinds (kill/slow/drain) tell the fleet — they append to
        ``fault_log`` and trigger recovery directly. Undeclared kinds
        (hang/degrade) only mutate the injection layer (``_hangs``, the
        engine's ``speed_factor``) and the chaos harness's ground-truth
        ``injected_log``; the fleet's scheduling/recovery code and the
        health monitor learn of them solely through missing or slowed
        heartbeats."""
        fired = 0
        while self._pending_faults and self._pending_faults[0].at_s <= now:
            f = self._pending_faults.pop(0)
            if f.replica in self._dead:
                continue                      # already gone; fault is moot
            if f.kind in ("kill", "drain"):
                if len(self._dead) + 1 >= self.cfg.n_replicas:
                    raise RuntimeError(
                        "fault plan killed or drained every replica"
                    )
                if f.kind == "drain":
                    self._evacuate_replica(
                        f.replica, now, pool_readable=True, kind="drain"
                    )
                else:
                    self._kill_replica(
                        f.replica, now, pool_readable=f.pool_readable
                    )
            elif f.kind == "hang":
                self._hangs[f.replica] = f
                self.injected_log.append({
                    "kind": "hang", "replica": f.replica, "at_s": f.at_s,
                    "applied_at_s": now, "until_s": f.until_s,
                })
                if self.obs is not None:
                    self.obs.instant(
                        "injected_fault", now, replica=f.replica,
                        fault="hang", until_s=f.until_s,
                    )
            elif f.kind == "degrade":
                eng = self.engines[f.replica]
                prev = eng.speed_factor
                eng.speed_factor = prev * f.speed_factor
                if f.until_s is not None:
                    self._restores.append({
                        "at_s": f.until_s, "replica": f.replica,
                        "speed_factor": prev,
                    })
                self.injected_log.append({
                    "kind": "degrade", "replica": f.replica, "at_s": f.at_s,
                    "applied_at_s": now, "speed_factor": eng.speed_factor,
                    "until_s": f.until_s,
                })
                if self.obs is not None:
                    self.obs.instant(
                        "injected_fault", now, replica=f.replica,
                        fault="degrade", speed_factor=eng.speed_factor,
                    )
            else:
                eng = self.engines[f.replica]
                eng.speed_factor = eng.speed_factor * f.speed_factor
                self.fault_log.append({
                    "kind": "slow", "replica": f.replica, "at_s": f.at_s,
                    "applied_at_s": now, "speed_factor": eng.speed_factor,
                })
                if self.obs is not None:
                    self.obs.instant(
                        "fault", now, replica=f.replica, fault="slow",
                        speed_factor=eng.speed_factor,
                    )
            fired += 1
        return fired

    def _apply_due_injections(self, now: float) -> int:
        """Advance the undeclared-fault injection layer to ``now``: restore
        degraded speeds whose window ended, and wake hung replicas whose
        ``until_s`` has passed. A wake-up of a replica that was condemned
        while hung fires its ghost — the zombie replays its stale in-flight
        completions, which ``deliver_completion`` must fence."""
        fired = 0
        still: List[Dict[str, Any]] = []
        for r in self._restores:
            if r["at_s"] <= now:
                if r["replica"] not in self._dead:
                    self.engines[r["replica"]].speed_factor = r["speed_factor"]
                self.injected_log.append({
                    "kind": "degrade_end", "replica": r["replica"],
                    "at_s": r["at_s"], "applied_at_s": now,
                })
                fired += 1
            else:
                still.append(r)
        self._restores = still
        for i, f in list(self._hangs.items()):
            if f.until_s is not None and f.until_s <= now:
                del self._hangs[i]
                self.injected_log.append({
                    "kind": "hang_end", "replica": i,
                    "at_s": f.until_s, "applied_at_s": now,
                })
                self._fire_ghost(i, now)
                fired += 1
        return fired

    def _fire_ghost(self, i: int, now: float) -> None:
        """Replay replica ``i``'s ghost: the in-flight work it held at
        condemnation, delivered now that the 'dead' process woke up. Every
        delivery carries the pre-condemnation epoch, so the fence discards
        them all — the hard acceptance gate is zero double-served tokens."""
        g = self._ghosts.pop(i, None)
        if g is None:
            return
        for rid, tokens in g["work"]:
            self.deliver_completion(i, g["epoch"], rid, tokens, now)

    def deliver_completion(
        self, replica: int, epoch: int, rid: int, tokens: List[int], now: float
    ) -> bool:
        """The fleet's single completion-acceptance gate: replica
        ``replica`` claims (under lease epoch ``epoch``) to have produced
        ``tokens`` for ``rid``. Accepted only when the epoch is the
        replica's CURRENT epoch, the request's lease names exactly this
        ``(replica, epoch)``, and the replica is not dead — otherwise the
        delivery is a zombie's and is fenced: counted, logged, discarded.

        In-process engines write their tokens directly (their lease is
        implicit in where the fleet queued the request); this explicit path
        exists for late/out-of-band deliveries — ghosts of condemned
        replicas replaying what they held. If the fence ever failed open,
        the stale write would land in a second engine's ``generated`` and
        the ``Fleet.generated`` merge would raise — a tripwire, not a
        handler."""
        reason = None
        if replica in self._dead:
            reason = "replica dead"
        elif epoch != self.epochs[replica]:
            reason = f"stale epoch {epoch} (current {self.epochs[replica]})"
        elif self._leases.get(rid) != (replica, epoch):
            reason = f"lease mismatch (held {self._leases.get(rid)})"
        if reason is not None:
            self.fenced_completions += 1
            self.fenced_log.append({
                "kind": "completion", "replica": replica, "epoch": epoch,
                "rid": rid, "n_tokens": len(tokens), "at_s": now,
                "reason": reason,
            })
            if self.obs is not None:
                self.obs.instant(
                    "fenced", now, replica=replica, rid=rid,
                    epoch=epoch, reason=reason,
                )
            return False
        self.engines[replica].generated[rid] = list(tokens)
        return True

    def _condemn_replica(self, i: int, now: float, reason: str) -> None:
        """Act on the monitor's verdict: fence replica ``i`` (epoch bump
        happens inside ``_evacuate_replica``, before any state moves) and
        evacuate its work onto survivors. Pool-readable page-copy is
        attempted first — condemnation is a *suspicion*, the host may well
        be reachable — with recompute-on-resume as the fallback.

        Before evacuating, the replica's in-flight work is snapshotted as a
        ghost under the pre-condemnation epoch: if the replica was merely
        stalled and later wakes, it replays those completions and the fence
        must discard every one.

        Refuses to condemn the last alive replica (a fleet that beheads
        itself on suspicion is worse than one that waits): the monitor's
        verdict is demoted back to SUSPECT and re-evaluated as the gap
        evidence accumulates."""
        if len(self._dead) + 1 >= self.cfg.n_replicas:
            self.monitor._transition(
                i, SUSPECT, now, "condemn refused: last alive"
            )
            return
        eng = self.engines[i]
        old_epoch = self.epochs[i]
        ghost_work: List[tuple] = []
        for slot in list(eng.slots.active_slots):
            rid = eng.slots.request_of[slot].rid
            ghost_work.append((rid, list(eng.generated.get(rid, []))))
        for st in eng._chunking.values():
            rid = st.req.rid
            ghost_work.append((rid, list(eng.generated.get(rid, []))))
        # queued work too: a stalled-but-not-dead process still holds its
        # queue and would serve it on wake — every one of those deliveries
        # must hit the fence
        for req in eng._sv.scheduler.queued:
            ghost_work.append((req.rid, list(eng.generated.get(req.rid, []))))
        self._ghosts[i] = {"epoch": old_epoch, "work": ghost_work}
        if self.obs is not None:
            self.obs.instant(
                "condemn", now, replica=i, reason=reason,
                fenced_epoch=old_epoch,
            )
            self.obs.audit_record(
                "condemn", now, i,
                {
                    "reason": reason,
                    "fenced_epoch": old_epoch,
                    "ghost_work": len(ghost_work),
                },
                "evacuate",
            )
        entry = self._evacuate_replica(i, now, pool_readable=True, kind="condemn")
        entry["reason"] = reason
        entry["fenced_epoch"] = old_epoch

    def _placement_cost(self, j: int, req: Request, in_flight: bool) -> float:
        """Estimated absolute fleet time at which survivor ``j`` would
        finish a displaced request: its clock, plus its outstanding load,
        plus the request's own service time — decode-only for an in-flight
        page-copy (no prefill is re-paid), full weight for queued work.
        Every term prices through replica ``j``'s own fitted cost model:
        drain and recovery placement are R||Cmax decisions like any other."""
        cm = self.replica_cost_model(j)
        est = int(req.n_decode_est or req.n_decode)
        if in_flight:
            w = replica_resume_weight(
                req, cm, self.engine_cfg.n_slots, max(est - req.decoded, 0)
            )
        else:
            w = self._request_weight_s(req, est, cm)
        return self.engines[j].clock + self.estimated_load_s(j) + w

    def _choose_placement(
        self,
        candidates: Sequence[int],
        req: Request,
        in_flight: bool,
        now: float,
        context: str,
    ) -> int:
        """Pick the cheapest-completion survivor for a displaced request
        and, when observing, audit the full comparison — every candidate's
        priced completion time next to the one chosen."""
        costs = {j: self._placement_cost(j, req, in_flight) for j in candidates}
        chosen = min(candidates, key=lambda j: (costs[j], j))
        if self.obs is not None:
            self.obs.audit_record(
                "placement", now, chosen,
                {
                    "rid": req.rid,
                    "context": context,
                    "in_flight": bool(in_flight),
                    "costs_s": {
                        str(j): round(costs[j], 6) for j in sorted(costs)
                    },
                },
                chosen,
            )
        return chosen

    def migrate_slot(
        self, src: int, slot: int, dst: int, src_epoch: Optional[int] = None
    ):
        """Live-migrate one in-flight slot from replica ``src`` to ``dst``
        by KV page-copy: export the slot checkpoint (pages + pending token
        + sampler cursor), import it into freshly allocated pages on the
        destination, zero recomputed tokens, bit-identical stream.

        Returns ``"page_copy"`` on the clean path; ``"recompute"`` when the
        payload failed its integrity check at import (the corrupted pages
        are rejected and the request falls back to recompute-on-resume from
        its trusted generated prefix — stream still bit-identical); False —
        with no state changed — when ``dst`` cannot host it, or when
        ``src_epoch`` is given and stale (the exporter was fenced
        mid-flight: the export is discarded, never imported). Both success
        strings are truthy, so boolean callers keep working."""
        if src == dst:
            raise ValueError("migration source and destination coincide")
        if src_epoch is not None and src_epoch != self.epochs[src]:
            self.fenced_exports += 1
            self.fenced_log.append({
                "kind": "export", "replica": src, "epoch": src_epoch,
                "slot": slot, "to": dst,
                "reason": f"stale epoch {src_epoch} "
                          f"(current {self.epochs[src]})",
            })
            return False
        src_eng, dst_eng = self.engines[src], self.engines[dst]
        if not dst_eng.can_import(src_eng.slot_pages(slot)):
            return False
        ckpt = src_eng.export_slot(slot)
        ckpt.src_replica = src
        ckpt.src_epoch = self.epochs[src]
        req = ckpt.req
        try:
            dst_eng.import_slot(ckpt)
        except PageIntegrityError:
            # the export already consumed the source slot, so the pages are
            # unrecoverable — but the generated prefix in the checkpoint is
            # host memory, not KV payload, and stays trusted: recompute it
            # on the destination (the PR-6 recovery path)
            self.integrity_rejections += 1
            self._lost_preemptions += req.preemptions
            req.preemptions = 0
            req.client = None
            self._grant_lease(req.rid, dst)
            if ckpt.prefix:
                dst_eng.adopt_resume(req, ckpt.prefix)
            else:
                dst_eng._sv.scheduler.push(req)
            self.migration_log.append({
                "rid": req.rid, "from": src, "to": dst,
                "pages": 0, "kind": ckpt.kind, "integrity_rejected": 1,
            })
            return "recompute"
        self._grant_lease(req.rid, dst)
        self.migration_events += 1
        self.migrated_pages += ckpt.n_pages
        self.migration_log.append({
            "rid": req.rid, "from": src, "to": dst,
            "pages": ckpt.n_pages, "kind": ckpt.kind,
        })
        if self.obs is not None:
            self.obs.instant(
                "migration", self.engines[dst].clock, replica=dst,
                rid=req.rid, src=src, pages=ckpt.n_pages, state=ckpt.kind,
            )
        return "page_copy"

    def drain_replica(self, i: int, now: Optional[float] = None) -> Dict[str, Any]:
        """Gracefully retire replica ``i`` mid-serve (rolling restart):
        stop dispatching to it, live-migrate its in-flight slots to
        survivors by page-copy, re-place its queued work through the
        R||Cmax pricing, and mark it retired — zero dropped requests and
        (pool headroom permitting) zero recomputed tokens. Returns the
        fault-log entry recording what moved and how."""
        if i in self._dead:
            raise ValueError(f"replica {i} is already retired")
        if len(self._dead) + 1 >= self.cfg.n_replicas:
            raise RuntimeError("cannot drain the last alive replica")
        if now is None:
            now = self.engines[i].clock
        return self._evacuate_replica(i, now, pool_readable=True, kind="drain")

    def _kill_replica(
        self, i: int, now: float, pool_readable: bool = False
    ) -> None:
        """Remove replica ``i`` from the fleet and recover its outstanding
        work onto survivors, exactly-once. A hard kill (the default) lost
        its KV pool with the process: in-flight requests recompute their
        generated prefix on a survivor. With ``pool_readable=True`` (soft
        failure) recovery prefers page-copy migration — see
        ``_evacuate_replica``."""
        self._evacuate_replica(i, now, pool_readable=pool_readable, kind="kill")

    def _evacuate_replica(
        self, i: int, now: float, pool_readable: bool, kind: str
    ) -> Dict[str, Any]:
        """Move every piece of replica ``i``'s outstanding work onto
        survivors and retire it, exactly-once:

          * **finished** requests stay finished — their tokens remain in
            the dead engine's ``generated`` record and their trace rows in
            its (kept) trace; they are never re-served;
          * **in-flight** requests (bound decode slots, mid-chunk prefills)
            live-migrate by KV page-copy when the source pool is readable
            (drain / soft kill) and a survivor can host the pages — zero
            recomputed tokens, the stream just continues; otherwise they
            fall back to PR-6-style recompute-on-resume (generated prefix
            re-prefilled on the survivor, stream still bit-identical);
          * **queued** requests move to the cheapest-completion survivor
            (``_placement_cost``, the R||Cmax pricing).

        Recompute-recovered requests restart their trace life on the
        survivor: rows the dead replica recorded for them are stripped from
        its trace and their preemption counters reset (preserved in the
        report meta as ``lost_preemptions``). Page-copied requests instead
        carry their full prefill history with them via the checkpoint's
        prefill credit — nothing resets, the destination trace simply
        credits the completions that happened elsewhere."""
        eng = self.engines[i]
        sv = eng._sv
        # retire FIRST so placement/pricing never targets the victim, and
        # fence BEFORE any state moves: every lease granted to this replica
        # dies here, so nothing it later claims (a zombie waking from a
        # hang) can be mistaken for current work
        self._dead.add(i)
        self.epochs[i] += 1
        if kind == "drain":
            self._drained.add(i)
        self._pricing_key = None              # membership changed
        page_copied = 0
        integrity_fb = 0                      # corrupted-payload fallbacks
        recompute: List[tuple] = []           # (request, prefix tokens)
        displaced: Dict[int, Request] = {}
        # in-flight work: page-copy where possible, recompute otherwise
        in_flight = [(s, True) for s in list(eng.slots.active_slots)]
        in_flight += [(s, False) for s in list(eng._chunking)]
        for slot, bound in in_flight:
            req = (
                eng.slots.request_of[slot] if bound
                else eng._chunking[slot].req
            )
            displaced[req.rid] = req
            if pool_readable:
                n_pages = eng.slot_pages(slot)
                cands = [
                    j for j in self.healthy_replicas
                    if self.engines[j].can_import(n_pages)
                ]
                if cands:
                    dst = self._choose_placement(
                        cands, req, bound, now, f"evacuate:{kind}"
                    )
                    res = self.migrate_slot(i, slot, dst)
                    if res == "page_copy":
                        page_copied += 1
                    else:                     # integrity-rejected payload
                        integrity_fb += 1
                    continue
            # hard kill, or no survivor can host the pages right now
            if bound:
                prefix = eng.generated.pop(req.rid, [])
                eng.slots.release(slot)
                sv.clients[slot].current = None
            else:
                st = eng._chunking.pop(slot)
                eng.slots.free_pages_of(slot)
                prefix = eng.generated.pop(st.req.rid, [])
            recompute.append((req, prefix))
        n_recompute = len(recompute)          # in-flight fallbacks only
        # queued: never started here — but an earlier preemptee waiting to
        # resume still owns its prefix
        moved_queued = 0
        for req in list(sv.scheduler.queued):
            sv.scheduler.commit(None, req)    # remove from the dead queue
            displaced[req.rid] = req
            prefix = eng.generated.pop(req.rid, [])
            recompute.append((req, prefix))
            moved_queued += 1
        eng._resume_rids.clear()
        # the dead trace keeps only work it *finished*; unfinished rows move
        # with their requests to the survivor's trace
        sv.trace.requests = [r for r in sv.trace.requests if r.t_done is not None]
        for req, prefix in recompute:
            self._lost_preemptions += req.preemptions
            req.preemptions = 0
            req.client = None
            if kind in ("drain", "condemn"):
                tgt_i = self._choose_placement(
                    self.healthy_replicas, req, False, now,
                    f"evacuate:{kind}",
                )
            else:
                tgt_i = self.dispatcher.choose(self, req)
            self._grant_lease(req.rid, tgt_i)
            tgt = self.engines[tgt_i]
            if prefix:
                tgt.adopt_resume(req, prefix)
            else:
                tgt._sv.scheduler.push(req)
        self.recovered_requests += len(displaced)
        entry: Dict[str, Any] = {
            "kind": kind, "replica": i, "at_s": now, "applied_at_s": now,
            "recovered": len(displaced),
            "page_copy": page_copied,
            "recompute": n_recompute + integrity_fb,
            "moved_queued": moved_queued,
        }
        self.fault_log.append(entry)
        if self.obs is not None:
            self.obs.instant(
                "fault", now, replica=i, fault=kind,
                recovered=len(displaced), page_copy=page_copied,
                recompute=n_recompute + integrity_fb,
            )
        if displaced:
            self._recovery_watch.append(
                {"entry": entry, "t0": now, "pending": dict(displaced)}
            )
            # page-copied work is re-admitted within the event itself
            self._note_recoveries(now)
        return entry

    def _request_admitted(self, req: Request) -> bool:
        """A displaced request counts as re-admitted once it is in flight
        (bound slot or mid-chunk prefill) on an alive replica — or done."""
        if req.t_done is not None:
            return True
        for j in self.alive_replicas:
            eng = self.engines[j]
            for slot in eng.slots.active_slots:
                if eng.slots.request_of[slot].rid == req.rid:
                    return True
            for st in eng._chunking.values():
                if st.req.rid == req.rid:
                    return True
        return False

    def _note_recoveries(self, now: float) -> None:
        """Stamp time-to-recover on fault/drain events: the span from the
        event to the instant ALL its displaced requests are re-admitted
        somewhere alive. Page-copy evacuations recover at the event itself
        (recover_s = 0); recompute paths pay queueing plus the re-prefill."""
        if not self._recovery_watch:
            return
        remaining = []
        for w in self._recovery_watch:
            w["pending"] = {
                rid: req for rid, req in w["pending"].items()
                if not self._request_admitted(req)
            }
            if w["pending"]:
                remaining.append(w)
            else:
                w["entry"]["recover_s"] = max(now - w["t0"], 0.0)
        self._recovery_watch = remaining

    def step(self) -> bool:
        """Advance the fleet by one stage on the lowest-clock alive replica
        with work. Returns False once every alive replica is drained and no
        arrivals remain (the serve is complete)."""
        while True:
            alive = self.alive_replicas
            workers = [i for i in alive if self.engines[i].has_work()]
            if not workers:
                if not self._central:
                    return False
                # fleet-wide idle gap: survivors fast-forward to the arrival
                nxt = self._central[0].arrival
                if self._apply_due_faults(nxt) or self._apply_due_injections(nxt):
                    continue
                for i in alive:
                    self.engines[i].advance_clock(nxt)
                self._route_arrivals(nxt)
                continue
            now = min(self.engines[i].clock for i in workers)
            if self._apply_due_faults(now) or self._apply_due_injections(now):
                continue                      # membership/queues changed
            # replicas without work have been idling in parallel — their
            # clocks track fleet time so routed arrivals start at "now";
            # the clock advance doubles as their passive liveness beat
            # (hung replicas excluded: a stalled process stamps nothing)
            for i in alive:
                if i not in workers:
                    self.engines[i].advance_clock(now)
                    if self.monitor is not None and i not in self._hangs:
                        self.monitor.beat(i, self.engines[i].clock)
            self._route_arrivals(now)
            if self.cfg.work_stealing:
                self._try_steal()
            workers = [i for i in alive if self.engines[i].has_work()]
            i = min(workers, key=lambda j: (self.engines[j].clock, j))
            if i in self._hangs:
                # the hung replica would be next: it silently makes no
                # progress, so fleet virtual time flows around it — jump its
                # clock to the wake-up instant and let the other replicas'
                # stages carry the clock (and the monitor's evidence)
                # forward. No heartbeat is stamped: that IS the failure.
                self.engines[i].advance_clock(self._hangs[i].until_s)
                continue
            n_stages = len(self.engines[i]._sv.trace.stages)
            status = self.engines[i].serve_step()
            if status == "idle":
                raise RuntimeError(
                    f"replica {i} idle with pending work — fleet routing bug"
                )
            if self.monitor is not None:
                self._health_beat(i, n_stages)
                self._health_evaluate(now)
            self._note_recoveries(self.engines[i].clock)
            return True

    # ------------------------------------------------------------------ #
    # Health monitoring (heartbeats → suspicion → condemnation)          #
    # ------------------------------------------------------------------ #
    def _predicted_stage_s(self, i: int, st) -> Optional[float]:
        """What replica ``i``'s OWN fitted cost model predicted the just-run
        stage should have taken — the denominator of the gray-failure
        slowdown signal. The model is the one FROZEN at serve start, not
        the live profiler fit: the live fit keeps learning from measured
        stages, so after one refit cycle it predicts the degraded speed and
        the ratio collapses back to 1. None until the replica had fully
        refit before the serve began: prior constants are paper-scale,
        orders of magnitude off measured milliseconds, and a ratio against
        them would flag every healthy replica as degraded (or mask a real
        one)."""
        cm = self._health_cms[i]
        if cm is None:
            return None
        if st.kind is StageKind.PREFILL:
            pred = cm.prefill_time(st.tokens)
        elif st.kind is StageKind.DECODE:
            pred = cm.fused_decode_time(len(st.busy), max(st.rounds, 1))
        elif st.kind is StageKind.MIXED:
            pred = cm.mixed_round_time(
                max(st.tokens - st.chunk_tokens, 0), st.chunk_tokens
            )
        else:
            return None
        return pred if pred > 0 else None

    def _health_beat(self, i: int, n_stages_before: int) -> None:
        """Stamp replica ``i``'s heartbeat after a ``serve_step``. A stage
        boundary carries the stage's measured duration + the cost-model
        prediction (feeding degraded detection); a step that only advanced
        the clock (idle fast-forward) beats bare — liveness without
        polluting the duration statistics."""
        eng = self.engines[i]
        stages = eng._sv.trace.stages
        if len(stages) > n_stages_before:
            st = stages[-1]
            self.monitor.beat(
                i, eng.clock,
                duration_s=st.t_end - st.t_start,
                predicted_s=self._predicted_stage_s(i, st),
                # predictions come from the per-serve frozen model, so the
                # version is constant for the whole serve (the monitor's
                # rebaseline-on-version-change still guards unit callers
                # that feed it a live, refitting model)
                model_version=0,
            )
        else:
            self.monitor.beat(i, eng.clock)

    def _health_evaluate(self, now: float) -> None:
        """Run the monitor's state machine at fleet time ``now``: condemn
        (fence + evacuate) replicas it gives up on, then re-place work
        queued on replicas it merely suspects."""
        newly = self.monitor.evaluate(now, replicas=self.alive_replicas)
        for i in newly:
            self._condemn_replica(
                i, now, reason=self.monitor.replicas[i].suspect_reason
                or "silence"
            )
        self._redispatch_suspect_queues(now)

    def _redispatch_suspect_queues(self, now: float) -> None:
        """Per-request redispatch with deadline-aware backoff: work queued
        (not yet started) on a SUSPECT replica is re-placed onto the
        cheapest-completion healthy replica once the suspicion has stood
        for ``redispatch_backoff_s`` — grace for a false suspicion to clear
        without churning the queue — or immediately when waiting out the
        backoff would already blow the request's TTFT deadline. In-flight
        slots stay: they move (page-copy first) only at condemnation."""
        hcfg = self.monitor.cfg
        for i in self.alive_replicas:
            if self.monitor.state(i) != SUSPECT:
                continue
            sched = self.engines[i]._sv.scheduler
            if not sched.queued:
                continue
            since = self.monitor.replicas[i].suspect_since
            if since is None:
                since = now
            targets = [
                j for j in self.alive_replicas
                if j != i and self.monitor.is_healthy(j)
            ]
            if not targets:
                continue                      # nowhere trustworthy to go
            for req in list(sched.queued):
                waited_out = now >= since + hcfg.redispatch_backoff_s
                deadline_pressed = (
                    req.ttft_slo_s is not None
                    and now + hcfg.redispatch_backoff_s
                    >= req.arrival + req.ttft_slo_s - hcfg.deadline_slack_s
                )
                if not (waited_out or deadline_pressed):
                    continue
                sched.commit(None, req)      # pop from the suspect queue
                j = self._choose_placement(
                    targets, req, False, now, "redispatch"
                )
                self.engines[j]._sv.scheduler.push(req)
                self._grant_lease(req.rid, j)
                req.redispatches += 1
                self.redispatch_events += 1
                self.redispatch_log.append({
                    "rid": req.rid, "from": i, "to": j, "at_s": now,
                    "deadline": bool(deadline_pressed and not waited_out),
                })

    def finish_serve(self) -> FleetReport:
        end = max(
            (self.engines[i].clock for i in self.alive_replicas),
            default=0.0,
        )
        if self._recovery_watch:
            self._note_recoveries(end)
        # ghosts that never woke mid-serve (hang outlasted the workload, or
        # the condemned replica was never hung at all) still replay at
        # teardown: a zombie's timing must not decide whether the fence is
        # exercised
        for i in sorted(self._ghosts):
            self._fire_ghost(i, end)
        traces = [
            eng.finish_serve(validate=not self._resumed)
            for eng in self.engines
        ]
        served = [r for t in traces for r in t.requests]
        lb_requests = served if served else self._all_requests
        if self.heterogeneous:
            # R||Cmax floor through the live per-replica fits; recovers the
            # flat-pool P||Cmax bound exactly when the fits coincide
            lb = hetero_theoretical_lower_bound(
                lb_requests,
                self.pricing_cost_models(),
                self.engine_cfg.n_slots,
            )
        else:
            lb = theoretical_lower_bound(
                lb_requests,
                self.cfg.n_replicas * self.engine_cfg.n_slots,
                self.cost_model,
            )
        report = FleetReport(
            policy_name=(
                f"fleet/{self.cfg.assign}+{self.dispatcher.name}"
                f"{'+steal' if self.cfg.work_stealing else ''}"
            ),
            n_replicas=self.cfg.n_replicas,
            slots_per_replica=self.engine_cfg.n_slots,
            traces=traces,
            lower_bound_s=lb.total,
            speed_factors=[s.speed_factor for s in self.specs],
            steal_events=self.steal_events,
            # a resumed fleet has no offline solve of its own (the partition
            # happened before the checkpoint)
            offline_solver=(
                self._offline_result.solver if self._offline_result else "resumed"
            ),
            offline_gap=(
                self._offline_result.gap if self._offline_result else 0.0
            ),
        )
        report.meta["recomputed_tokens"] = float(
            sum(eng.recomputed_tokens for eng in self.engines)
        )
        if self.migration_events:
            report.meta["migration_events"] = float(self.migration_events)
            report.meta["migrated_pages"] = float(self.migrated_pages)
        if self.fault_log:
            report.meta["fault_events"] = float(len(self.fault_log))
            report.meta["dead_replicas"] = float(len(self._dead))
            report.meta["drained_replicas"] = float(len(self._drained))
            report.meta["recovered_requests"] = float(self.recovered_requests)
            report.meta["lost_preemptions"] = float(self._lost_preemptions)
            report.meta["recovered_page_copy"] = float(
                sum(e.get("page_copy", 0) for e in self.fault_log)
            )
            report.meta["recovered_recompute"] = float(
                sum(e.get("recompute", 0) for e in self.fault_log)
            )
            report.meta["time_to_recover_s"] = float(
                max(
                    (e["recover_s"] for e in self.fault_log if "recover_s" in e),
                    default=0.0,
                )
            )
        if self.monitor is not None:
            report.meta["suspect_events"] = float(self.monitor.suspect_events)
            report.meta["false_suspicions"] = float(
                self.monitor.false_suspicions
            )
            report.meta["condemned_replicas"] = float(
                self.monitor.condemned_events
            )
            report.meta["degraded_events"] = float(
                self.monitor.degraded_events
            )
            report.meta["redispatch_events"] = float(self.redispatch_events)
        if self.fenced_completions or self.fenced_exports:
            report.meta["fenced_stale_completions"] = float(
                self.fenced_completions
            )
            report.meta["fenced_stale_exports"] = float(self.fenced_exports)
        if self.integrity_rejections:
            report.meta["integrity_rejections"] = float(
                self.integrity_rejections
            )
        if self.obs is not None:
            obs = self.obs
            # fleet counters join the typed registry next to the per-engine
            # meta counters `_obs_finish` already recorded
            for name, value, help_ in (
                ("steal_events", self.steal_events,
                 "queued steals + running migrations committed"),
                ("migration_events", self.migration_events,
                 "live page-copy slot migrations"),
                ("fenced_stale_completions", self.fenced_completions,
                 "zombie completions discarded by the epoch fence"),
                ("fenced_stale_exports", self.fenced_exports,
                 "stale-epoch slot exports discarded"),
                ("recovered_requests", self.recovered_requests,
                 "requests displaced by faults and re-admitted"),
            ):
                obs.declare(name, "counter", help=help_)
                obs.inc(name, float(value))
            # structured logs ride the typed side-channel, never summary()
            obs.set_log("fault_log", self.fault_log)
            obs.set_log("fenced_log", self.fenced_log)
            obs.set_log("steal_log", self.steal_log)
            obs.set_log("migration_log", self.migration_log)
            obs.set_log("redispatch_log", self.redispatch_log)
            obs.set_log("injected_log", self.injected_log)
            if self.monitor is not None:
                obs.set_log(
                    "health_transitions", list(self.monitor.transitions)
                )
        if not self._resumed:
            report.validate()
        return report

    def serve(
        self,
        requests: Sequence[Request],
        iteration_policy_factory: Callable[[], IterationPolicy] = LagrangianPolicy,
        policy_name: str = "",
        fault_plan: Optional[FaultPlan] = None,
    ) -> FleetReport:
        """Serve a request set to completion across all replicas."""
        self.begin_serve(
            requests, iteration_policy_factory, policy_name,
            fault_plan=fault_plan,
        )
        while self.step():
            pass
        return self.finish_serve()

    # ------------------------------------------------------------------ #
    # Aggregate output (parity checks / detokenized streaming)           #
    # ------------------------------------------------------------------ #
    @property
    def generated(self) -> Dict[int, List[int]]:
        """rid → sampled tokens, merged across replicas. Each request runs
        on exactly one replica, so the merge is collision-free (checked)."""
        out: Dict[int, List[int]] = {}
        for eng in self.engines:
            for rid, toks in eng.generated.items():
                if rid in out:
                    raise RuntimeError(f"request {rid} decoded on two replicas")
                out[rid] = toks
        return out

    def warm_serving_shapes(self) -> None:
        for eng in self.engines:
            eng.warm_serving_shapes()

    # ------------------------------------------------------------------ #
    # Checkpoint / restore (all replicas + fleet dispatcher state)        #
    # ------------------------------------------------------------------ #
    def state_dict(self) -> Dict[str, Any]:
        """Mid-serve fleet snapshot: every replica's engine state plus the
        queue composition and session clocks the fleet needs to resume."""
        queues = [
            np.asarray(
                [r.rid for r in eng._sv.scheduler.queued], dtype=np.int32
            )
            for eng in self.engines
        ]
        return {
            "engines": [eng.state_dict() for eng in self.engines],
            # per-replica profiler + fitted-cost-model state: a restored
            # heterogeneous fleet must keep pricing dispatch/stealing/solves
            # through what each replica had LEARNED, not its cold prior
            "profilers": [eng.profiler.state_dict() for eng in self.engines],
            # construction-time speeds, so a restore into a fleet built
            # with different specs fails loudly instead of silently
            # dropping the emulated speed asymmetry
            "speed_factors": np.asarray(
                [s.speed_factor for s in self.specs], dtype=np.float64
            ),
            "clocks": np.asarray(
                [eng.clock for eng in self.engines], dtype=np.float64
            ),
            "queues": queues,
            "central": np.asarray(
                [r.rid for r in self._central], dtype=np.int32
            ),
            "steal_events": self.steal_events,
            "dispatch_cursor": int(getattr(self.dispatcher, "cursor", 0)),
            # fault/recovery state: a fleet restored after a mid-serve kill
            # or drain must keep pricing/dispatch away from dead replicas
            # and keep its accounting (lost preemptions, fault events)
            "dead": np.asarray(sorted(self._dead), dtype=np.int32),
            "drained": np.asarray(sorted(self._drained), dtype=np.int32),
            "lost_preemptions": int(self._lost_preemptions),
            "recovered_requests": int(self.recovered_requests),
            # JSON string: survives np.asarray round-trips that flatten
            # checkpoint leaves (a list of dicts would not)
            "fault_log": json.dumps(self.fault_log),
            # health + fencing state: a restored fleet must keep distrusting
            # what it distrusted (SUSPECT must not wake up ALIVE) and keep
            # fencing what it fenced (epochs, leases, the fenced-event log)
            "epochs": np.asarray(self.epochs, dtype=np.int64),
            "fenced_completions": int(self.fenced_completions),
            "fenced_exports": int(self.fenced_exports),
            "redispatch_events": int(self.redispatch_events),
            "integrity_rejections": int(self.integrity_rejections),
            "fenced_log": json.dumps(self.fenced_log),
            "leases": json.dumps(
                {str(rid): list(lease) for rid, lease in self._leases.items()}
            ),
            "health": (
                self.monitor.state_dict() if self.monitor is not None else ""
            ),
            # observability state rides the checkpoint the same way: one
            # JSON-string leaf, so span chains survive a restore mid-serve
            "obs": self.obs.state_dict() if self.obs is not None else "",
        }

    def load_state_dict(
        self,
        state: Dict[str, Any],
        requests_by_rid: Dict[int, Request],
        iteration_policy_factory: Callable[[], IterationPolicy] = LagrangianPolicy,
        policy_name: str = "",
    ) -> None:
        """Restore a mid-serve fleet. Queued requests rebuild each replica's
        scheduler; bound/mid-chunk slots resume from engine state (their
        earlier tokens live in the pre-checkpoint output record, so the
        restored fleet's traces cover only post-restore work and
        ``finish_serve`` skips full-coverage validation)."""
        if "speed_factors" in state:
            saved = [float(s) for s in np.asarray(state["speed_factors"])]
            mine = [s.speed_factor for s in self.specs]
            if saved != mine:
                raise ValueError(
                    f"checkpoint was written by a fleet with speed_factors "
                    f"{saved}, but this fleet has {mine} — construct the "
                    f"restoring Fleet with the same replica_specs"
                )
        self._resumed = True
        self.steal_events = int(state.get("steal_events", 0))
        self._dead = {int(i) for i in np.asarray(state.get("dead", []))}
        self._drained = {int(i) for i in np.asarray(state.get("drained", []))}
        self._lost_preemptions = int(state.get("lost_preemptions", 0))
        self.recovered_requests = int(state.get("recovered_requests", 0))
        raw_log = state.get("fault_log", "[]")
        if not isinstance(raw_log, str):      # np.str_ after tree_map
            raw_log = str(np.asarray(raw_log))
        self.fault_log = json.loads(raw_log)
        self._recovery_watch = []             # recover_s already stamped
        self._pricing_key = None
        # health + fencing state (absent in pre-PR-8 checkpoints → defaults)
        self.epochs = [
            int(e)
            for e in np.asarray(
                state.get("epochs", [0] * self.cfg.n_replicas)
            )
        ]
        self.fenced_completions = int(state.get("fenced_completions", 0))
        self.fenced_exports = int(state.get("fenced_exports", 0))
        self.redispatch_events = int(state.get("redispatch_events", 0))
        self.integrity_rejections = int(state.get("integrity_rejections", 0))
        raw_fenced = state.get("fenced_log", "[]")
        if not isinstance(raw_fenced, str):
            raw_fenced = str(np.asarray(raw_fenced))
        self.fenced_log = json.loads(raw_fenced)
        raw_leases = state.get("leases", "{}")
        if not isinstance(raw_leases, str):
            raw_leases = str(np.asarray(raw_leases))
        self._leases = {
            int(rid): tuple(lease)
            for rid, lease in json.loads(raw_leases).items()
        }
        raw_health = state.get("health", "")
        if not isinstance(raw_health, str):
            raw_health = str(np.asarray(raw_health))
        if raw_health:
            if self.monitor is None:
                raise ValueError(
                    "checkpoint carries health-monitor state but this fleet "
                    "was built without FleetConfig.health — construct the "
                    "restoring Fleet with the same health config"
                )
            self.monitor.load_state_dict(raw_health)
            self.monitor.obs = self.obs
        raw_obs = state.get("obs", "")
        if not isinstance(raw_obs, str):
            raw_obs = str(np.asarray(raw_obs))
        if raw_obs and self.obs is not None:
            self.obs.load_state_dict(raw_obs)
        # undeclared-injection state is per serve (like _pending_faults, it
        # is not checkpointed): a restored fleet starts with a clean layer
        self._hangs = {}
        self._restores = []
        self._ghosts = {}
        self.injected_log = []
        self.redispatch_log = []
        # steal_log entries are not checkpointed (steal_events is), and any
        # offline solve belongs to the pre-checkpoint serve — clear both so
        # a reused Fleet object cannot report stale metadata
        self.steal_log = []
        self._offline_result = None
        if hasattr(self.dispatcher, "cursor"):
            self.dispatcher.cursor = int(state.get("dispatch_cursor", 0))
        self._central = [
            requests_by_rid[int(rid)] for rid in np.asarray(state["central"])
        ]
        self._all_requests = list(requests_by_rid.values())
        base = policy_name or f"fleet/{self.cfg.assign}"
        clocks = np.asarray(state["clocks"], dtype=np.float64)
        for i, eng in enumerate(self.engines):
            clients = build_clients(eng.cfg.n_slots, [], None)
            sched = GlobalQueueScheduler(
                [requests_by_rid[int(r)] for r in np.asarray(state["queues"][i])]
            )
            eng.begin_serve(
                [], clients, sched, iteration_policy_factory(),
                policy_name=f"{base}/r{i}(resumed)", track_requests=True,
            )
            eng.load_state_dict(state["engines"][i], requests_by_rid)
            if "profilers" in state:
                eng.profiler.load_state_dict(state["profilers"][i])
            # re-attach bound requests to their clients (mid-chunk slots
            # stay current=None — _chunking owns them until the final chunk)
            for slot, req in enumerate(eng.slots.request_of):
                if req is not None:
                    clients[slot].current = req
                    req.decoded = eng.slots.emitted[slot]
            eng.advance_clock(float(clocks[i]))
        # freeze health-prediction models off the restored profiler fits
        # (same rule as begin_serve: the resumed serve judges slowdowns
        # against the model as-of-resume, never the live refitting one)
        self._health_cms = [
            eng.profiler.cost_model if eng.profiler.full_fits > 0 else None
            for eng in self.engines
        ]
