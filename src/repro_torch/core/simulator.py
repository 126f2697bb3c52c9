"""Event-driven PD-Competition simulator.

Reproduces the paper's experiment semantics (§III-A, Fig. 2):

  * The node runs exactly one stage at a time — a prefill stage or a decode
    round — alternating under the iteration policy's control.
  * A prefill stage admits ≤ 1 new request per idle client (Eq. 16), total
    input tokens ≤ the largest level capacity (Eq. 6); its duration is the
    measured linear model on the *actual* token count (the levels quantize
    the decision model, not the physics — see DESIGN.md §2).
  * A decode round gives every active client one token; duration
    T^d_oh + T^d · n_active.
  * A request's decode may be preempted by prefill stages (continuous
    batching); a client processes one request at a time until completion.

The simulator consumes the same policy objects as the real engine
(``repro.serving.engine``), so scheduler behaviour validated here transfers.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

from .cost_model import CostModel
from .iteration import (
    CandidateBatch,
    IterationPolicy,
    LagrangianPolicy,
    PrefillFirstPolicy,
    SystemSnapshot,
)
from .offline import round_robin_assign, solve_offline
from .online import (
    GlobalQueueScheduler,
    RequestScheduler,
    SortingPreemptiveScheduler,
    StaticBacklogScheduler,
    build_clients,
)
from .types import (
    ClientState,
    Phase,
    Request,
    ScheduleTrace,
    StageKind,
    StageRecord,
)


@dataclass
class SimConfig:
    n_clients: int
    cost_model: CostModel
    max_stages: int = 2_000_000     # runaway guard
    record_decisions: bool = True


class Simulator:
    """Simulates one serve run of a request set under a scheduling config."""

    def __init__(
        self,
        requests: Sequence[Request],
        config: SimConfig,
        request_scheduler: RequestScheduler,
        iteration_policy: IterationPolicy,
        clients: Optional[List[ClientState]] = None,
        policy_name: str = "",
    ):
        self.requests = list(requests)
        self.cfg = config
        self.sched = request_scheduler
        self.policy = iteration_policy
        self.clients = clients or [ClientState(cid=j) for j in range(config.n_clients)]
        self.policy_name = policy_name or iteration_policy.name

    # ------------------------------------------------------------------ #
    def run(self) -> ScheduleTrace:
        cm = self.cfg.cost_model
        trace = ScheduleTrace(
            num_clients=self.cfg.n_clients,
            requests=self.requests,
            policy_name=self.policy_name,
        )
        for r in self.requests:
            r.reset()
        t = 0.0
        bin_index = -1  # incremented on first prefill stage

        for _ in range(self.cfg.max_stages):
            active = [c for c in self.clients if c.current is not None]
            idle = [c for c in self.clients if c.current is None]
            done = not active and not self.sched.has_pending()
            if done:
                break

            candidate_pairs = self.sched.propose_batch(
                idle, cm.max_level.cap_tokens
            )
            candidate = CandidateBatch(
                requests=[r for _, r in candidate_pairs],
                client_ids=[c.cid for c, _ in candidate_pairs],
            )
            snap = SystemSnapshot(
                n_clients=self.cfg.n_clients,
                n_active=len(active),
                n_idle=len(idle),
                active_remaining_est=sum(
                    max(0, (c.current.n_decode_est or 0) - c.current.decoded)
                    for c in active
                    if c.current is not None
                ),
                pending_requests=self.sched.pending_count(),
                candidate=candidate,
                now=t,
            )
            t0 = time.perf_counter()
            do_prefill = self.policy(snap, cm)
            if self.cfg.record_decisions:
                trace.decision_times_ms.append((time.perf_counter() - t0) * 1e3)

            if do_prefill and candidate:
                bin_index += 1
                t = self._run_prefill(trace, t, bin_index, candidate_pairs, cm)
            elif active:
                t = self._run_decode_round(trace, t, max(bin_index, 0), active, cm)
            else:
                # No decodes and the policy refused a non-empty candidate —
                # force progress (progress guard also lives in the policy).
                if candidate:
                    bin_index += 1
                    t = self._run_prefill(trace, t, bin_index, candidate_pairs, cm)
                else:
                    raise RuntimeError(
                        "scheduler deadlock: pending requests but no candidate"
                    )
        else:
            raise RuntimeError("max_stages exceeded — scheduler not terminating")

        trace.validate()
        return trace

    # ------------------------------------------------------------------ #
    def _run_prefill(self, trace, t, bin_index, pairs, cm: CostModel) -> float:
        total_tokens = sum(r.n_prefill for _, r in pairs)
        duration = cm.prefill_time(total_tokens)
        level = cm.level_for(min(total_tokens, cm.max_level.cap_tokens)).index
        self.sched.commit_batch(pairs)
        busy = {}
        for client, req in pairs:
            req.client = client.cid
            req.prefill_bin = bin_index
            req.t_prefill_start = t
            req.t_prefill_end = t + duration
            client.current = req
            client.busy_time += duration
            busy[client.cid] = req.rid
        trace.stages.append(
            StageRecord(
                kind=StageKind.PREFILL,
                t_start=t,
                t_end=t + duration,
                bin_index=bin_index,
                busy=busy,
                tokens=total_tokens,
                level=level,
            )
        )
        return t + duration

    def _run_decode_round(self, trace, t, bin_index, active, cm: CostModel) -> float:
        duration = cm.decode_round_time(len(active))
        busy = {}
        for client in active:
            req = client.current
            req.decoded += 1
            client.busy_time += duration
            busy[client.cid] = req.rid
            if req.decoded >= req.n_decode:
                req.t_done = t + duration
                client.current = None
        trace.stages.append(
            StageRecord(
                kind=StageKind.DECODE,
                t_start=t,
                t_end=t + duration,
                bin_index=bin_index,
                busy=busy,
                tokens=len(active),
                rounds=1,
            )
        )
        return t + duration


# --------------------------------------------------------------------------- #
# The four paper configurations (Figs. 6–9) + beyond-paper variants           #
# --------------------------------------------------------------------------- #
def simulate(
    requests: Sequence[Request],
    n_clients: int,
    cost_model: CostModel,
    mode: str = "baseline",
    offline_exact: bool = False,
    iteration_policy: Optional[IterationPolicy] = None,
    oracle_estimates: bool = False,
) -> ScheduleTrace:
    """Run one of the named configurations.

    mode:
      * ``baseline``      — global FCFS queue, prefill-first: vLLM's default
                            scheduler, the paper's baseline (Fig. 6).
      * ``offline``       — bin-packed backlogs, no stealing, prefill-first
                            (Fig. 7).
      * ``online``        — FCFS round-robin backlogs + Algorithm 1 stealing
                            + Lagrangian iteration rule (Fig. 8).
      * ``hybrid``        — bin-packed backlogs + Algorithm 1 + Lagrangian
                            (Fig. 9).
      * ``static_rr``     — static round-robin backlogs, no stealing
                            (ablation: pre-assigned unbalanced clients).
    ``iteration_policy`` overrides the mode's default iteration rule (used by
    the beyond-paper studies). ``oracle_estimates=True`` gives the planner
    true decode lengths (the paper's offline/RLHF scenario, where outputs are
    measured or well-predicted); default keeps whatever estimates the
    workload carries. Requests are copied, so repeated calls are independent.
    """
    requests = [
        Request(
            rid=r.rid,
            n_prefill=r.n_prefill,
            n_decode=r.n_decode,
            n_decode_est=(r.n_decode if oracle_estimates else r.n_decode_est),
            arrival=r.arrival,
        )
        for r in requests
    ]
    cfg = SimConfig(n_clients=n_clients, cost_model=cost_model)

    if mode == "baseline":
        clients = [ClientState(cid=j) for j in range(n_clients)]
        sched: RequestScheduler = GlobalQueueScheduler(requests)
        policy = iteration_policy or PrefillFirstPolicy()
    elif mode == "static_rr":
        assignment = round_robin_assign(requests, n_clients)
        clients = build_clients(n_clients, requests, assignment)
        sched = StaticBacklogScheduler(clients)
        policy = iteration_policy or PrefillFirstPolicy()
    elif mode == "offline":
        result = solve_offline(requests, n_clients, cost_model, exact=offline_exact)
        clients = build_clients(n_clients, requests, result.assignment)
        sched = StaticBacklogScheduler(clients)
        policy = iteration_policy or PrefillFirstPolicy()
    elif mode == "online":
        assignment = round_robin_assign(requests, n_clients)
        clients = build_clients(n_clients, requests, assignment)
        sched = SortingPreemptiveScheduler(clients)
        policy = iteration_policy or LagrangianPolicy()
    elif mode == "hybrid":
        result = solve_offline(requests, n_clients, cost_model, exact=offline_exact)
        clients = build_clients(n_clients, requests, result.assignment)
        sched = SortingPreemptiveScheduler(clients)
        policy = iteration_policy or LagrangianPolicy()
    elif mode == "global_fcfs":
        clients = [ClientState(cid=j) for j in range(n_clients)]
        sched = GlobalQueueScheduler(requests)
        policy = iteration_policy or PrefillFirstPolicy()
    else:
        raise ValueError(f"unknown mode {mode!r}")

    sim = Simulator(
        requests,
        cfg,
        sched,
        policy,
        clients=clients,
        policy_name=f"{mode}/{policy.name}",
    )
    return sim.run()
