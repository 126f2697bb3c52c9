"""Offline requests scheduling — Minimizing Makespan Bin Packing (Eqs. 26–30)
and the theoretical lower bound (Eqs. 31–32).

The offline model balances the estimated decode completion time T_i of the
given requests across J clients:

    min  max_j t_j
    s.t. Σ_j x_ij = 1            ∀ i
         Σ_i x_ij T_i ≤ t_j      ∀ j

This is the classic P||Cmax (multiprocessor scheduling). We provide:

  * ``lpt_assign``       — Longest-Processing-Time-first, 4/3-approximate, O(I log I).
  * ``local_search``     — move/swap refinement of any assignment.
  * ``milp_assign``      — exact (scipy HiGHS) with LPT warm-bound; the
                           paper-scale instance (1319 × 200) solves via LPT +
                           local search in milliseconds and is provably near
                           the LP bound; exact MILP is for small instances.
  * ``solve_offline``    — the composition used by the framework.
  * ``theoretical_lower_bound`` — T_LB = t^p* + t^d*  (Eqs. 31–32).
"""
from __future__ import annotations

import heapq
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .cost_model import CostModel
from .types import Request


@dataclass
class OfflineResult:
    """Assignment x_{ij} (as request-order lists per client) + diagnostics."""

    assignment: List[List[int]]          # client -> list of request ids
    loads: List[float]                   # t_j per client (estimated)
    makespan_est: float                  # max_j t_j
    lp_lower_bound: float                # max(mean load, max item)
    solver: str
    solve_seconds: float

    @property
    def gap(self) -> float:
        """Relative gap between achieved makespan and the LP lower bound.

        A degenerate instance can carry a zero lower bound (e.g. an empty
        request list per client); reporting 0.0 there would read as a
        *perfect* solution even when the achieved makespan is positive, so
        a positive makespan over a zero bound is an infinite gap, and only
        zero-over-zero is a true 0.0.
        """
        if self.lp_lower_bound <= 0:
            return 0.0 if self.makespan_est <= 0 else float("inf")
        return (self.makespan_est - self.lp_lower_bound) / self.lp_lower_bound


def request_weights(
    requests: Sequence[Request],
    cost_model: CostModel,
    n_clients: int,
    include_prefill: bool = False,
    cache_aware: bool = True,
) -> np.ndarray:
    """T_i: estimated decode completion time per request (offline model §IV-B).

    Offline planning uses the *estimated* decode length (n_decode_est); true
    lengths stay unknown until execution, as in the paper. (The
    heterogeneous solver prices a different, prefill-inclusive quantity —
    see ``core.hetero.replica_request_weight``.)

    ``include_prefill`` adds each request's prefill service time to its
    weight — required when prompt lengths (and therefore prefill cost)
    vary enough to dominate the packing. With ``cache_aware`` (the
    default) the prefill term prices the request's *uncached* prompt
    length (``Request.cached_prefill`` as probed against the warm fleet
    state): a cache hit makes a nominally huge prompt nearly free, and a
    packer that prices the nominal length balances work that will never
    run. ``cache_aware=False`` is the hard-gated cache-blind ablation."""
    out = []
    for r in requests:
        w = cost_model.estimated_decode_completion(
            r.n_decode_est or r.n_decode, n_clients
        )
        if include_prefill:
            p = r.uncached_prefill if cache_aware else r.n_prefill
            w += cost_model.prefill_time(p)
        out.append(w)
    return np.asarray(out, dtype=np.float64)


# internal alias kept for the pre-heterogeneous call sites below
_weights = request_weights


# --------------------------------------------------------------------------- #
# Heuristics                                                                  #
# --------------------------------------------------------------------------- #
def lpt_assign(weights: np.ndarray, n_clients: int) -> List[List[int]]:
    """Longest Processing Time first onto the least-loaded client (min-heap)."""
    order = np.argsort(-weights, kind="stable")
    heap: List[Tuple[float, int]] = [(0.0, j) for j in range(n_clients)]
    heapq.heapify(heap)
    assignment: List[List[int]] = [[] for _ in range(n_clients)]
    for i in order:
        load, j = heapq.heappop(heap)
        assignment[j].append(int(i))
        heapq.heappush(heap, (load + float(weights[i]), j))
    return assignment


def _loads(assignment: List[List[int]], weights: np.ndarray) -> np.ndarray:
    return np.asarray(
        [sum(float(weights[i]) for i in client) for client in assignment],
        dtype=np.float64,
    )


def local_search(
    assignment: List[List[int]],
    weights: np.ndarray,
    max_rounds: int = 50,
) -> List[List[int]]:
    """Move/swap local search on the makespan.

    Repeatedly takes the max-loaded client and tries (a) moving one of its
    items to the min-loaded client, (b) swapping an item pair with the
    min-loaded client, accepting strict makespan-or-tie-breaking improvements.
    """
    assignment = [list(c) for c in assignment]
    loads = _loads(assignment, weights)
    for _ in range(max_rounds):
        j_max = int(np.argmax(loads))
        j_min = int(np.argmin(loads))
        if j_max == j_min:
            break
        improved = False
        # (a) single-item move
        best_delta = 0.0
        best_item = None
        for i in assignment[j_max]:
            w = float(weights[i])
            new_max = max(loads[j_max] - w, loads[j_min] + w)
            delta = loads[j_max] - new_max
            if delta > best_delta + 1e-12:
                best_delta, best_item = delta, i
        if best_item is not None:
            assignment[j_max].remove(best_item)
            assignment[j_min].append(best_item)
            loads[j_max] -= weights[best_item]
            loads[j_min] += weights[best_item]
            improved = True
        else:
            # (b) pairwise swap
            best = None
            for a in assignment[j_max]:
                for b in assignment[j_min]:
                    wa, wb = float(weights[a]), float(weights[b])
                    if wa <= wb:
                        continue
                    new_max = max(loads[j_max] - wa + wb, loads[j_min] + wa - wb)
                    delta = loads[j_max] - new_max
                    if best is None or delta > best[0] + 1e-12:
                        if delta > 1e-12:
                            best = (delta, a, b)
            if best is not None:
                _, a, b = best
                assignment[j_max].remove(a)
                assignment[j_min].remove(b)
                assignment[j_max].append(b)
                assignment[j_min].append(a)
                loads[j_max] += weights[b] - weights[a]
                loads[j_min] += weights[a] - weights[b]
                improved = True
        if not improved:
            break
    return assignment


# --------------------------------------------------------------------------- #
# Exact MILP (scipy HiGHS) — the paper solves this model with SCIP            #
# --------------------------------------------------------------------------- #
def milp_assign(
    weights: np.ndarray,
    n_clients: int,
    time_limit_s: float = 60.0,
    warm_makespan: Optional[float] = None,
) -> Optional[List[List[int]]]:
    """Exact P||Cmax via MILP (Eqs. 26–30). Returns None if solver fails.

    Variables: x_{ij} ∈ {0,1} (I*J), t_max ∈ R+.
    min t_max  s.t.  Σ_j x_ij = 1;  Σ_i w_i x_ij - t_max ≤ 0.
    """
    from scipy.optimize import LinearConstraint, Bounds, milp
    import scipy.sparse as sp

    n_i = len(weights)
    n_x = n_i * n_clients
    n_var = n_x + 1  # + t_max

    c = np.zeros(n_var)
    c[-1] = 1.0

    # Σ_j x_ij = 1  for each i
    rows, cols, vals = [], [], []
    for i in range(n_i):
        for j in range(n_clients):
            rows.append(i)
            cols.append(i * n_clients + j)
            vals.append(1.0)
    a_eq = sp.csr_matrix((vals, (rows, cols)), shape=(n_i, n_var))
    eq = LinearConstraint(a_eq, lb=np.ones(n_i), ub=np.ones(n_i))

    # Σ_i w_i x_ij - t_max ≤ 0  for each j
    rows, cols, vals = [], [], []
    for j in range(n_clients):
        for i in range(n_i):
            rows.append(j)
            cols.append(i * n_clients + j)
            vals.append(float(weights[i]))
        rows.append(j)
        cols.append(n_x)
        vals.append(-1.0)
    a_ub = sp.csr_matrix((vals, (rows, cols)), shape=(n_clients, n_var))
    ub = LinearConstraint(a_ub, lb=-np.inf * np.ones(n_clients), ub=np.zeros(n_clients))

    integrality = np.ones(n_var)
    integrality[-1] = 0.0
    ub_t = warm_makespan if warm_makespan is not None else float(np.sum(weights))
    bounds = Bounds(
        lb=np.zeros(n_var),
        ub=np.concatenate([np.ones(n_x), [ub_t]]),
    )
    res = milp(
        c=c,
        constraints=[eq, ub],
        integrality=integrality,
        bounds=bounds,
        options={"time_limit": time_limit_s, "presolve": True},
    )
    if res.x is None:
        return None
    x = np.asarray(res.x[:n_x]).reshape(n_i, n_clients)
    assignment: List[List[int]] = [[] for _ in range(n_clients)]
    for i in range(n_i):
        j = int(np.argmax(x[i]))
        assignment[j].append(i)
    return assignment


# --------------------------------------------------------------------------- #
# Composition                                                                 #
# --------------------------------------------------------------------------- #
def solve_offline(
    requests: Sequence[Request],
    n_clients: int,
    cost_model: CostModel,
    exact: bool = False,
    exact_time_limit_s: float = 60.0,
    local_search_rounds: int = 200,
    include_prefill: bool = False,
    cache_aware: bool = True,
) -> OfflineResult:
    """Solve the offline request-assignment model.

    Default path: LPT + local search (paper-scale in milliseconds). With
    ``exact=True`` also runs the MILP (keeps whichever is better) — this is
    the SCIP path in the paper, practical only at small scale.
    ``include_prefill`` / ``cache_aware`` select the prefill-inclusive,
    prefix-cache-aware pricing (see ``request_weights``).
    """
    if n_clients <= 0:
        raise ValueError("n_clients must be positive")
    t0 = time.perf_counter()
    weights = _weights(
        requests, cost_model, n_clients,
        include_prefill=include_prefill, cache_aware=cache_aware,
    )
    rid_of = [r.rid for r in requests]

    assignment = lpt_assign(weights, n_clients)
    assignment = local_search(assignment, weights, max_rounds=local_search_rounds)
    solver = "lpt+local_search"

    loads = _loads(assignment, weights)
    if exact:
        exact_asn = milp_assign(
            weights, n_clients, time_limit_s=exact_time_limit_s,
            warm_makespan=float(np.max(loads)),
        )
        if exact_asn is not None:
            exact_loads = _loads(exact_asn, weights)
            if float(np.max(exact_loads)) < float(np.max(loads)) - 1e-12:
                assignment, loads = exact_asn, exact_loads
                solver = "milp(highs)"
            else:
                solver = "lpt+local_search(=milp)"

    lp_lb = max(float(np.sum(weights)) / n_clients, float(np.max(weights)) if len(weights) else 0.0)
    # Map positional indices back to request ids, ordering each client's
    # backlog longest-first (Algorithm 1's sort by N_i^p + N_i^d).
    by_pos = {i: requests[i] for i in range(len(requests))}
    mapped: List[List[int]] = []
    for client in assignment:
        ordered = sorted(client, key=lambda i: -by_pos[i].est_total_tokens)
        mapped.append([rid_of[i] for i in ordered])
    return OfflineResult(
        assignment=mapped,
        loads=[float(x) for x in loads],
        makespan_est=float(np.max(loads)) if len(loads) else 0.0,
        lp_lower_bound=lp_lb,
        solver=solver,
        solve_seconds=time.perf_counter() - t0,
    )


def evaluate_assignment(
    requests: Sequence[Request],
    assignment: List[List[int]],
    n_clients: int,
    cost_model: CostModel,
    solver: str = "external",
) -> OfflineResult:
    """Wrap an externally-produced assignment (client → rid lists, e.g.
    ``round_robin_assign``) in an ``OfflineResult`` with the same load /
    makespan / LP-bound diagnostics ``solve_offline`` reports — so baseline
    ablations and the solver path are compared on identical terms."""
    if len(assignment) != n_clients:
        raise ValueError("assignment length != n_clients")
    t0 = time.perf_counter()
    weights = _weights(requests, cost_model, n_clients)
    pos_of = {r.rid: i for i, r in enumerate(requests)}
    loads = [
        sum(float(weights[pos_of[rid]]) for rid in client)
        for client in assignment
    ]
    lp_lb = max(
        float(np.sum(weights)) / n_clients,
        float(np.max(weights)) if len(weights) else 0.0,
    )
    return OfflineResult(
        assignment=[list(c) for c in assignment],
        loads=loads,
        makespan_est=float(max(loads)) if loads else 0.0,
        lp_lower_bound=lp_lb,
        solver=solver,
        solve_seconds=time.perf_counter() - t0,
    )


def split_requests(
    requests: Sequence[Request], assignment: List[List[int]]
) -> List[List[Request]]:
    """Materialize an assignment (client → rid list) as per-client Request
    lists, preserving the assignment's per-client order. Used by the fleet
    to turn a replica-level ``solve_offline``/``round_robin_assign`` result
    into per-replica backlogs."""
    by_rid: Dict[int, Request] = {r.rid: r for r in requests}
    out: List[List[Request]] = []
    seen: set = set()
    for rids in assignment:
        part = []
        for rid in rids:
            if rid in seen:
                raise ValueError(f"request {rid} assigned twice")
            seen.add(rid)
            part.append(by_rid[rid])
        out.append(part)
    if len(seen) != len(requests):
        missing = sorted(set(by_rid) - seen)
        raise ValueError(f"requests not assigned: {missing[:5]}...")
    return out


def round_robin_assign(requests: Sequence[Request], n_clients: int) -> List[List[int]]:
    """FCFS round-robin — the unbalanced baseline assignment (Fig. 6)."""
    assignment: List[List[int]] = [[] for _ in range(n_clients)]
    for pos, r in enumerate(requests):
        assignment[pos % n_clients].append(r.rid)
    return assignment


# --------------------------------------------------------------------------- #
# Theoretical lower bound (Eqs. 31–32)                                        #
# --------------------------------------------------------------------------- #
@dataclass
class LowerBound:
    t_prefill_star: float
    t_decode_star: float

    @property
    def total(self) -> float:
        return self.t_prefill_star + self.t_decode_star


def theoretical_lower_bound(
    requests: Sequence[Request],
    n_clients: int,
    cost_model: CostModel,
    use_true_lengths: bool = True,
) -> LowerBound:
    """T_LB = t^p* + t^d*.

    t^p* = T_L^p ⌈Σ_i N_i^p / N_L^cap⌉     (prefill fully packed at level L)
    t^d* = optimal decode makespan. Decode runs in lockstep rounds of ≤ J
           tokens; a round with n active clients costs T_oh + T_tok·n, so
           per-token system time is minimized at n = J. Hence at least
           ⌈Σ_i N_i^d / J⌉ rounds are needed, none cheaper (per token) than a
           full round; and no request finishes in fewer than N_i^d rounds,
           each at least the single-client round time. t^d* is the max of the
           two bounds — the paper's P||Cmax construction (Eqs. 26–30).
    """
    lvl = cost_model.max_level
    total_prefill_tokens = sum(r.n_prefill for r in requests)
    n_stages = int(np.ceil(total_prefill_tokens / lvl.cap_tokens))
    t_p_star = lvl.duration_s * n_stages

    def dlen(r: Request) -> int:
        return r.n_decode if use_true_lengths else int(r.n_decode_est or r.n_decode)

    lens = np.asarray([dlen(r) for r in requests], dtype=np.float64)
    if len(lens) == 0:
        return LowerBound(t_p_star, 0.0)
    packed_rounds = float(np.ceil(np.sum(lens) / n_clients))
    t_d_star = max(
        packed_rounds * cost_model.decode_round_time(n_clients),
        float(np.max(lens)) * cost_model.decode_round_time(1),
    )
    return LowerBound(t_prefill_star=t_p_star, t_decode_star=t_d_star)
