"""Heterogeneous fleet scheduling — R||Cmax: the paper's offline layer
generalized to replicas that run at different speeds.

The paper's offline model (Eqs. 26–30) and lower bound (Eqs. 31–32) assume
identical machines: one shared ``CostModel`` prices every client, which is
P||Cmax. Real fleets mix accelerator generations, so this module lifts the
same three pieces to *unrelated* machines, where request ``i`` costs
``T[i, j]`` seconds on replica ``j`` — each entry priced through that
replica's own ``CostModel`` (seeded from a per-replica prior, refit live by
that replica's ``OnlineProfiler``):

  * ``hetero_lpt_assign``   — speed-scaled LPT seed: jobs descend by their
                              best-machine size, each lands on the replica
                              minimizing its *completion time* there (load +
                              T[i, j]), not the emptiest queue.
  * ``hetero_local_search`` — move/swap refinement where every candidate is
                              re-priced through the destination replica's
                              column of the weight matrix.
  * ``hetero_lp_lower_bound`` — the assignment-level R||Cmax floor:
                              max(LP relaxation, max_i min_j T[i, j]),
                              reducing to P||Cmax's max(mean load, max item)
                              when all columns are identical.
  * ``hetero_theoretical_lower_bound`` — the wall-clock fleet floor
                              (Eqs. 31–32 generalized): stage/round terms
                              priced at the fleet's harmonic-mean stage
                              time, single-request term at the fastest
                              replica. Recovers ``theoretical_lower_bound``
                              at n_clients = replicas × slots *exactly* when
                              every replica's cost model is identical.

Execution-side plumbing (per-replica profilers, ``speed_factor`` virtual
time, speed-aware dispatch and stealing) lives in ``serving.fleet``; this
module is pure scheduling math shared with tests and benchmarks.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from .cost_model import CostModel
from .offline import LowerBound, OfflineResult, theoretical_lower_bound
from .types import Request


@dataclass(frozen=True)
class ReplicaSpec:
    """Static description of one replica in a heterogeneous fleet.

    ``speed_factor`` is relative speed (1.0 = the fleet's baseline; 0.5 =
    half as fast, stage durations double). It does double duty: it seeds the
    replica's cost-model prior (``resolve_cost_model``) and it scales the
    engine's virtual-time stage clock so mixed-generation fleets are
    emulatable — and deterministically testable — on one CPU host. An
    explicit ``cost_model`` overrides the scaled prior (e.g. a replica whose
    prefill/decode ratio differs, not just its clock rate).
    """

    speed_factor: float = 1.0
    cost_model: Optional[CostModel] = None
    name: str = ""

    def __post_init__(self) -> None:
        if self.speed_factor <= 0:
            raise ValueError("speed_factor must be positive")

    def resolve_cost_model(self, base: CostModel) -> CostModel:
        """The replica's cost-model prior: the explicit model if given,
        otherwise the fleet's base model scaled by this replica's speed."""
        if self.cost_model is not None:
            return self.cost_model
        return base.scaled(self.speed_factor)


def replica_request_weight(
    req: Request,
    cost_model: CostModel,
    slots_per_replica: int,
    remaining_decode: Optional[int] = None,
    cached_prefill: Optional[int] = None,
) -> float:
    """Request ``req``'s estimated service time on one replica: prefill
    plus client wall-clock decode completion at that replica's slot count,
    priced through the replica's own cost model. THE per-request pricing
    rule of the heterogeneous layer — the offline weight matrix, the
    ``least_load`` dispatch load, and the steal gate all call this one
    function, so the solve and the online layer can never silently
    diverge. ``remaining_decode`` overrides the decode estimate for
    partially-served requests (dispatch load accounting).

    ``cached_prefill`` is how many of the request's prompt tokens THIS
    replica's prefix cache would supply (warm-state probe): the prefill
    term prices only the uncached remainder, so a replica that already
    holds a request's shared prefix genuinely bids lower than a cold one.
    Defaults to ``req.cached_prefill`` (0 for cache-less fleets — the
    historical pricing, unchanged)."""
    decode = (
        int(req.n_decode_est or req.n_decode)
        if remaining_decode is None else max(remaining_decode, 0)
    )
    cached = req.cached_prefill if cached_prefill is None else cached_prefill
    uncached = max(req.n_prefill - max(cached, 0), 0)
    return cost_model.prefill_time(uncached) + (
        cost_model.estimated_decode_completion(decode, slots_per_replica)
    )


def replica_resume_weight(
    req: Request,
    cost_model: CostModel,
    slots_per_replica: int,
    remaining_decode: int,
) -> float:
    """Service time of a page-copied (live-migrated) in-flight request on a
    replica: decode-only. The import lands the request's KV pages directly
    into the destination pool, so unlike ``replica_request_weight`` no
    prefill is ever re-paid — which is exactly why moving a running
    straggler can price in where re-queueing it could not. The running-slot
    steal gate and the drain placement both price through this rule."""
    return cost_model.estimated_decode_completion(
        max(remaining_decode, 0), slots_per_replica
    )


def hetero_weights(
    requests: Sequence[Request],
    cost_models: Sequence[CostModel],
    slots_per_replica: int,
    replica_penalties: Optional[Sequence[float]] = None,
    cached_tokens: Optional[np.ndarray] = None,
) -> np.ndarray:
    """The R||Cmax weight matrix ``T[i, j]``: request ``i``'s estimated
    service time on replica ``j`` (``replica_request_weight`` evaluated
    per replica cost model — the same pricing ``least_load`` dispatch
    uses). ``replica_penalties`` multiplies whole columns (≥ 1.0 each):
    the health layer prices SUSPECT replicas out of the offline solve by
    inflating their columns, rather than deleting them — the solver's
    shape stays R-wide and a penalized replica still takes work if every
    alternative is worse.

    ``cached_tokens`` — an ``(n_requests, n_replicas)`` matrix of prompt
    tokens each replica's warm prefix cache would supply — makes the
    prefill term per-(request, replica): a replica already holding a
    request's shared prefix bids its uncached remainder only, so cache
    affinity flows into the R||Cmax solve instead of being a hot-path
    accident. None (the default) prices ``Request.cached_prefill``
    uniformly — 0 for cache-less fleets, the historical matrix."""
    n_i, n_j = len(requests), len(cost_models)
    if replica_penalties is not None and len(replica_penalties) != n_j:
        raise ValueError(
            f"{len(replica_penalties)} penalties for {n_j} replicas"
        )
    if cached_tokens is not None:
        cached_tokens = np.asarray(cached_tokens)
        if cached_tokens.shape != (n_i, n_j):
            raise ValueError(
                f"cached_tokens shape {cached_tokens.shape} != ({n_i}, {n_j})"
            )
    t = np.zeros((n_i, n_j), dtype=np.float64)
    for j, cm in enumerate(cost_models):
        pen = 1.0 if replica_penalties is None else float(replica_penalties[j])
        if pen < 1.0:
            raise ValueError("replica penalties must be >= 1.0")
        for i, r in enumerate(requests):
            t[i, j] = pen * replica_request_weight(
                r, cm, slots_per_replica,
                cached_prefill=(
                    None if cached_tokens is None
                    else int(cached_tokens[i, j])
                ),
            )
    return t


# --------------------------------------------------------------------------- #
# Heuristics                                                                  #
# --------------------------------------------------------------------------- #
# A "machine" in this R||Cmax instance is a whole REPLICA: ``slots`` clients
# decoding in parallel. Its estimated completion ("span") is therefore NOT
# the sum of its items' client-wall-times but
#
#     span_j = max( Σ_i T[i, j] / slots ,  max_i T[i, j] )
#
# — the average-client-load floor (work spreads over the slots) and the
# single-item floor (one request cannot split across clients; a long decode
# on a slow replica straggles its client for the full item weight no matter
# how idle the neighbors are). Summed loads alone would happily trade one
# huge item for several small ones and park a straggler on the slow replica.
def _replica_spans(
    assignment: List[List[int]], weights: np.ndarray, slots: int
) -> np.ndarray:
    spans = np.zeros(weights.shape[1], dtype=np.float64)
    for j, items in enumerate(assignment):
        if not items:
            continue
        w = [float(weights[i, j]) for i in items]
        spans[j] = max(sum(w) / slots, max(w))
    return spans


def hetero_lpt_assign(weights: np.ndarray, slots: int) -> List[List[int]]:
    """Speed-scaled LPT: jobs ordered by descending best-machine size
    (min_j T[i, j]), each assigned to the replica whose estimated span
    grows the least by taking it. Reduces to plain LPT when all columns
    are identical."""
    n_i, n_j = weights.shape
    order = np.argsort(-weights.min(axis=1), kind="stable")
    sums = np.zeros(n_j, dtype=np.float64)
    maxes = np.zeros(n_j, dtype=np.float64)
    assignment: List[List[int]] = [[] for _ in range(n_j)]
    for i in order:
        new_spans = np.maximum(
            (sums + weights[i]) / slots, np.maximum(maxes, weights[i])
        )
        j = int(np.argmin(new_spans))
        assignment[j].append(int(i))
        sums[j] += weights[i, j]
        maxes[j] = max(maxes[j], float(weights[i, j]))
    return assignment


def hetero_local_search(
    assignment: List[List[int]],
    weights: np.ndarray,
    slots: int,
    max_rounds: int = 200,
) -> List[List[int]]:
    """Move/swap local search on the R||Cmax makespan (max replica span).

    Unlike the P||Cmax version, a candidate move changes the item's weight:
    moving ``i`` from the max-span replica ``a`` to ``b`` removes
    ``T[i, a]`` and adds ``T[i, b]`` — every candidate is re-priced through
    the *destination* replica's cost model. Each round takes the best strict
    makespan improvement among all single-item moves off the max-span
    replica, falling back to the best pairwise swap with any other replica.
    """
    assignment = [list(c) for c in assignment]
    n_j = weights.shape[1]

    def span_of(items: List[int], j: int) -> float:
        if not items:
            return 0.0
        w = [float(weights[i, j]) for i in items]
        return max(sum(w) / slots, max(w))

    for _ in range(max_rounds):
        spans = _replica_spans(assignment, weights, slots)
        a = int(np.argmax(spans))

        def makespan_excluding(*excl: int) -> float:
            rest = [spans[j] for j in range(n_j) if j not in excl]
            return max(rest) if rest else 0.0

        best_move = None  # (new_makespan, i, dest)
        for i in assignment[a]:
            rem_a = [x for x in assignment[a] if x != i]
            for b in range(n_j):
                if b == a:
                    continue
                new_mk = max(
                    span_of(rem_a, a),
                    span_of(assignment[b] + [i], b),
                    makespan_excluding(a, b),
                )
                if new_mk < spans[a] - 1e-12 and (
                    best_move is None or new_mk < best_move[0] - 1e-12
                ):
                    best_move = (new_mk, i, b)
        if best_move is not None:
            _, i, b = best_move
            assignment[a].remove(i)
            assignment[b].append(i)
            continue
        best_swap = None  # (new_makespan, x, b, y)
        for b in range(n_j):
            if b == a:
                continue
            for x in assignment[a]:
                rem_a = [i for i in assignment[a] if i != x]
                for y in assignment[b]:
                    rem_b = [i for i in assignment[b] if i != y]
                    new_mk = max(
                        span_of(rem_a + [y], a),
                        span_of(rem_b + [x], b),
                        makespan_excluding(a, b),
                    )
                    if new_mk < spans[a] - 1e-12 and (
                        best_swap is None or new_mk < best_swap[0] - 1e-12
                    ):
                        best_swap = (new_mk, x, b, y)
        if best_swap is None:
            break
        _, x, b, y = best_swap
        assignment[a].remove(x)
        assignment[b].remove(y)
        assignment[a].append(y)
        assignment[b].append(x)
    return assignment


# --------------------------------------------------------------------------- #
# Lower bounds                                                                #
# --------------------------------------------------------------------------- #
def hetero_lp_lower_bound(weights: np.ndarray, slots: int = 1) -> float:
    """Assignment-level R||Cmax lower bound, in replica-span units (each
    machine is a replica of ``slots`` parallel clients — see
    ``_replica_spans``).

    max of three valid floors:

      * LP relaxation of the assignment model over per-slot loads
        (fractional x_{ij} on weights T/slots, scipy HiGHS; skipped
        silently if the solver is unavailable or fails);
      * ``max_i min_j T[i, j]`` — every job occupies one client somewhere,
        at best on its fastest machine (the item-integrality term both
        relaxations miss);
      * ``Σ_i min_j T[i, j] / (R·slots)`` — work conservation at
        best-machine pricing (the closed-form stand-in for the LP).

    With identical columns (homogeneous fleet) this reduces to P||Cmax's
    ``max(mean per-client load, max item)`` over the flat pool of R·slots
    clients — the same form ``solve_offline`` reports as its
    ``lp_lower_bound``.
    """
    if weights.size == 0:
        return 0.0
    n_i, n_j = weights.shape
    best = weights.min(axis=1)
    bound = max(float(best.max()), float(best.sum()) / (n_j * slots))
    lp = _assignment_lp(weights / slots)
    if lp is not None:
        bound = max(bound, lp)
    return bound


def _assignment_lp(weights: np.ndarray) -> Optional[float]:
    """LP relaxation of min-makespan assignment: min C s.t. Σ_j x_ij = 1,
    Σ_i T_ij x_ij ≤ C, x ∈ [0, 1]. Returns None when scipy is unavailable
    or the solve fails (callers fall back to the closed-form floors)."""
    try:
        import scipy.sparse as sp
        from scipy.optimize import linprog
    except Exception:  # noqa: BLE001 — scipy is optional here
        return None
    n_i, n_j = weights.shape
    n_x = n_i * n_j
    c = np.zeros(n_x + 1)
    c[-1] = 1.0
    rows, cols, vals = [], [], []
    for i in range(n_i):
        for j in range(n_j):
            rows.append(i)
            cols.append(i * n_j + j)
            vals.append(1.0)
    a_eq = sp.csr_matrix((vals, (rows, cols)), shape=(n_i, n_x + 1))
    rows, cols, vals = [], [], []
    for j in range(n_j):
        for i in range(n_i):
            rows.append(j)
            cols.append(i * n_j + j)
            vals.append(float(weights[i, j]))
        rows.append(j)
        cols.append(n_x)
        vals.append(-1.0)
    a_ub = sp.csr_matrix((vals, (rows, cols)), shape=(n_j, n_x + 1))
    try:
        res = linprog(
            c,
            A_eq=a_eq,
            b_eq=np.ones(n_i),
            A_ub=a_ub,
            b_ub=np.zeros(n_j),
            bounds=[(0.0, 1.0)] * n_x + [(0.0, None)],
            method="highs",
        )
    except Exception:  # noqa: BLE001
        return None
    if not res.success:
        return None
    return float(res.x[-1])


def _harmonic_mean(values: Sequence[float]) -> float:
    """Harmonic mean with an exact short-circuit for equal inputs, so the
    homogeneous reduction of the fleet bound is bit-identical to the
    P||Cmax formula rather than equal-up-to-rounding."""
    vals = [float(v) for v in values]
    if not vals:
        return 0.0
    if min(vals) == max(vals):
        return vals[0]
    if min(vals) <= 0:
        return 0.0
    return len(vals) / sum(1.0 / v for v in vals)


def hetero_theoretical_lower_bound(
    requests: Sequence[Request],
    cost_models: Sequence[CostModel],
    slots_per_replica: int,
    use_true_lengths: bool = True,
) -> LowerBound:
    """Wall-clock fleet floor: Eqs. 31–32 generalized to per-replica speeds.

    The paper's flat-pool construction prices ``ceil(ΣN^p / cap)`` prefill
    stages at the level-L duration and ``ceil(ΣN^d / J)`` packed decode
    rounds at the full-batch round time. With replicas of differing speed
    the fleet's aggregate stage-production rate is the sum of per-replica
    rates, so each stage/round term is priced at the *harmonic mean* of the
    per-replica stage times (R machines at harmonic-mean time T̄ produce
    stages exactly as fast as the actual mixed fleet); the
    longest-single-request term runs at best on the *fastest* replica
    (min_j single-client round time). With identical cost models every
    harmonic mean collapses to the shared value and the result equals
    ``theoretical_lower_bound(requests, R × slots, cm)`` exactly — the
    P||Cmax bound is the homogeneous special case, unit-tested as such.

    Like the paper's bound, this is the flat-pool idealization (perfect
    packing, no prefill/decode interleaving conflicts): a floor up to
    cost-model fit error, which ``benchmarks/hetero_fleet.py`` validates
    against measured per-replica models.
    """
    if not cost_models:
        raise ValueError("need at least one replica cost model")
    if all(cm == cost_models[0] for cm in cost_models[1:]):
        # exact homogeneous reduction — delegate to the paper's formula
        return theoretical_lower_bound(
            requests,
            len(cost_models) * slots_per_replica,
            cost_models[0],
            use_true_lengths=use_true_lengths,
        )
    n_rep = len(cost_models)
    j_total = n_rep * slots_per_replica
    cap = max(cm.max_level.cap_tokens for cm in cost_models)
    total_prefill = sum(r.n_prefill for r in requests)
    n_stages = int(np.ceil(total_prefill / cap))
    t_p_star = n_stages * _harmonic_mean(
        [cm.max_level.duration_s for cm in cost_models]
    )

    def dlen(r: Request) -> int:
        return r.n_decode if use_true_lengths else int(r.n_decode_est or r.n_decode)

    lens = np.asarray([dlen(r) for r in requests], dtype=np.float64)
    if len(lens) == 0:
        return LowerBound(t_p_star, 0.0)
    packed_rounds = float(np.ceil(np.sum(lens) / j_total))
    round_hm = _harmonic_mean([cm.decode_round_time(j_total) for cm in cost_models])
    fastest_single = min(cm.decode_round_time(1) for cm in cost_models)
    t_d_star = max(
        packed_rounds * round_hm,
        float(np.max(lens)) * fastest_single,
    )
    return LowerBound(t_prefill_star=t_p_star, t_decode_star=t_d_star)


# --------------------------------------------------------------------------- #
# Composition                                                                 #
# --------------------------------------------------------------------------- #
def _mapped_result(
    requests: Sequence[Request],
    assignment: List[List[int]],
    weights: np.ndarray,
    slots: int,
    solver: str,
    t0: float,
) -> OfflineResult:
    spans = _replica_spans(assignment, weights, slots)
    rid_of = [r.rid for r in requests]
    mapped: List[List[int]] = []
    for client in assignment:
        # longest-first per replica (Algorithm 1's sort by N^p + N^d)
        ordered = sorted(client, key=lambda i: -requests[i].est_total_tokens)
        mapped.append([rid_of[i] for i in ordered])
    return OfflineResult(
        assignment=mapped,
        loads=[float(x) for x in spans],
        makespan_est=float(np.max(spans)) if len(spans) else 0.0,
        lp_lower_bound=hetero_lp_lower_bound(weights, slots),
        solver=solver,
        solve_seconds=time.perf_counter() - t0,
    )


def solve_hetero(
    requests: Sequence[Request],
    cost_models: Sequence[CostModel],
    slots_per_replica: int,
    local_search_rounds: int = 200,
    replica_penalties: Optional[Sequence[float]] = None,
) -> OfflineResult:
    """Solve the R||Cmax offline assignment: speed-scaled LPT seed + local
    search re-priced through each replica's own cost model. Returns the same
    ``OfflineResult`` shape as ``solve_offline`` (per-replica rid lists
    ordered longest-first, loads, makespan estimate, LP lower bound), so the
    fleet layer treats both solvers identically. ``replica_penalties``
    inflates whole columns of the weight matrix (see ``hetero_weights``) —
    how SUSPECT replicas are priced out of a solve without changing its
    shape."""
    if not cost_models:
        raise ValueError("need at least one replica cost model")
    t0 = time.perf_counter()
    weights = hetero_weights(
        requests, cost_models, slots_per_replica,
        replica_penalties=replica_penalties,
    )
    assignment = hetero_lpt_assign(weights, slots_per_replica)
    assignment = hetero_local_search(
        assignment, weights, slots_per_replica, max_rounds=local_search_rounds
    )
    return _mapped_result(
        requests, assignment, weights, slots_per_replica,
        "hetero-lpt+local_search", t0,
    )


def evaluate_hetero_assignment(
    requests: Sequence[Request],
    assignment: List[List[int]],
    cost_models: Sequence[CostModel],
    slots_per_replica: int,
    solver: str = "external",
) -> OfflineResult:
    """Price an externally-produced assignment (replica → rid lists, e.g. a
    speed-blind ``solve_offline`` partition or ``round_robin_assign``) on
    the heterogeneous weight matrix — so speed-blind baselines and the
    R||Cmax solver are compared on identical terms."""
    if len(assignment) != len(cost_models):
        raise ValueError("assignment length != number of replicas")
    t0 = time.perf_counter()
    weights = hetero_weights(requests, cost_models, slots_per_replica)
    pos_of = {r.rid: i for i, r in enumerate(requests)}
    positional = [[pos_of[rid] for rid in client] for client in assignment]
    return _mapped_result(
        requests, positional, weights, slots_per_replica, solver, t0
    )
