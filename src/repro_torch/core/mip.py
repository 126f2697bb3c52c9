"""The original MIP model (Eqs. 1–25) — deterministic equivalence of the
inference-scheduling problem, solved at toy scale with scipy's HiGHS.

The paper formulates the full problem but reports it unsolvable at scale
(100 requests × 20 clients ≈ 1 h in Gurobi without closing the gap); the
hybrid method exists precisely because of this. We build the model anyway:

  * it documents the formulation as executable code,
  * toy instances validate the hybrid heuristic's optimality gap
    (``benchmarks`` §mip_toy), and
  * the LP relaxation provides an instance-specific dual bound.

Interpretation notes (see DESIGN.md §2):
  * T^d in Eq. (8) is the *round* time: every decode round serves all active
    clients and costs ``decode_round_time(J)``; a request's decode work in
    rounds equals its token count. We therefore measure decode in rounds and
    multiply by the full-batch round duration.
  * The paper omits the coupling w_{ijk} ≤ d_{ijk} (a proportion can only be
    executed in a stage assigned to that request); we add it — without it the
    model can place decode work in unassigned stages.
  * Eq. (7) forces every bin to select a level, so a K larger than the
    optimal bin count inflates t_max by the unused bins' level durations. We
    prepend an *empty level* (capacity 0, duration 0) so unused bins are
    free; this makes the objective monotone non-increasing in K, as intended.

Variable layout (column offsets into one flat vector):
  x   : I*J                binary   request→client assignment
  p   : I*J*K              binary   prefill stage assignment
  d   : I*J*K              binary   decode stage assignment
  w   : I*J*K              [0,1]    decode proportion
  y   : K*L                binary   prefill level indicator
  tsp : K                  R+       prefill stage start
  tsd : K                  R+       decode stage start
  np  : K                  R+       prefill stage length
  nd  : K                  R+       decode stage length
  tmax: 1                  R+
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .cost_model import CostModel
from .types import Request


@dataclass
class MIPSolution:
    status: str
    objective: float            # t_max (seconds)
    mip_gap: float
    solve_seconds: float
    x: np.ndarray               # (I, J)
    p: np.ndarray               # (I, J, K)
    d: np.ndarray               # (I, J, K)
    w: np.ndarray               # (I, J, K)
    y: np.ndarray               # (K, L)
    stage_times: Dict[str, np.ndarray]  # tsp, tsd, np, nd


class OriginalMIP:
    """Builder/solver for Eqs. (1)–(25) on a concrete instance."""

    def __init__(
        self,
        requests: Sequence[Request],
        n_clients: int,
        n_bins: int,
        cost_model: CostModel,
        big_m: Optional[float] = None,
    ):
        self.requests = list(requests)
        self.I = len(self.requests)
        self.J = n_clients
        self.K = n_bins
        self.cm = cost_model
        # Level 0 is the explicit empty level (see docstring).
        from .cost_model import PrefillLevel

        self.levels = [PrefillLevel(index=0, cap_tokens=0, duration_s=0.0)] + [
            PrefillLevel(index=lv.index + 1, cap_tokens=lv.cap_tokens, duration_s=lv.duration_s)
            for lv in cost_model.levels
        ]
        self.L = len(self.levels)
        # Decode measured in rounds × full-batch round time (see docstring).
        self.td_round = cost_model.decode_round_time(n_clients)
        self.big_m = big_m if big_m is not None else float(self.K + 1)

        I, J, K, L = self.I, self.J, self.K, self.L
        self.off_x = 0
        self.off_p = self.off_x + I * J
        self.off_d = self.off_p + I * J * K
        self.off_w = self.off_d + I * J * K
        self.off_y = self.off_w + I * J * K
        self.off_tsp = self.off_y + K * L
        self.off_tsd = self.off_tsp + K
        self.off_np = self.off_tsd + K
        self.off_nd = self.off_np + K
        self.off_tmax = self.off_nd + K
        self.n_var = self.off_tmax + 1

    # -- index helpers ---------------------------------------------------- #
    def ix(self, i: int, j: int) -> int:
        return self.off_x + i * self.J + j

    def ip(self, i: int, j: int, k: int) -> int:
        return self.off_p + (i * self.J + j) * self.K + k

    def idd(self, i: int, j: int, k: int) -> int:
        return self.off_d + (i * self.J + j) * self.K + k

    def iw(self, i: int, j: int, k: int) -> int:
        return self.off_w + (i * self.J + j) * self.K + k

    def iy(self, k: int, l: int) -> int:
        return self.off_y + k * self.L + l

    # -- model ------------------------------------------------------------ #
    def build(self):
        import scipy.sparse as sp
        from scipy.optimize import Bounds, LinearConstraint

        I, J, K, L = self.I, self.J, self.K, self.L
        M = self.big_m
        rows_ub: List[Tuple[List[int], List[float], float]] = []  # (cols, vals, ub)
        rows_eq: List[Tuple[List[int], List[float], float]] = []

        def ub_row(cols, vals, ub):
            rows_ub.append((cols, vals, float(ub)))

        def eq_row(cols, vals, rhs):
            rows_eq.append((cols, vals, float(rhs)))

        # (2) tsd_k + nd_k - tmax <= 0
        for k in range(K):
            ub_row([self.off_tsd + k, self.off_nd + k, self.off_tmax], [1, 1, -1], 0)
        # (3) tsd_{k-1} + nd_{k-1} - tsp_k <= 0
        for k in range(1, K):
            ub_row(
                [self.off_tsd + k - 1, self.off_nd + k - 1, self.off_tsp + k],
                [1, 1, -1],
                0,
            )
        # (4) tsp_k + np_k - tsd_k <= 0
        for k in range(K):
            ub_row([self.off_tsp + k, self.off_np + k, self.off_tsd + k], [1, 1, -1], 0)
        # (5) Σ_l T_l^p y_kl - np_k <= 0
        for k in range(K):
            cols = [self.iy(k, l) for l in range(L)] + [self.off_np + k]
            vals = [lv.duration_s for lv in self.levels] + [-1.0]
            ub_row(cols, vals, 0)
        # (6) Σ_ij N_i^p p_ijk - Σ_l N_l^cap y_kl <= 0
        for k in range(K):
            cols, vals = [], []
            for i in range(I):
                for j in range(J):
                    cols.append(self.ip(i, j, k))
                    vals.append(float(self.requests[i].n_prefill))
            for l in range(L):
                cols.append(self.iy(k, l))
                vals.append(-float(self.levels[l].cap_tokens))
            ub_row(cols, vals, 0)
        # (7) Σ_l y_kl = 1
        for k in range(K):
            eq_row([self.iy(k, l) for l in range(L)], [1.0] * L, 1)
        # (8) T^d Σ_i N_i^d w_ijk - nd_k <= 0   ∀ j,k   (T^d = round time)
        for k in range(K):
            for j in range(J):
                cols = [self.iw(i, j, k) for i in range(I)] + [self.off_nd + k]
                vals = [
                    self.td_round * float(self.requests[i].n_decode_est or self.requests[i].n_decode)
                    for i in range(I)
                ] + [-1.0]
                ub_row(cols, vals, 0)
        # (9) p_ijk - d_ijk <= 0
        for i in range(I):
            for j in range(J):
                for k in range(K):
                    ub_row([self.ip(i, j, k), self.idd(i, j, k)], [1, -1], 0)
        # (10) contiguity: for k1<k2:
        #   (k2-k1+1) - M(2 - d_ijk1 - d_ijk2) - Σ_{k1..k2} d <= 0
        #   → -M d1 - M d2 - Σ d <= -(k2-k1+1) - 2M  ... rearranged:
        #   M d_ijk1 + M d_ijk2 - Σ_{k'=k1}^{k2} d_ijk' <= 2M - (k2-k1+1)
        for i in range(I):
            for j in range(J):
                for k1 in range(K):
                    for k2 in range(k1 + 1, K):
                        cols = [self.idd(i, j, k1), self.idd(i, j, k2)]
                        vals = [M, M]
                        for kk in range(k1, k2 + 1):
                            cols.append(self.idd(i, j, kk))
                            vals.append(-1.0)
                        ub_row(cols, vals, 2 * M - (k2 - k1 + 1))
        # (11) no decode before prefill: d_ijk2 <= M(1 - p_ijk1) for k1 > k2
        for i in range(I):
            for j in range(J):
                for k1 in range(K):
                    for k2 in range(k1):
                        ub_row([self.idd(i, j, k2), self.ip(i, j, k1)], [1, M], M)
        # (12) Σ_i d_ijk <= 1
        for j in range(J):
            for k in range(K):
                ub_row([self.idd(i, j, k) for i in range(I)], [1.0] * I, 1)
        # (14) Σ_k w_ijk = x_ij
        for i in range(I):
            for j in range(J):
                cols = [self.iw(i, j, k) for k in range(K)] + [self.ix(i, j)]
                eq_row(cols, [1.0] * K + [-1.0], 0)
        # (15) Σ_jk w_ijk = 1
        for i in range(I):
            cols = [self.iw(i, j, k) for j in range(J) for k in range(K)]
            eq_row(cols, [1.0] * (J * K), 1)
        # (16) Σ_i p_ijk <= 1
        for j in range(J):
            for k in range(K):
                ub_row([self.ip(i, j, k) for i in range(I)], [1.0] * I, 1)
        # (17) Σ_k p_ijk = x_ij
        for i in range(I):
            for j in range(J):
                cols = [self.ip(i, j, k) for k in range(K)] + [self.ix(i, j)]
                eq_row(cols, [1.0] * K + [-1.0], 0)
        # (18) Σ_j x_ij = 1
        for i in range(I):
            eq_row([self.ix(i, j) for j in range(J)], [1.0] * J, 1)
        # (added) w_ijk <= d_ijk
        for i in range(I):
            for j in range(J):
                for k in range(K):
                    ub_row([self.iw(i, j, k), self.idd(i, j, k)], [1, -1], 0)

        def to_csr(rows):
            r, c, v, rhs = [], [], [], []
            for ri, (cols, vals, b) in enumerate(rows):
                for cc, vv in zip(cols, vals):
                    r.append(ri)
                    c.append(cc)
                    v.append(vv)
                rhs.append(b)
            mat = sp.csr_matrix((v, (r, c)), shape=(len(rows), self.n_var))
            return mat, np.asarray(rhs)

        a_ub, b_ub = to_csr(rows_ub)
        a_eq, b_eq = to_csr(rows_eq)
        constraints = [
            LinearConstraint(a_ub, ub=b_ub),
            LinearConstraint(a_eq, lb=b_eq, ub=b_eq),
        ]
        integrality = np.zeros(self.n_var)
        for off, size in [
            (self.off_x, I * J),
            (self.off_p, I * J * K),
            (self.off_d, I * J * K),
            (self.off_y, K * L),
        ]:
            integrality[off : off + size] = 1
        lb = np.zeros(self.n_var)
        ub = np.full(self.n_var, np.inf)
        ub[: self.off_y + K * L] = 1.0  # x, p, d, w, y are all in [0, 1]
        bounds = Bounds(lb=lb, ub=ub)
        c = np.zeros(self.n_var)
        c[self.off_tmax] = 1.0
        return c, constraints, integrality, bounds

    def solve(self, time_limit_s: float = 120.0, relax: bool = False) -> MIPSolution:
        from scipy.optimize import milp

        c, constraints, integrality, bounds = self.build()
        if relax:
            integrality = np.zeros_like(integrality)
        t0 = time.perf_counter()
        res = milp(
            c=c,
            constraints=constraints,
            integrality=integrality,
            bounds=bounds,
            options={"time_limit": time_limit_s, "presolve": True},
        )
        dt = time.perf_counter() - t0
        I, J, K, L = self.I, self.J, self.K, self.L
        if res.x is None:
            return MIPSolution(
                status=f"failed({res.status})",
                objective=float("nan"),
                mip_gap=float("nan"),
                solve_seconds=dt,
                x=np.zeros((I, J)),
                p=np.zeros((I, J, K)),
                d=np.zeros((I, J, K)),
                w=np.zeros((I, J, K)),
                y=np.zeros((K, L)),
                stage_times={},
            )
        xv = np.asarray(res.x)
        sol = MIPSolution(
            status="optimal" if res.status == 0 else f"status{res.status}",
            objective=float(res.fun),
            mip_gap=float(getattr(res, "mip_gap", 0.0) or 0.0),
            solve_seconds=dt,
            x=xv[self.off_x : self.off_p].reshape(I, J).round(6),
            p=xv[self.off_p : self.off_d].reshape(I, J, K).round(6),
            d=xv[self.off_d : self.off_w].reshape(I, J, K).round(6),
            w=xv[self.off_w : self.off_y].reshape(I, J, K).round(6),
            y=xv[self.off_y : self.off_tsp].reshape(K, L).round(6),
            stage_times={
                "tsp": xv[self.off_tsp : self.off_tsd],
                "tsd": xv[self.off_tsd : self.off_np],
                "np": xv[self.off_np : self.off_nd],
                "nd": xv[self.off_nd : self.off_tmax],
            },
        )
        return sol

    # -- validation ------------------------------------------------------- #
    def check_solution(self, sol: MIPSolution, atol: float = 1e-6) -> None:
        """Structural feasibility of an integral solution (used by tests)."""
        assert np.allclose(sol.x.sum(axis=1), 1, atol=atol), "Eq.(18) violated"
        assert np.allclose(sol.p.sum(axis=(1, 2)), 1, atol=atol), "Eq.(17+18)"
        assert np.allclose(sol.w.sum(axis=(1, 2)), 1, atol=atol), "Eq.(15)"
        for k in range(self.K):
            cap = float(np.dot(sol.y[k], [lv.cap_tokens for lv in self.levels]))
            used = sum(
                self.requests[i].n_prefill * sol.p[i, j, k]
                for i in range(self.I)
                for j in range(self.J)
            )
            assert used <= cap + atol, f"Eq.(6) violated at bin {k}"
        assert np.all(sol.w <= sol.d + atol), "w <= d coupling violated"
        assert np.all(sol.p.sum(axis=0) <= 1 + atol), "Eq.(16) violated"
        assert np.all(sol.d.sum(axis=0) <= 1 + atol), "Eq.(12) violated"


def recost_trace_mip_semantics(trace, cost_model: CostModel, n_clients: int) -> float:
    """Re-price a simulated trace under the MIP's planning semantics:
    prefill stages cost their quantized level duration; every decode round
    costs the full-batch round time. Under these semantics a heuristic
    schedule is directly comparable to (and can never beat) the MIP optimum
    on the same instance."""
    from .types import StageKind

    total = 0.0
    for s in trace.stages:
        if s.kind is StageKind.PREFILL:
            total += cost_model.quantized_prefill_time(
                min(s.tokens, cost_model.max_level.cap_tokens)
            )
        else:
            total += cost_model.decode_round_time(n_clients) * max(1, s.rounds)
    return total


def toy_instance(
    n_requests: int = 6,
    n_clients: int = 2,
    n_bins: int = 4,
    seed: int = 0,
    cost_model: Optional[CostModel] = None,
) -> Tuple[List[Request], int, int, CostModel]:
    """Small instance for MIP validation (decode overheads zeroed so the MIP
    round-time semantics and the simulator agree exactly at full batch)."""
    rng = np.random.default_rng(seed)
    cm = cost_model or CostModel(
        decode_overhead=0.0,
        prefill_overhead=10e-3,
        level_caps=(64, 128, 256),
    )
    reqs = [
        Request(
            rid=i,
            n_prefill=int(rng.integers(8, 33)),
            n_decode=int(rng.integers(4, 17)),
        )
        for i in range(n_requests)
    ]
    return reqs, n_clients, n_bins, cm
