"""Port parity, heterogeneous fleet scheduling: the port's copy of
``core.hetero`` (the R||Cmax offline solver, its lower bounds and the
per-replica pricing) against the reference on seeded random instances, and
the reference's engine-free hetero cases run against the port alone."""
import numpy as np
import pytest

from repro.core import CostModel as RefCostModel
from repro.core import Request as RefRequest
from repro.core import evaluate_hetero_assignment as ref_evaluate
from repro.core import hetero_lp_lower_bound as ref_lp_bound
from repro.core import hetero_theoretical_lower_bound as ref_bound
from repro.core import hetero_weights as ref_weights
from repro.core import solve_hetero as ref_solve
from repro_torch.core import (
    CostModel,
    FleetReport,
    ReplicaSpec,
    Request,
    ScheduleTrace,
    StageKind,
    StageRecord,
    evaluate_hetero_assignment,
    hetero_lp_lower_bound,
    hetero_theoretical_lower_bound,
    hetero_weights,
    round_robin_assign,
    solve_hetero,
    solve_offline,
    theoretical_lower_bound,
)

CM = CostModel(level_caps=(32, 64, 128))
TOL = 1e-12


def _requests(n=12, seed=0, cls=Request):
    rng = np.random.default_rng(seed)
    return [
        cls(
            rid=i,
            n_prefill=8 + int(rng.integers(0, 12)),
            n_decode=4 + int(rng.integers(0, 28)),
        )
        for i in range(n)
    ]


def _instance(seed):
    """A random instance: requests, per-replica speeds and slots."""
    rng = np.random.default_rng(100 + seed)
    n_req = int(rng.integers(4, 30))
    speeds = [float(x) for x in rng.uniform(0.2, 2.0, size=int(rng.integers(1, 5)))]
    slots = int(rng.integers(1, 9))
    return n_req, speeds, slots


def _models(speeds):
    ref_cm = RefCostModel(level_caps=(32, 64, 128))
    return [ref_cm.scaled(s) for s in speeds], [CM.scaled(s) for s in speeds]


def _close(a, b):
    assert abs(a - b) <= TOL * max(1.0, abs(a), abs(b)), (a, b)


# --------------------------------------------------------------------------- #
# Parity with the reference                                                   #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", range(6))
def test_solve_hetero_matches_the_reference(seed):
    n_req, speeds, slots = _instance(seed)
    ref_cms, cms = _models(speeds)
    ref = ref_solve(_requests(n_req, seed, RefRequest), ref_cms, slots)
    got = solve_hetero(_requests(n_req, seed), cms, slots)
    assert got.assignment == ref.assignment
    assert got.solver == ref.solver
    np.testing.assert_allclose(got.loads, ref.loads, rtol=TOL, atol=0)
    _close(got.makespan_est, ref.makespan_est)
    _close(got.lp_lower_bound, ref.lp_lower_bound)
    _close(got.gap, ref.gap)


@pytest.mark.parametrize("seed", range(6))
def test_hetero_bounds_match_the_reference(seed):
    n_req, speeds, slots = _instance(seed)
    ref_cms, cms = _models(speeds)
    ref_reqs, reqs = _requests(n_req, seed, RefRequest), _requests(n_req, seed)
    ref = ref_bound(ref_reqs, ref_cms, slots)
    got = hetero_theoretical_lower_bound(reqs, cms, slots)
    _close(got.t_prefill_star, ref.t_prefill_star)
    _close(got.t_decode_star, ref.t_decode_star)
    _close(got.total, ref.total)
    ref_w = ref_weights(ref_reqs, ref_cms, slots)
    w = hetero_weights(reqs, cms, slots)
    np.testing.assert_allclose(w, ref_w, rtol=TOL, atol=0)
    _close(hetero_lp_lower_bound(w, slots), ref_lp_bound(ref_w, slots))


@pytest.mark.parametrize("seed", range(6))
def test_evaluate_hetero_assignment_matches_the_reference(seed):
    n_req, speeds, slots = _instance(seed)
    ref_cms, cms = _models(speeds)
    reqs = _requests(n_req, seed)
    asn = round_robin_assign(reqs, len(speeds))
    ref = ref_evaluate(_requests(n_req, seed, RefRequest), asn, ref_cms, slots, solver="rr")
    got = evaluate_hetero_assignment(reqs, asn, cms, slots, solver="rr")
    assert got.assignment == ref.assignment and got.solver == ref.solver
    np.testing.assert_allclose(got.loads, ref.loads, rtol=TOL, atol=0)
    _close(got.makespan_est, ref.makespan_est)
    _close(got.lp_lower_bound, ref.lp_lower_bound)


# --------------------------------------------------------------------------- #
# The reference's engine-free cases, against the port                         #
# --------------------------------------------------------------------------- #
def test_scaled_cost_model_halves_durations():
    cm = CostModel(level_caps=(64, 128))
    fast = cm.scaled(2.0)
    assert fast.prefill_time(100) == pytest.approx(cm.prefill_time(100) / 2)
    assert fast.decode_round_time(8) == pytest.approx(cm.decode_round_time(8) / 2)
    assert fast.decode_dispatch == pytest.approx(cm.decode_dispatch / 2)
    assert fast.level_caps == cm.level_caps
    assert cm.scaled(1.0) == cm
    with pytest.raises(ValueError):
        cm.scaled(0.0)


def test_replica_spec_resolves_prior():
    base = CostModel(level_caps=(64, 128))
    assert ReplicaSpec(speed_factor=0.5).resolve_cost_model(base) == base.scaled(0.5)
    explicit = CostModel(decode_overhead=1.23, level_caps=(64, 128))
    assert ReplicaSpec(speed_factor=0.5, cost_model=explicit).resolve_cost_model(base) is explicit
    with pytest.raises(ValueError):
        ReplicaSpec(speed_factor=-1.0)


def test_hetero_wallclock_bound_reduces_exactly_to_p_cmax():
    reqs = _requests(20)
    for n_rep, slots in ((2, 4), (3, 2), (1, 8)):
        cms = [CM.scaled(1.0) for _ in range(n_rep)]
        het = hetero_theoretical_lower_bound(reqs, cms, slots)
        hom = theoretical_lower_bound(reqs, n_rep * slots, CM)
        assert het.total == hom.total
        assert het.t_prefill_star == hom.t_prefill_star
        assert het.t_decode_star == hom.t_decode_star
    cms = [CM.scaled(0.5), CM.scaled(0.5)]
    het = hetero_theoretical_lower_bound(reqs, cms, 4)
    assert het.total == theoretical_lower_bound(reqs, 8, CM.scaled(0.5)).total


def test_hetero_wallclock_bound_between_speeds():
    reqs = _requests(20)
    fast, slow = CM.scaled(1.0), CM.scaled(0.5)
    mixed = hetero_theoretical_lower_bound(reqs, [fast, slow], 4).total
    all_fast = hetero_theoretical_lower_bound(reqs, [fast, fast], 4).total
    all_slow = hetero_theoretical_lower_bound(reqs, [slow, slow], 4).total
    assert all_fast < mixed < all_slow


def test_hetero_lp_bound_reduces_to_p_cmax_form():
    reqs = _requests(15)
    w = hetero_weights(reqs, [CM, CM], 4)
    col = w[:, 0]
    assert hetero_lp_lower_bound(w, slots=4) == pytest.approx(
        max(float(col.max()), float(col.sum()) / 8)
    )
    assert hetero_lp_lower_bound(np.zeros((0, 2)), slots=4) == 0.0


def test_hetero_lp_bound_floors_every_assignment():
    reqs = _requests(16)
    cms = [CM.scaled(1.0), CM.scaled(0.4)]
    w = hetero_weights(reqs, cms, 4)
    lb = hetero_lp_lower_bound(w, slots=4)
    het = solve_hetero(reqs, cms, 4)
    rr = evaluate_hetero_assignment(reqs, round_robin_assign(reqs, 2), cms, 4, solver="rr")
    blind = evaluate_hetero_assignment(
        reqs, solve_offline(reqs, 2, CM).assignment, cms, 4, solver="blind"
    )
    for result in (het, rr, blind):
        assert lb <= result.makespan_est + 1e-9
    assert het.lp_lower_bound == pytest.approx(lb)


def test_solve_hetero_beats_speed_blind_on_two_speed_fleet():
    reqs = _requests(20)
    cms = [CM.scaled(1.0), CM.scaled(0.5)]
    het = solve_hetero(reqs, cms, 4)
    blind = evaluate_hetero_assignment(
        reqs, solve_offline(reqs, 2, CM).assignment, cms, 4, solver="blind"
    )
    rr = evaluate_hetero_assignment(reqs, round_robin_assign(reqs, 2), cms, 4, solver="rr")
    assert het.makespan_est < blind.makespan_est
    assert het.makespan_est < rr.makespan_est
    assert len(het.assignment[0]) > len(het.assignment[1])
    assert sorted(rid for part in het.assignment for rid in part) == [r.rid for r in reqs]


def test_solve_hetero_homogeneous_matches_p_cmax_quality():
    reqs = _requests(18)
    cms = [CM, CM, CM]
    het = solve_hetero(reqs, cms, 4)
    blind = evaluate_hetero_assignment(
        reqs, solve_offline(reqs, 3, CM).assignment, cms, 4, solver="blind"
    )
    assert het.makespan_est == pytest.approx(blind.makespan_est, rel=0.05)


def _trace(busy_until: float, span: float, n_clients: int = 2) -> ScheduleTrace:
    t = ScheduleTrace(num_clients=n_clients, policy_name="synthetic")
    t.stages.append(
        StageRecord(
            kind=StageKind.DECODE, t_start=0.0, t_end=busy_until, bin_index=0,
            busy={c: c for c in range(n_clients)}, tokens=1, rounds=1,
        )
    )
    if span > busy_until:
        t.stages.append(
            StageRecord(
                kind=StageKind.DECODE, t_start=span, t_end=span, bin_index=0,
                busy={}, tokens=0,
            )
        )
    return t


def test_fleet_utilization_weights_capacity_by_speed():
    traces = [_trace(10.0, 10.0), _trace(0.0, 10.0)]
    hom = FleetReport(policy_name="p", n_replicas=2, slots_per_replica=2, traces=traces)
    het = FleetReport(
        policy_name="p", n_replicas=2, slots_per_replica=2, traces=traces,
        speed_factors=[1.0, 0.5],
    )
    assert hom.utilization == pytest.approx(0.5)
    assert het.utilization == pytest.approx(1.0 / 1.5)
    assert het.weighted_capacity_slots == pytest.approx(3.0)
    full = [_trace(10.0, 10.0), _trace(10.0, 10.0)]
    assert FleetReport(
        policy_name="p", n_replicas=2, slots_per_replica=2, traces=full,
        speed_factors=[1.0, 0.5],
    ).utilization == pytest.approx(1.0)
    assert FleetReport(
        policy_name="p", n_replicas=2, slots_per_replica=2, traces=traces,
        speed_factors=[1.0, 1.0],
    ).utilization == hom.utilization
