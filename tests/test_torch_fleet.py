"""Port parity, the fleet: N port ``Engine``s over one set of weights under
the offline partition, online dispatch, work stealing (queued and running),
fault recovery, health monitoring and epoch fencing. Both engines read a
scripted clock, so the virtual-time interleave and every decision that
reads stage durations are the same on both sides. The reference fleets run
in one module fixture (the same offline assignment, streams, steals,
migrations, faults and report fields, exactly); the rest holds the port's
fleet to the reference's own fleet tests, the wall-clock ones among them
with the clock scripted."""
import copy

import pytest
import torch

from repro.core import CostModel as RefCostModel
from repro.core import LagrangianPolicy as RefLagrangian
from repro.core import Request as RefRequest
from repro.serving.engine import EngineConfig as RefEngineConfig
from repro.serving.fleet import FaultPlan as RefFaultPlan
from repro.serving.fleet import Fleet as RefFleet
from repro.serving.fleet import FleetConfig as RefFleetConfig
from repro.serving.fleet import ReplicaFault as RefReplicaFault
from repro.serving.fleet import ReplicaSpec as RefReplicaSpec
from repro.serving.profiler import OnlineProfiler as RefProfiler
from repro_torch.core import (
    CostModel,
    GlobalQueueScheduler,
    LagrangianPolicy,
    Request,
    build_clients,
)
from repro_torch.serving import (
    ALIVE,
    CONDEMNED,
    SUSPECT,
    Engine,
    EngineConfig,
    FaultPlan,
    Fleet,
    FleetConfig,
    HealthConfig,
    OnlineProfiler,
    ReplicaFault,
    ReplicaSpec,
)
from repro_torch.serving.fleet import HEALTH_SUSPECT_PENALTY
from torch_port_helpers import port_model_and_params, ref_model_and_params, scripted_clock

CAPS = (32, 64, 128)
ENGINE_CFG = dict(
    n_slots=2, max_len=64, prefill_seq_buckets=(32,), kv_layout="paged",
    page_size=16, prefill_chunk=16,
)
STEPWISE = dict(decode_horizon=1, mixed_schedule=False)
SPECS = (1.0, 0.25)


def _skewed_requests(cls=Request):
    """Long decodes at even rids: round robin piles them onto replica 0."""
    return [
        cls(rid=rid, n_prefill=10, n_decode=24) if rid % 2 == 0
        else cls(rid=rid, n_prefill=8, n_decode=4)
        for rid in range(8)
    ]


def _kill_requests(cls=Request):
    return [cls(rid=i, n_prefill=10 + 2 * (i % 3), n_decode=(20 if i % 2 == 0 else 3) + i)
            for i in range(6)]


def _straggler_requests(cls=Request):
    # odd rids (the slow replica under round robin) are decode-heavy
    return [
        cls(rid=rid, n_prefill=10, n_decode=32) if rid % 2 == 1
        else cls(rid=rid, n_prefill=8, n_decode=4)
        for rid in range(6)
    ]


def _running_requests(cls=Request):
    # one long request running on the slow replica, nothing queued
    return [cls(rid=0, n_prefill=8, n_decode=4), cls(rid=1, n_prefill=10, n_decode=32),
            cls(rid=2, n_prefill=8, n_decode=4)]


# (fleet config, engine config, speed factors or None, requests, fault plan at_s or None)
CASES = {
    "lpt+steal": (dict(assign="lpt", dispatch="least_load", work_stealing=True, steal_running=True),
                  {}, None, _skewed_requests, None),
    "kill": (dict(assign="round_robin", dispatch="round_robin", work_stealing=False),
             {}, None, _kill_requests, 6 * 2.0 ** -10),
    "2-speed": (dict(assign="round_robin", dispatch="round_robin", work_stealing=True),
                STEPWISE, SPECS, _straggler_requests, None),
    "2-speed-lpt": (dict(assign="lpt", work_stealing=True, steal_running=True),
                    {}, SPECS, _kill_requests, None),
    "running-steal": (dict(assign="round_robin", dispatch="round_robin", work_stealing=True,
                           steal_running=True), STEPWISE, SPECS, _running_requests, None),
}


@pytest.fixture(scope="module")
def models():
    ref_model, ref_params = ref_model_and_params()
    model, params = port_model_and_params(ref_params)
    return ref_model, ref_params, model, params


def _fleet(model, params, engine_kw=None, specs=None, **fc_kw):
    fc_kw.setdefault("n_replicas", len(specs) if specs else 2)
    cm = CostModel(level_caps=CAPS)
    pinned = None if specs else (lambda: OnlineProfiler(initial=cm, refit_every=10**9))
    return Fleet(
        model, params, EngineConfig(**{**ENGINE_CFG, **(engine_kw or {})}), FleetConfig(**fc_kw),
        cost_model=cm, profiler_factory=pinned, device="cpu",
        replica_specs=[ReplicaSpec(speed_factor=s) for s in specs] if specs else None,
    )


def _summary(fleet, report):
    return dict(
        assignment=fleet._offline_result.assignment, generated=fleet.generated,
        steals=fleet.steal_log, migrations=fleet.migration_log, faults=fleet.fault_log,
        solver=report.offline_solver, makespan=report.makespan, lower_bound=report.lower_bound_s,
        lb_ratio=report.lb_ratio, utilization=report.utilization, steal_events=report.steal_events,
        meta=report.meta, stages=[[(s.kind.name, s.tokens, s.rounds) for s in t.stages] for t in report.traces],
    )


def _serve_case(name, model, params, ref):
    fc_kw, engine_kw, specs, requests, kill_at = CASES[name]
    if ref:
        cm = RefCostModel(level_caps=CAPS)
        fleet = RefFleet(
            model, params, RefEngineConfig(**{**ENGINE_CFG, **engine_kw}),
            RefFleetConfig(n_replicas=2, **fc_kw), cost_model=cm,
            profiler_factory=None if specs else (lambda: RefProfiler(initial=cm, refit_every=10**9)),
            replica_specs=[RefReplicaSpec(speed_factor=s) for s in specs] if specs else None,
        )
        plan = RefFaultPlan([RefReplicaFault(replica=0, at_s=kill_at)]) if kill_at else None
        reqs, policy = requests(RefRequest), RefLagrangian
    else:
        fleet = _fleet(model, params, engine_kw, specs, **fc_kw)
        plan = FaultPlan([ReplicaFault(replica=0, at_s=kill_at)]) if kill_at else None
        reqs, policy = requests(), LagrangianPolicy
    with scripted_clock():
        report = fleet.serve(reqs, policy, fault_plan=plan)
    return _summary(fleet, report)


@pytest.fixture(scope="module")
def reference(models):
    ref_model, ref_params, _, _ = models
    return {name: _serve_case(name, ref_model, ref_params, ref=True) for name in CASES}


@pytest.mark.parametrize("name", sorted(CASES))
def test_fleet_matches_the_reference(models, reference, name):
    _, _, model, params = models
    got = _serve_case(name, model, params, ref=False)
    ref = reference[name]
    for key in ref:
        assert got[key] == ref[key], key


def test_the_reference_cases_exercise_the_fleet(reference):
    assert reference["lpt+steal"]["solver"] == "lpt+local_search"
    assert any(e.get("running") for e in reference["running-steal"]["steals"])
    assert reference["running-steal"]["migrations"]
    assert reference["kill"]["faults"][0]["recompute"] >= 1
    assert reference["kill"]["meta"]["recomputed_tokens"] > 0
    assert reference["2-speed"]["steal_events"] >= 1
    assert reference["2-speed-lpt"]["solver"] == "hetero-lpt+local_search"


def test_fleet_entry_point_raises_without_cuda(models, monkeypatch):
    _, _, model, params = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Fleet(model, params, EngineConfig(**ENGINE_CFG), FleetConfig())
    with pytest.raises(ValueError, match="model lives on"):
        Fleet(model, params, EngineConfig(**ENGINE_CFG), FleetConfig(), device="meta")


# --------------------------------------------------------------------------- #
# The reference's fleet cases, against the port                               #
# --------------------------------------------------------------------------- #
def _bare_engine_streams(model, params, reqs, longest_first=False):
    eng = Engine(model, params, EngineConfig(**ENGINE_CFG), device="cpu",
                 profiler=OnlineProfiler(initial=CostModel(level_caps=CAPS), refit_every=10**9))
    clients = build_clients(2, reqs, None)
    with scripted_clock():
        trace = eng.serve(reqs, clients, GlobalQueueScheduler(reqs, sort_longest_first=longest_first),
                          LagrangianPolicy())
    return eng.generated, trace


def test_lpt_beats_round_robin_on_skewed_workload(models):
    _, _, model, params = models
    results = {}
    for kind, kw in (("rr", dict(assign="round_robin", dispatch="round_robin", work_stealing=False)),
                     ("lpt", dict(assign="lpt", dispatch="least_load"))):
        fleet = _fleet(model, params, engine_kw=STEPWISE, **kw)
        with scripted_clock():
            report = fleet.serve(_skewed_requests(), LagrangianPolicy)
        results[kind] = (report, fleet.generated, fleet)
    rr, lpt = results["rr"][0], results["lpt"][0]

    def straggler_rounds(report):
        return max(sum(s.rounds for s in t.stages) for t in report.traces)

    assert straggler_rounds(lpt) < straggler_rounds(rr)
    assert lpt.makespan < rr.makespan          # scripted: each stage one step
    assert lpt.utilization > rr.utilization
    count_long = lambda parts: sorted(sum(1 for rid in p if rid % 2 == 0) for p in parts)
    assert count_long(results["lpt"][2]._offline_result.assignment) == [2, 2]
    assert count_long(results["rr"][2]._offline_result.assignment) == [0, 4]
    assert results["rr"][1] == results["lpt"][1]


def test_fleet_report_validates_lower_bound_fields(models):
    _, _, model, params = models
    fleet = _fleet(model, params, assign="lpt")
    with scripted_clock():
        report = fleet.serve(_skewed_requests(), LagrangianPolicy)
    report.validate()
    assert report.total_slots == 4 and report.lower_bound_s > 0
    assert report.lb_ratio == pytest.approx(report.makespan / report.lower_bound_s)
    assert 0 < report.utilization <= 1
    s = report.summary()
    assert s["n_replicas"] == 2 and len(s["replica_summaries"]) == 2 and s["num_requests"] == 8


def test_work_steal_produces_identical_tokens_counted_once(models):
    _, _, model, params = models
    reqs = [Request(rid=i, n_prefill=10 if i % 2 == 0 else 8, n_decode=32 if i % 2 == 0 else 4)
            for i in range(6)]
    fleet = _fleet(model, params, assign="round_robin", dispatch="round_robin", work_stealing=True)
    with scripted_clock():
        report = fleet.serve([copy.copy(r) for r in reqs], LagrangianPolicy)
    assert fleet.steal_events >= 1
    report.validate()
    gen = fleet.generated
    assert sorted(gen) == list(range(6))
    assert _bare_engine_streams(model, params, [copy.copy(r) for r in reqs])[0] == gen
    for e in fleet.steal_log:
        assert e["rid"] in {r.rid for r in report.traces[e["to"]].requests}


def test_no_stealing_when_disabled(models):
    _, _, model, params = models
    fleet = _fleet(model, params, assign="round_robin", dispatch="round_robin", work_stealing=False)
    with scripted_clock():
        report = fleet.serve(_skewed_requests(), LagrangianPolicy)
    assert fleet.steal_events == 0
    assert [sorted(r.rid for r in t.requests) for t in report.traces] == [[0, 2, 4, 6], [1, 3, 5, 7]]


def test_single_replica_fleet_matches_bare_engine(models):
    _, _, model, params = models

    def requests():
        return [Request(rid=i, n_prefill=8 + 3 * (i % 3), n_decode=5 + 2 * (i % 4)) for i in range(6)]

    fleet = _fleet(model, params, n_replicas=1, assign="lpt")
    with scripted_clock():
        report = fleet.serve(requests(), LagrangianPolicy)
    report.validate()
    gen, trace = _bare_engine_streams(model, params, requests(), longest_first=True)
    trace.validate()
    assert fleet.generated == gen
    assert [s.kind for s in report.traces[0].stages] == [s.kind for s in trace.stages]


def test_fleet_checkpoint_restore_mid_serve(models):
    _, _, model, params = models

    def requests():
        return [Request(rid=i, n_prefill=10 + 2 * (i % 3), n_decode=8 + 4 * (i % 4)) for i in range(6)]

    fleet = _fleet(model, params, assign="lpt")
    with scripted_clock():
        fleet.begin_serve(requests(), LagrangianPolicy)
        for _ in range(8):
            fleet.step()
        assert any(e.slots.active_slots or e._chunking for e in fleet.engines)
        state = fleet.state_dict()
        pre = {rid: list(t) for rid, t in fleet.generated.items()}
        while fleet.step():
            pass
        fleet.finish_serve().validate()
        final = fleet.generated
        fleet2 = _fleet(model, params, assign="lpt")
        fleet2.load_state_dict(state, {r.rid: r for r in requests()})
        for eng_state, eng2 in zip(state["engines"], fleet2.engines):
            for key, t in eng_state["cache"].items():
                assert torch.equal(t, eng2.slots.cache[key])
        while fleet2.step():
            pass
        report2 = fleet2.finish_serve()
    post = fleet2.generated
    for rid, toks in final.items():
        assert pre.get(rid, []) + post.get(rid, []) == toks, f"rid {rid}"
    seen = [r.rid for t in report2.traces for r in t.requests]
    assert len(seen) == len(set(seen))


def test_round_robin_dispatch_cursor_resets_per_serve(models):
    _, _, model, params = models
    fleet = _fleet(model, params, assign="round_robin", dispatch="round_robin")
    reqs = lambda: [Request(rid=i, n_prefill=8, n_decode=4, arrival=0.001 * (i + 1)) for i in range(3)]
    fleet.begin_serve(reqs(), LagrangianPolicy)
    assert [fleet.dispatcher.choose(fleet, r) for r in reqs()] == [0, 1, 0]
    fleet.begin_serve(reqs(), LagrangianPolicy)
    assert fleet.dispatcher.cursor == 0


def test_least_load_dispatch_prefers_drained_replica(models):
    _, _, model, params = models
    fleet = _fleet(model, params, assign="lpt", dispatch="least_load")
    fleet.begin_serve([Request(rid=i, n_prefill=8, n_decode=20) for i in range(4)], LagrangianPolicy)
    loads = [fleet.estimated_load_s(i) for i in range(2)]
    assert loads[0] == pytest.approx(loads[1])
    while fleet.engines[1]._sv.scheduler.queued:
        fleet.engines[1]._sv.scheduler.steal_longest()
    late = Request(rid=99, n_prefill=8, n_decode=20, arrival=0.001)
    assert fleet.dispatcher.choose(fleet, late) == 1


def test_online_arrivals_route_and_complete(models):
    _, _, model, params = models
    fleet = _fleet(model, params, assign="lpt", dispatch="least_load")
    reqs = [Request(rid=i, n_prefill=8 + i, n_decode=6 + 2 * i, arrival=0.0 if i < 3 else 0.004 * i)
            for i in range(8)]
    with scripted_clock():
        report = fleet.serve(reqs, LagrangianPolicy)
    report.validate()
    assert sorted(r.rid for t in report.traces for r in t.requests) == list(range(8))
    assert sorted(fleet._leases) == list(range(8))


# --------------------------------------------------------------------------- #
# Heterogeneous fleets                                                        #
# --------------------------------------------------------------------------- #
def test_hetero_fleet_partitions_by_speed_and_validates(models):
    _, _, model, params = models
    fleet = _fleet(model, params, engine_kw=STEPWISE, specs=SPECS, assign="lpt", work_stealing=False)
    assert fleet.heterogeneous
    with scripted_clock():
        report = fleet.serve([Request(rid=i, n_prefill=10, n_decode=12) for i in range(12)],
                             LagrangianPolicy)
    report.validate()
    assert report.offline_solver == "hetero-lpt+local_search"
    assert report.speed_factors == [1.0, 0.25]
    n_fast, n_slow = len(report.traces[0].requests), len(report.traces[1].requests)
    assert n_fast > n_slow > 0 and n_fast + n_slow == 12


def test_steal_gate_prices_through_destination_models(models):
    _, _, model, params = models
    fleet = _fleet(model, params, specs=(1.0, 0.1), assign="round_robin", dispatch="round_robin")
    fleet.begin_serve([Request(rid=i, n_prefill=10, n_decode=16) for i in range(4)], LagrangianPolicy)
    assert fleet._steal_improves(0, 1, fleet.engines[1]._sv.scheduler.peek_longest())
    assert not fleet._steal_improves(1, 0, fleet.engines[0]._sv.scheduler.peek_longest())


def test_pricing_gate_holds_priors_until_all_replicas_fit(models):
    _, _, model, params = models
    fleet = _fleet(model, params, specs=(1.0, 0.5), assign="lpt")
    priors = [s.resolve_cost_model(fleet.cost_model) for s in fleet.specs]
    assert fleet.pricing_cost_models() == priors
    for i, eng in enumerate(fleet.engines):
        p = eng.profiler
        p.refit_every = 4
        p.record_prefill(32, 1e-4 * (i + 1))
        p.record_prefill(64, 2e-4 * (i + 1))
        p.record_decode(1, 1e-4 * (i + 1))
        p.record_decode(2, 1.5e-4 * (i + 1))
        assert p.fits >= 1
        if i == 0:
            assert fleet.pricing_cost_models() == priors
    live = fleet.pricing_cost_models()
    assert all(live[i] is e.profiler.cost_model for i, e in enumerate(fleet.engines))


def test_fast_replica_steals_from_slow_and_reduces_makespan(models):
    """The reference's wall-clock case with the clock scripted: the fast
    replica drains, steals from the slow one, and the makespan strictly
    improves over the no-steal ablation with identical streams."""
    _, _, model, params = models
    reports = {}
    for stealing in (True, False):
        fleet = _fleet(model, params, engine_kw=STEPWISE, specs=SPECS, assign="round_robin",
                       dispatch="round_robin", work_stealing=stealing)
        fleet.warm_serving_shapes()
        with scripted_clock():
            report = fleet.serve(_straggler_requests(), LagrangianPolicy)
        report.validate()
        reports[stealing] = (report, fleet.generated, fleet)
    steal_report, steal_gen, steal_fleet = reports[True]
    nosteal_report, nosteal_gen, _ = reports[False]
    assert steal_fleet.steal_events >= 1
    assert all((e["from"], e["to"]) == (1, 0) for e in steal_fleet.steal_log)
    assert steal_report.makespan < nosteal_report.makespan
    assert steal_gen == nosteal_gen
    eng = Engine(model, params, EngineConfig(**ENGINE_CFG), device="cpu")
    eng.profiler.cost_model = CostModel(level_caps=CAPS)
    ref = _straggler_requests()
    clients = build_clients(2, ref, None)
    with scripted_clock():
        eng.serve(ref, clients, GlobalQueueScheduler(ref), LagrangianPolicy())
    assert eng.generated == steal_gen


# --------------------------------------------------------------------------- #
# Health monitoring and epoch fencing                                         #
# --------------------------------------------------------------------------- #
def _health_requests():
    return [
        Request(rid=0, n_prefill=10, n_decode=16),
        Request(rid=1, n_prefill=8, n_decode=16),
        Request(rid=2, n_prefill=12, n_decode=12),
        Request(rid=3, n_prefill=8, n_decode=12),
    ]


def _health_fleet(model, params, health=True):
    cfg = health if isinstance(health, HealthConfig) else (HealthConfig() if health else None)
    return Fleet(
        model, params, EngineConfig(**ENGINE_CFG, **STEPWISE),
        FleetConfig(n_replicas=2, assign="round_robin", dispatch="round_robin",
                    work_stealing=False, health=cfg),
        cost_model=CostModel(level_caps=CAPS), device="cpu",
    )


def _assert_no_leaks(fleet):
    for eng in fleet.engines:
        assert eng.slots.allocator.num_used == 0, "orphaned pages"
        eng.slots.allocator.check_consistency()
        eng.slots.check_block_table_mirror()


def _serve_fitted_reference(fleet):
    """Calibrate until every replica has a full cost-model fit (profilers
    refit from the scripted stage durations), then serve for the reference
    streams."""
    fleet.serve([Request(rid=90 + i, n_prefill=4, n_decode=8) for i in range(4)], LagrangianPolicy)
    fleet.serve(_health_requests(), LagrangianPolicy)
    assert all(e.profiler.full_fits > 0 for e in fleet.engines)
    rep = fleet.serve(_health_requests(), LagrangianPolicy)
    return rep, {rid: list(t) for rid, t in fleet.generated.items()}


def test_hang_detected_condemned_and_served_exactly_once(models):
    _, _, model, params = models
    fleet = _health_fleet(model, params)
    with scripted_clock():
        rep, ref_gen = _serve_fitted_reference(fleet)
        mk = rep.makespan
        plan = FaultPlan([ReplicaFault(replica=0, at_s=0.3 * mk, kind="hang", until_s=50.0 * mk)])
        rep2 = fleet.serve(_health_requests(), LagrangianPolicy, fault_plan=plan)
    assert fleet.monitor.state(0) == CONDEMNED
    assert rep2.meta["condemned_replicas"] == 1.0
    assert fleet.epochs[0] == 1
    assert rep2.meta["fenced_stale_completions"] > 0
    assert all(e["epoch"] == 0 for e in fleet.fenced_log)
    assert {r: list(t) for r, t in fleet.generated.items()} == ref_gen
    condemned_at = next(tr["at_s"] for tr in fleet.monitor.transitions if tr["state"] == CONDEMNED)
    assert 0.3 * mk < condemned_at < 10.0 * mk
    _assert_no_leaks(fleet)


def test_zombie_wakeup_after_condemnation_is_fenced(models):
    _, _, model, params = models
    fleet = _health_fleet(model, params)
    with scripted_clock():
        rep, ref_gen = _serve_fitted_reference(fleet)
        mk = rep.makespan
        plan = FaultPlan([ReplicaFault(replica=0, at_s=0.3 * mk, kind="hang", until_s=0.9 * mk)])
        rep2 = fleet.serve(_health_requests(), LagrangianPolicy, fault_plan=plan)
    assert rep2.meta["condemned_replicas"] == 1.0
    assert rep2.meta["fenced_stale_completions"] > 0
    kinds = [e["kind"] for e in fleet.injected_log]
    assert kinds.count("hang") == 1 and kinds.count("hang_end") == 1
    assert {r: list(t) for r, t in fleet.generated.items()} == ref_gen
    assert {e["rid"] for e in fleet.fenced_log}
    _assert_no_leaks(fleet)


def test_degrade_x4_flagged_while_progressing(models):
    _, _, model, params = models
    fleet = _health_fleet(model, params)
    with scripted_clock():
        rep, ref_gen = _serve_fitted_reference(fleet)
        mk = rep.makespan
        plan = FaultPlan([ReplicaFault(replica=0, at_s=0.3 * mk, kind="degrade", speed_factor=0.25)])
        rep2 = fleet.serve(_health_requests(), LagrangianPolicy, fault_plan=plan)
    assert rep2.meta["degraded_events"] >= 1.0
    assert fleet.monitor.replicas[0].suspect_reason == "degraded"
    assert fleet.monitor.state(0) == SUSPECT
    assert rep2.meta["condemned_replicas"] == 0.0
    assert {r: list(t) for r, t in fleet.generated.items()} == ref_gen
    assert fleet.monitor.replicas[1].state == ALIVE
    assert rep2.meta["false_suspicions"] == 0.0
    _assert_no_leaks(fleet)


def test_clean_serve_has_no_false_positives(models):
    _, _, model, params = models
    fleet = _health_fleet(model, params)
    with scripted_clock():
        rep, _ = _serve_fitted_reference(fleet)
    for key in ("suspect_events", "false_suspicions", "degraded_events", "condemned_replicas"):
        assert rep.meta[key] == 0.0
    assert "fenced_stale_completions" not in rep.meta


def test_deliver_completion_fences_stale_claims(models):
    _, _, model, params = models
    fleet = _health_fleet(model, params)
    fleet.begin_serve(_health_requests(), LagrangianPolicy)
    holder, epoch = fleet._leases[0]
    assert not fleet.deliver_completion(holder, epoch + 1, 0, [7], 0.0)
    other = 1 - holder
    assert not fleet.deliver_completion(other, fleet.epochs[other], 0, [7], 0.0)
    assert fleet.fenced_completions == 2
    reasons = [e["reason"] for e in fleet.fenced_log]
    assert any("stale epoch" in r for r in reasons) and any("lease mismatch" in r for r in reasons)
    assert fleet.deliver_completion(holder, epoch, 0, [7, 8], 0.0)
    assert fleet.engines[holder].generated[0] == [7, 8]
    fleet._dead.add(holder)
    assert not fleet.deliver_completion(holder, epoch, 0, [9], 0.0)
    assert fleet.fenced_log[-1]["reason"] == "replica dead"


def test_suspect_replica_priced_out_of_dispatch(models):
    _, _, model, params = models
    fleet = _health_fleet(model, params)
    assert fleet.health_penalties() == [1.0, 1.0]
    fleet.monitor._suspect(0, 0.0, "silence")
    assert fleet.dispatchable_replicas == [1]
    assert fleet.health_penalties() == [HEALTH_SUSPECT_PENALTY, 1.0]
    fleet.monitor._suspect(1, 0.0, "silence")
    assert fleet.dispatchable_replicas == [0, 1]
    bare = _health_fleet(model, params, health=False)
    assert bare.health_penalties() is None and bare.dispatchable_replicas == [0, 1]


def test_redispatch_waits_backoff_unless_deadline_pressed(models):
    _, _, model, params = models
    fleet = _health_fleet(model, params, health=HealthConfig(redispatch_backoff_s=0.05))
    reqs = _health_requests()
    reqs[0].ttft_slo_s = 0.01
    fleet.begin_serve(reqs, LagrangianPolicy)
    q0 = fleet.engines[0]._sv.scheduler
    n0 = len(q0.queued)
    assert n0 > 0
    fleet.monitor._suspect(0, 0.0, "silence")
    fleet._redispatch_suspect_queues(0.0)
    assert len(q0.queued) == n0 - 1 and fleet.redispatch_events == 1
    assert fleet.redispatch_log[0] == {"rid": 0, "from": 0, "to": 1, "at_s": 0.0, "deadline": True}
    assert fleet._leases[0] == (1, 0) and reqs[0].redispatches == 1
    fleet._redispatch_suspect_queues(0.06)
    assert len(q0.queued) == 0
    assert all(e["to"] == 1 and fleet._leases[e["rid"]] == (1, 0) for e in fleet.redispatch_log)


def test_stale_epoch_export_refused(models):
    _, _, model, params = models
    fleet = _health_fleet(model, params)
    with scripted_clock():
        fleet.begin_serve(_health_requests(), LagrangianPolicy)
        while not fleet.engines[0].slots.active_slots:
            fleet.step()
        slot = fleet.engines[0].slots.active_slots[0]
        assert fleet.migrate_slot(0, slot, 1, src_epoch=fleet.epochs[0] - 1) is False
        assert fleet.fenced_exports == 1 and fleet.fenced_log[-1]["kind"] == "export"
        assert fleet.engines[0].slots.request_of[slot] is not None
        while fleet.step():
            pass
        fleet.finish_serve()
    _assert_no_leaks(fleet)


def test_fleet_checkpoint_round_trips_health_and_epochs(models):
    _, _, model, params = models
    fleet = _health_fleet(model, params)
    with scripted_clock():
        fleet.begin_serve(_health_requests(), LagrangianPolicy)
        for _ in range(4):
            fleet.step()
        now = max(e.clock for e in fleet.engines)
        fleet.monitor._suspect(0, now, "silence")
        assert not fleet.deliver_completion(1, 99, 1, [5], now)
        state = fleet.state_dict()
        pre = {rid: list(t) for rid, t in fleet.generated.items()}
        fleet2 = _health_fleet(model, params)
        fleet2.load_state_dict(state, {r.rid: r for r in _health_requests()})
        assert fleet2.monitor.state(0) == SUSPECT
        assert fleet2.monitor.replicas[0].suspect_since == pytest.approx(now)
        assert fleet2.epochs == fleet.epochs and fleet2.fenced_completions == 1
        assert fleet2.fenced_log == fleet.fenced_log and fleet2._leases == fleet._leases
        while fleet2.step():
            pass
        fleet2.finish_serve()
    post = fleet2.generated
    assert {rid for rid in range(4) if pre.get(rid) or post.get(rid)} == {0, 1, 2, 3}
    _assert_no_leaks(fleet2)
    with pytest.raises(ValueError):
        _health_fleet(model, params, health=False).load_state_dict(
            state, {r.rid: r for r in _health_requests()})
