"""Port parity, observability: the reference's observability tests run on
the port (the typed registry, capacity conservation on an engine and a
fleet, one span chain through a forced migration, the Perfetto schema, zero
callbacks for ``observe=None``, obs state through a fleet checkpoint, the
utilization timeline, the audit records), and under a scripted clock one
engine serve and one two-replica fleet serve record an
``Observation.state_dict()`` equal to the reference's, string for string."""
import json
import random

import pytest

from repro.core import ArrivalQueueScheduler as RefArrivalQueue
from repro.core import CostModel as RefCostModel
from repro.core import GlobalQueueScheduler as RefGlobalQueue
from repro.core import LagrangianPolicy as RefLagrangian
from repro.core import Request as RefRequest
from repro.core import build_clients as ref_build_clients
from repro.obs import Observation as RefObservation
from repro.serving.engine import Engine as RefEngine
from repro.serving.engine import EngineConfig as RefEngineConfig
from repro.serving.fleet import Fleet as RefFleet
from repro.serving.fleet import FleetConfig as RefFleetConfig
from repro.serving.overload import SLOAwareOverloadPolicy as RefSLOAware
from repro.serving.profiler import OnlineProfiler as RefProfiler
from repro.serving.sampler import TopPSampler as RefTopP
from repro_torch.core import (
    ArrivalQueueScheduler,
    CostModel,
    GlobalQueueScheduler,
    LagrangianPolicy,
    Request,
    build_clients,
)
from repro_torch.core.gantt import utilization_timeline
from repro_torch.core.types import ScheduleTrace, StageKind, StageRecord
from repro_torch.obs import (
    MetricDeclarationError,
    Observation,
    capacity_attribution,
    check_capacity_conservation,
    lifecycle_table,
    write_trace,
)
from repro_torch.serving import (
    Engine,
    EngineConfig,
    Fleet,
    FleetConfig,
    OnlineProfiler,
    SLOAwareOverloadPolicy,
    TopPSampler,
    greedy,
)
from torch_port_helpers import port_model_and_params, ref_model_and_params, scripted_clock

CAPS = (32, 64, 128)
ENGINE_CFG = dict(
    n_slots=2, max_len=64, prefill_seq_buckets=(32,),
    kv_layout="paged", page_size=16, prefill_chunk=16,
)


@pytest.fixture(scope="module")
def models():
    ref_model, ref_params = ref_model_and_params()
    model, params = port_model_and_params(ref_params)
    return ref_model, ref_params, model, params


def _requests(n=6, n_decode=10, cls=Request):
    return [cls(rid=i, n_prefill=10, n_decode=n_decode) for i in range(n)]


def _engine(model, params, sampler=greedy, **kw):
    return Engine(
        model, params, EngineConfig(**{**ENGINE_CFG, **kw}),
        profiler=OnlineProfiler(initial=CostModel(level_caps=CAPS)), sampler=sampler, device="cpu",
    )


def _serve(eng, reqs):
    clients = build_clients(eng.cfg.n_slots, reqs, None)
    return eng.serve(reqs, clients, GlobalQueueScheduler(reqs), LagrangianPolicy())


def _fleet(model, params, engine_kw=None, **fc_kw):
    fc_kw.setdefault("n_replicas", 2)
    fc_kw.setdefault("assign", "round_robin")
    fc_kw.setdefault("dispatch", "round_robin")
    fc_kw.setdefault("work_stealing", False)
    return Fleet(
        model, params, EngineConfig(**{**ENGINE_CFG, **(engine_kw or {})}),
        FleetConfig(**fc_kw), cost_model=CostModel(level_caps=CAPS), device="cpu",
    )


# --------------------------------------------------------------------------- #
# Typed metrics registry                                                      #
# --------------------------------------------------------------------------- #
def test_registry_duplicate_declaration_is_idempotent():
    obs = Observation()
    a = obs.declare("steal_events", "counter", unit="events", help="steals")
    b = obs.declare("steal_events", "counter", unit="events", help="steals")
    assert a == b
    obs.inc("steal_events", 2)
    assert obs.registry.scalars()["steal_events"] == 2.0


def test_registry_conflicting_redeclaration_raises():
    obs = Observation()
    obs.declare("queue_depth", "gauge", unit="requests")
    with pytest.raises(MetricDeclarationError):
        obs.declare("queue_depth", "counter", unit="requests")
    with pytest.raises(MetricDeclarationError):
        obs.declare("queue_depth", "gauge", unit="tokens")
    with pytest.raises(MetricDeclarationError):
        obs.declare("bogus", "trend")


def test_registry_scalars_exclude_log_side_channel():
    obs = Observation()
    obs.declare("lat", "histogram", unit="s")
    obs.observe_value("lat", 0.25)
    obs.observe_value("lat", 0.75)
    obs.set_log("fault_log", [{"replica": 1, "kind": "hang"}])
    obs.log("fault_log", {"replica": 0, "kind": "slow"})
    scalars = obs.registry.scalars()
    assert scalars["lat_count"] == 2.0 and scalars["lat_sum"] == 1.0
    assert all(isinstance(v, float) for v in scalars.values())
    assert obs.registry.logs["fault_log"] == [
        {"replica": 1, "kind": "hang"}, {"replica": 0, "kind": "slow"},
    ]


# --------------------------------------------------------------------------- #
# Capacity attribution: rows sum exactly to makespan x slots                  #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_capacity_conservation_on_engine_serve(models, layout):
    _, _, model, params = models
    obs = Observation()
    eng = _engine(model, params, observe=obs, **({} if layout == "paged" else dict(kv_layout="dense")))
    trace = _serve(eng, _requests())
    assert check_capacity_conservation(obs)
    rows = capacity_attribution(obs)
    assert set(rows) == {0}
    assert rows[0]["capacity"] == pytest.approx(trace.makespan * eng.cfg.n_slots, rel=1e-9)
    assert rows[0]["busy"] > 0.0
    table = lifecycle_table(obs)
    for rid in range(6):
        assert f"\n{rid:5d}  " in table or table.startswith(f"{rid:5d}")
    for rid in range(6):
        kinds = [e.kind for e in obs.spans.by_request(rid)]
        assert kinds[0] == "arrival" and kinds.count("first_token") == 1
        assert kinds[-1] == "complete" and kinds.count("complete") == 1


def test_capacity_conservation_on_fleet_serve(models):
    _, _, model, params = models
    obs = Observation()
    fleet = _fleet(model, params, engine_kw=dict(observe=obs))
    fleet.serve(_requests(8), LagrangianPolicy)
    assert check_capacity_conservation(obs)
    rows = capacity_attribution(obs)
    assert set(rows) == {0, 1}
    for row in rows.values():
        assert row["total"] == pytest.approx(row["capacity"], abs=1e-9)


# --------------------------------------------------------------------------- #
# Span parenting across a migration: one request, two replicas, one chain     #
# --------------------------------------------------------------------------- #
def test_span_chain_survives_forced_migration(models):
    _, _, model, params = models
    obs = Observation()
    fleet = _fleet(model, params, engine_kw=dict(observe=obs))
    fleet.begin_serve(_requests(2, n_decode=12), LagrangianPolicy)
    moved_rid = None
    while True:
        eng = fleet.engines[0]
        if moved_rid is None:
            for slot in list(eng.slots.active_slots):
                if eng.slots.emitted[slot] >= 3:
                    moved_rid = eng.slots.request_of[slot].rid
                    assert fleet.migrate_slot(0, slot, 1)
                    break
        if not fleet.step():
            break
    fleet.finish_serve()
    assert moved_rid is not None, "no slot ever reached 3 emitted tokens"
    evs = obs.spans.by_request(moved_rid)
    kinds = [e.kind for e in evs]
    out_ev = next(e for e in evs if e.kind == "migrate_out")
    in_ev = next(e for e in evs if e.kind == "migrate_in")
    assert out_ev.replica == 0 and in_ev.replica == 1
    assert kinds.index("migrate_out") < kinds.index("migrate_in")
    assert in_ev.parent == out_ev.event_id
    assert obs.spans.chain(moved_rid) == evs
    assert evs[-1].kind == "complete"
    for rid in obs.spans.request_ids():
        assert obs.spans.chain(rid) == obs.spans.by_request(rid)


# --------------------------------------------------------------------------- #
# Perfetto exporter: JSON schema                                              #
# --------------------------------------------------------------------------- #
def test_perfetto_trace_schema(models, tmp_path):
    _, _, model, params = models
    obs = Observation()
    eng = _engine(model, params, observe=obs)
    _serve(eng, _requests())
    path = write_trace(obs, str(tmp_path / "nested" / "serve.trace.json"))
    with open(path) as fh:
        doc = json.load(fh)
    events = doc["traceEvents"]
    assert events, "empty trace"
    phases = {e["ph"] for e in events}
    assert phases <= {"X", "i", "M"} and "X" in phases and "M" in phases
    for e in events:
        assert isinstance(e["name"], str) and e["name"]
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
        if e["ph"] == "X":
            assert e["ts"] >= 0.0 and e["dur"] >= 0.0
            assert "rid" in e["args"]
        elif e["ph"] == "i":
            assert e["s"] == "p" and e["ts"] >= 0.0
    threads = {
        (e["pid"], e["tid"]) for e in events
        if e["ph"] == "M" and e["name"] == "thread_name"
    }
    for slot in range(eng.cfg.n_slots):
        assert (0, slot) in threads
    assert doc["otherData"]["metrics"] == obs.registry.scalars()
    assert doc["otherData"]["source"] == "repro_torch.obs"


# --------------------------------------------------------------------------- #
# observe=None executes zero observability callbacks                          #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_observe_none_fires_no_obs_callbacks(models, layout):
    _, _, model, params = models
    kw = {} if layout == "paged" else dict(kv_layout="dense")
    calls = []
    Observation.tripwire = staticmethod(lambda: calls.append(1))
    try:
        _serve(_engine(model, params, **kw), _requests())
        fleet = _fleet(model, params, work_stealing=True, steal_running=True, dispatch="least_load")
        fleet.serve(_requests(8), LagrangianPolicy)
        assert calls == [], f"observe=None serve executed {len(calls)} obs callbacks"
        # positive control: the tripwire does fire on an observed serve
        _serve(_engine(model, params, observe=Observation(), **kw), _requests())
        assert len(calls) > 0
    finally:
        Observation.tripwire = None


# --------------------------------------------------------------------------- #
# Obs state rides the fleet checkpoint                                        #
# --------------------------------------------------------------------------- #
def test_fleet_checkpoint_roundtrips_obs_state(models):
    _, _, model, params = models
    obs = Observation()
    fleet = _fleet(model, params, engine_kw=dict(observe=obs))
    fleet.begin_serve(_requests(6), LagrangianPolicy)
    for _ in range(6):
        if not fleet.step():
            break
    state = fleet.state_dict()
    assert isinstance(state["obs"], str)

    obs2 = Observation()
    fleet2 = _fleet(model, params, engine_kw=dict(observe=obs2))
    fleet2.load_state_dict(state, {r.rid: r for r in _requests(6)})
    assert [e.kind for e in obs2.spans.events] == [e.kind for e in obs.spans.events]
    assert len(obs2.audit.records) == len(obs.audit.records)
    assert obs2.registry.scalars() == obs.registry.scalars()
    assert obs2.capacity_samples == obs.capacity_samples
    if fleet2.monitor is not None:
        assert fleet2.monitor.obs is obs2
    while fleet2.step():
        pass
    report = fleet2.finish_serve()
    fleet_lists = {"speed_factors", "replica_makespans_s", "replica_requests", "replica_summaries"}
    for key, val in report.summary().items():
        if key in fleet_lists:
            assert isinstance(val, list)
            continue
        assert isinstance(val, (int, float, str)), f"{key} is {type(val)}"
        if isinstance(val, str):
            assert not val.lstrip().startswith(("[", "{")), f"{key}: {val[:60]!r}"
    assert check_capacity_conservation(obs2)


# --------------------------------------------------------------------------- #
# Gantt utilization_timeline: bucket sums reconcile with total busy time      #
# --------------------------------------------------------------------------- #
def _random_trace(rng, n_stages, n_clients):
    t = 0.0
    stages = []
    for i in range(n_stages):
        dur = rng.choice([rng.uniform(1e-4, 0.5), rng.uniform(1e-9, 1e-6)])
        n_busy = rng.randint(0, n_clients)
        stages.append(StageRecord(
            kind=StageKind.DECODE, t_start=t, t_end=t + dur, bin_index=i,
            busy={c: c for c in range(n_busy)},
        ))
        t += dur
        if rng.random() < 0.3:
            t += rng.uniform(0.0, 0.2)
            stages.append(StageRecord(kind=StageKind.DECODE, t_start=t, t_end=t, bin_index=i, busy={}))
    return ScheduleTrace(num_clients=n_clients, stages=stages)


@pytest.mark.parametrize("seed", range(8))
def test_utilization_timeline_buckets_conserve_busy_time(seed):
    rng = random.Random(seed)
    trace = _random_trace(rng, n_stages=rng.randint(1, 30), n_clients=rng.randint(1, 6))
    for buckets in (1, 7, 50):
        tl = utilization_timeline(trace, buckets)
        assert len(tl) == buckets
        span = trace.makespan
        if span <= 0:
            continue
        denom = span / buckets * trace.num_clients
        total_busy = sum(s.duration * (len(s.busy) + len(s.busy_partial)) for s in trace.stages)
        tol = 5e-5 * buckets * denom + 1e-9
        assert sum(tl) * denom == pytest.approx(total_busy, abs=tol)


def test_utilization_timeline_edge_aligned_stages():
    stages = [
        StageRecord(kind=StageKind.DECODE, t_start=i * 0.1, t_end=(i + 1) * 0.1, bin_index=i,
                    busy={0: 0, 1: 1})
        for i in range(10)
    ]
    assert utilization_timeline(ScheduleTrace(num_clients=2, stages=stages), 10) == [1.0] * 10


# --------------------------------------------------------------------------- #
# Decision audit log                                                          #
# --------------------------------------------------------------------------- #
def test_audit_log_records_dispatch_and_prefill_share(models):
    _, _, model, params = models
    obs = Observation()
    fleet = _fleet(model, params, engine_kw=dict(observe=obs), dispatch="least_load")
    reqs = [Request(rid=i, n_prefill=10, n_decode=8, arrival=0.0 if i < 4 else 0.01 * i)
            for i in range(8)]
    fleet.serve(reqs, LagrangianPolicy)
    counts = obs.audit.counts()
    assert counts.get("dispatch", 0) == sum(1 for r in reqs if r.arrival > 0.0)
    for rec in obs.audit.of_kind("dispatch"):
        assert rec.inputs["policy"] == "least_load"
        assert set(rec.inputs["loads_s"]) == {"0", "1"}
        assert rec.chosen in (0, 1)
    assert counts.get("prefill_share", 0) > 0


# --------------------------------------------------------------------------- #
# Cross-framework: the same Observation state as the reference's              #
# --------------------------------------------------------------------------- #
def test_engine_observation_equals_the_reference(models):
    """A paged, mixed top-p serve under the scripted clock: the same spans,
    capacity samples, audit records and metrics as the reference's."""
    ref_model, ref_params, model, params = models
    with scripted_clock():
        ref_obs = RefObservation()
        ref_reqs = _requests(6, cls=RefRequest)
        ref = RefEngine(
            ref_model, ref_params, RefEngineConfig(**ENGINE_CFG, observe=ref_obs),
            profiler=RefProfiler(initial=RefCostModel(level_caps=CAPS)), sampler=RefTopP(top_p=0.9),
        )
        ref.serve(ref_reqs, ref_build_clients(2, ref_reqs, None), RefGlobalQueue(ref_reqs), RefLagrangian())
        obs = Observation()
        eng = _engine(model, params, sampler=TopPSampler(top_p=0.9), observe=obs)
        _serve(eng, _requests(6))
    assert eng.generated == ref.generated
    assert obs.audit.counts().get("prefill_share", 0) > 0
    assert obs.state_dict() == ref_obs.state_dict()


def test_fleet_observation_equals_the_reference(models):
    """Two replicas under the offline LPT partition with least-load dispatch
    and running steals, pinned profilers, the scripted clock: the same
    Observation state as the reference's fleet."""
    ref_model, ref_params, model, params = models
    reqs = lambda cls: [cls(rid=i, n_prefill=8 + 2 * (i % 3), n_decode=4 + 6 * (i % 2),  # noqa: E731
                            arrival=0.0 if i < 6 else 0.002 * i) for i in range(9)]
    fc = dict(n_replicas=2, assign="lpt", dispatch="least_load", work_stealing=True, steal_running=True)
    with scripted_clock():
        ref_obs = RefObservation()
        ref_cm = RefCostModel(level_caps=CAPS)
        ref_fleet = RefFleet(
            ref_model, ref_params, RefEngineConfig(**ENGINE_CFG, observe=ref_obs), RefFleetConfig(**fc),
            cost_model=ref_cm, profiler_factory=lambda: RefProfiler(initial=ref_cm, refit_every=10**9),
        )
        ref_fleet.serve(reqs(RefRequest), RefLagrangian)
        obs = Observation()
        cm = CostModel(level_caps=CAPS)
        fleet = Fleet(
            model, params, EngineConfig(**ENGINE_CFG, observe=obs), FleetConfig(**fc), cost_model=cm,
            profiler_factory=lambda: OnlineProfiler(initial=cm, refit_every=10**9), device="cpu",
        )
        fleet.serve(reqs(Request), LagrangianPolicy)
    assert fleet.generated == ref_fleet.generated
    assert obs.audit.counts().get("dispatch", 0) > 0
    assert obs.state_dict() == ref_obs.state_dict()


def test_overload_defer_is_audited_as_the_reference(models):
    """The SLO-aware admission policy reads the engine's sink: deferring
    the offline head for a waiting online request records the reference's
    ``overload_defer`` audit (the same state, under the scripted clock)."""
    ref_model, ref_params, model, params = models

    def requests(cls):
        reqs = [cls(rid=i, n_prefill=12, n_decode=8) for i in range(4)]
        return reqs + [cls(rid=100, n_prefill=12, n_decode=8, arrival=1e-7, ttft_slo_s=10.0)]

    with scripted_clock():
        ref_obs = RefObservation()
        ref_reqs = requests(RefRequest)
        ref = RefEngine(
            ref_model, ref_params, RefEngineConfig(**ENGINE_CFG, observe=ref_obs),
            profiler=RefProfiler(initial=RefCostModel(level_caps=CAPS)), overload_policy=RefSLOAware(),
        )
        ref.serve(ref_reqs, ref_build_clients(2, ref_reqs, None), RefArrivalQueue(ref_reqs), RefLagrangian())
        obs = Observation()
        reqs = requests(Request)
        eng = _engine(model, params, observe=obs)
        eng.overload = SLOAwareOverloadPolicy()
        eng.serve(reqs, build_clients(2, reqs, None), ArrivalQueueScheduler(reqs), LagrangianPolicy())
    assert eng.overload.deferrals > 0
    defers = obs.audit.of_kind("overload_defer")
    assert defers and all(rec.chosen == "defer_offline" for rec in defers)
    assert obs.state_dict() == ref_obs.state_dict()
