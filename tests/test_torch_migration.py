"""Port parity, live KV migration by page-copy: the payload checksum equals
the reference's, a slot exports and imports with its bytes intact, a flipped
bit is refused with the pool untouched, a request migrated at every decode
step (and between prefill chunks) continues the reference's stream, a drain
drops and recomputes nothing, and the invariant checks catch a tampered
block table. The cost model is pinned and both engines read a scripted
clock, so no schedule depends on the wall clock. The reference fleet runs
in one module fixture; the other cases hold the port against its streams."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CostModel as RefCostModel
from repro.core import LagrangianPolicy as RefLagrangian
from repro.core import Request as RefRequest
from repro.serving.engine import EngineConfig as RefEngineConfig
from repro.serving.fleet import Fleet as RefFleet
from repro.serving.fleet import FleetConfig as RefFleetConfig
from repro.serving.kv_slots import page_checksum as ref_page_checksum
from repro.serving.profiler import OnlineProfiler as RefProfiler
from repro_torch.core import CostModel, GlobalQueueScheduler, LagrangianPolicy, Request, build_clients
from repro_torch.models.transformer import TransformerLM
from repro_torch.serving import (
    Engine,
    EngineConfig,
    FaultPlan,
    Fleet,
    FleetConfig,
    OnlineProfiler,
    PageIntegrityError,
    PagedSlotManager,
    ReplicaFault,
    ReplicaSpec,
    page_checksum,
)
from torch_port_helpers import CFG, port_model_and_params, ref_model_and_params, scripted_clock

CAPS = (32, 64, 128)
ENGINE_CFG = dict(
    n_slots=2, max_len=64, prefill_seq_buckets=(32,), kv_layout="paged",
    page_size=16, prefill_chunk=16, decode_horizon=1, mixed_schedule=False,
)
FLEET_CFG = dict(n_replicas=2, assign="round_robin", dispatch="round_robin", work_stealing=False)


def _bound_requests(cls=Request):
    return [cls(rid=0, n_prefill=10, n_decode=6), cls(rid=1, n_prefill=8, n_decode=3)]


def _chunk_requests(cls=Request):
    # a 40-token prompt at prefill_chunk=16: three chunks on replica 0
    return [cls(rid=0, n_prefill=40, n_decode=5), cls(rid=1, n_prefill=8, n_decode=3)]


def _drain_requests(cls=Request):
    # even rids (replica 0) decode-heavy; odd rids (replica 1) finish fast
    return [
        cls(rid=rid, n_prefill=10, n_decode=20) if rid % 2 == 0
        else cls(rid=rid, n_prefill=8, n_decode=2)
        for rid in range(6)
    ]


@pytest.fixture(scope="module")
def models():
    ref_model, ref_params = ref_model_and_params()
    model, params = port_model_and_params(ref_params)
    return ref_model, ref_params, model, params


def _fleet(model, params, engine_kw=None, specs=None, **fc_kw):
    cm = CostModel(level_caps=CAPS)
    pinned = None if specs else (lambda: OnlineProfiler(initial=cm, refit_every=10**9))
    return Fleet(
        model, params, EngineConfig(**{**ENGINE_CFG, **(engine_kw or {})}),
        FleetConfig(**{**FLEET_CFG, **fc_kw}), cost_model=cm,
        replica_specs=specs, profiler_factory=pinned, device="cpu",
    )


def _assert_no_leaks(fleet):
    for eng in fleet.engines:
        assert eng.slots.allocator.num_used == 0, "orphaned pages"
        eng.slots.allocator.check_consistency()
        eng.slots.check_block_table_mirror()


def _serve_with_bound_migration(fleet, reqs, rid, emitted_at):
    """Migrate ``rid`` off replica 0 the moment its bound slot has emitted
    exactly ``emitted_at`` tokens."""
    fleet.begin_serve(reqs, LagrangianPolicy)
    migrated = False
    while True:
        eng = fleet.engines[0]
        if not migrated:
            for slot in list(eng.slots.active_slots):
                if eng.slots.request_of[slot].rid == rid and eng.slots.emitted[slot] == emitted_at:
                    assert fleet.migrate_slot(0, slot, 1) == "page_copy"
                    migrated = True
                    break
        if not fleet.step():
            break
    return fleet.finish_serve(), migrated


def _step_until_survivor_idle(fleet, min_emitted=1):
    while True:
        e0, e1 = fleet.engines
        ready = [s for s in e0.slots.active_slots if e0.slots.emitted[s] >= min_emitted]
        if ready and not e1.slots.active_slots and not e1._chunking and not e1._sv.scheduler.queued:
            return True
        if not fleet.step():
            return False


@pytest.fixture(scope="module")
def reference(models):
    """The reference fleet's streams for each request set, one migration at
    emitted = 2 and one drain, all under the scripted clock."""
    ref_model, ref_params, _, _ = models
    cm = RefCostModel(level_caps=CAPS)
    fleet = RefFleet(
        ref_model, ref_params, RefEngineConfig(**ENGINE_CFG), RefFleetConfig(**FLEET_CFG),
        cost_model=cm, profiler_factory=lambda: RefProfiler(initial=cm, refit_every=10**9),
    )
    out = {}
    with scripted_clock():
        for name, reqs in (("bound", _bound_requests), ("chunk", _chunk_requests),
                           ("drain", _drain_requests)):
            fleet.serve(reqs(RefRequest), RefLagrangian)
            out[name] = {rid: list(t) for rid, t in fleet.generated.items()}
        report, migrated = _serve_with_bound_migration(fleet, _bound_requests(RefRequest), 0, 2)
        assert migrated
        out["migrated"] = dict(generated=fleet.generated, log=list(fleet.migration_log),
                               makespan=report.makespan)
        fleet.begin_serve(_drain_requests(RefRequest), RefLagrangian)
        assert _step_until_survivor_idle(fleet)
        entry = fleet.drain_replica(0)
        while fleet.step():
            pass
        report = fleet.finish_serve()
        out["drained"] = dict(generated=fleet.generated, entry=entry, meta=report.meta,
                              makespan=report.makespan)
    return out


# --------------------------------------------------------------------------- #
# The payload checksum                                                        #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_page_checksum_matches_the_reference(dtype):
    rng = np.random.default_rng(0)
    k = rng.standard_normal((2, 2, 3, 16, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 3, 16, 16)).astype(np.float32)
    ref = ref_page_checksum(jnp.asarray(k, dtype=dtype), jnp.asarray(v, dtype=dtype), 37)
    tdt = getattr(torch, dtype)
    got = page_checksum(torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt), 37)
    assert got == ref
    assert page_checksum(torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt), 36) != ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_import_round_trip(dtype):
    model = TransformerLM(dataclasses.replace(CFG, dtype=dtype), device="cpu")
    src = PagedSlotManager(model, 2, 64, 16)
    dst = PagedSlotManager(model, 2, 64, 16)
    src.reserve(1, 40)
    g = torch.Generator().manual_seed(0)
    for key in ("k", "v"):
        pool = src.cache[key]
        pool.copy_(torch.randn(pool.shape, generator=g).to(pool.dtype))
    src.cache["length"][1] = 37
    dst.reserve(0, 20)                     # the destination assigns other ids
    pages, k, v, length, crc = src.export_pages(1)
    assert length == 37 and k.shape[2] == 3 and crc == page_checksum(k, v, 37)
    new = dst.import_pages(1, k, v, length, checksum=crc)
    assert new != pages and dst.tables[1] == new
    idx_src, idx_dst = torch.tensor(pages), torch.tensor(new)
    for key in ("k", "v"):
        assert torch.equal(dst.cache[key].index_select(2, idx_dst), src.cache[key].index_select(2, idx_src))
    assert int(dst.cache["length"][1]) == 37
    dst.check_block_table_mirror()
    dst.check_refcounts()
    assert dst.peak_kv_bytes() == dst.kv_bytes_in_use() == 5 * dst.kv_bytes_capacity() // dst.num_pages
    # restore from the device record: the same ownership
    tables = [list(t) for t in dst.tables]
    dst.sync_from_device()
    assert dst.tables == tables
    dst.allocator.check_consistency()
    with pytest.raises(RuntimeError, match="already holds pages"):
        dst.import_pages(1, k, v, length)


def test_flipped_bit_refused_with_the_pool_untouched(models, reference):
    _, _, model, params = models
    fleet = _fleet(model, params)
    with scripted_clock():
        fleet.begin_serve(_bound_requests(), LagrangianPolicy)
        while not fleet.engines[0].slots.active_slots:
            fleet.step()
        slot = fleet.engines[0].slots.active_slots[0]
        ckpt = fleet.engines[0].export_slot(slot)
        flipped = ckpt.k_pages.clone()
        flipped.view(torch.uint8).view(-1)[0] ^= 1          # one bit
        dst = fleet.engines[1]
        before = {key: t.clone() for key, t in dst.slots.cache.items()}
        used = dst.slots.allocator.num_used
        with pytest.raises(PageIntegrityError):
            dst.import_slot(dataclasses.replace(ckpt, k_pages=flipped))
        assert dst.slots.allocator.num_used == used
        assert all(torch.equal(before[key], t) for key, t in dst.slots.cache.items())
        dst.slots.allocator.check_consistency()
        dst.import_slot(ckpt)                                # the clean payload lands
        while fleet.step():
            pass
        fleet.finish_serve()
    assert fleet.generated == reference["bound"]
    _assert_no_leaks(fleet)


def test_flipped_bit_in_flight_falls_back_to_recompute(models, reference, monkeypatch):
    _, _, model, params = models
    fleet = _fleet(model, params)
    with scripted_clock():
        fleet.begin_serve(_bound_requests(), LagrangianPolicy)
        while not any(fleet.engines[0].slots.emitted[s] >= 2 for s in fleet.engines[0].slots.active_slots):
            fleet.step()
        slot = fleet.engines[0].slots.active_slots[0]
        clean_import = Engine.import_slot

        def corrupting_import(self, ckpt):
            flipped = ckpt.k_pages.clone()
            flipped.view(torch.uint8).view(-1)[0] ^= 1
            return clean_import(self, dataclasses.replace(ckpt, k_pages=flipped))

        monkeypatch.setattr(Engine, "import_slot", corrupting_import)
        assert fleet.migrate_slot(0, slot, 1) == "recompute"
        monkeypatch.setattr(Engine, "import_slot", clean_import)
        while fleet.step():
            pass
        report = fleet.finish_serve()
    assert fleet.integrity_rejections == 1 and report.meta["integrity_rejections"] == 1.0
    assert fleet.migration_log[-1]["integrity_rejected"] == 1
    assert fleet.generated == reference["bound"]
    _assert_no_leaks(fleet)


# --------------------------------------------------------------------------- #
# Migration parity                                                            #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("num_pages", [None, 8])
def test_bound_migration_parity_every_decode_step(models, reference, num_pages):
    _, _, model, params = models
    for e in range(1, 6):
        fleet = _fleet(model, params, engine_kw=dict(num_pages=num_pages))
        with scripted_clock():
            report, migrated = _serve_with_bound_migration(fleet, _bound_requests(), rid=0, emitted_at=e)
        assert migrated, f"never saw rid 0 bound with emitted == {e}"
        report.validate()
        assert all(eng.recomputed_tokens == 0 for eng in fleet.engines)
        assert fleet.migration_events == 1 and report.meta["migration_events"] == 1.0
        assert report.meta["recomputed_tokens"] == 0.0
        assert fleet.generated == reference["bound"], f"stream diverged at emitted={e}"
        assert 0 in {r.rid for r in report.traces[1].requests}
        assert report.traces[0].meta["migrations_out"] == report.traces[1].meta["migrations_in"] == 1
        _assert_no_leaks(fleet)
        if e == 2 and num_pages is None:
            ref = reference["migrated"]
            assert fleet.generated == ref["generated"]
            assert fleet.migration_log == ref["log"]
            assert report.makespan == ref["makespan"]


def test_mid_chunk_migration_parity(models, reference):
    _, _, model, params = models
    fleet = _fleet(model, params)
    migrated = False
    with scripted_clock():
        fleet.begin_serve(_chunk_requests(), LagrangianPolicy)
        while True:
            eng = fleet.engines[0]
            if not migrated:
                for slot, st in list(eng._chunking.items()):
                    if st.req.rid == 0 and st.done > 0:
                        assert fleet.migrate_slot(0, slot, 1) == "page_copy"
                        assert fleet.migration_log[-1]["kind"] == "chunking"
                        migrated = True
                        break
            if not fleet.step():
                break
        report = fleet.finish_serve()
    assert migrated, "never saw rid 0 between prefill chunks"
    report.validate()
    assert all(eng.recomputed_tokens == 0 for eng in fleet.engines)
    assert fleet.generated == reference["chunk"]
    _assert_no_leaks(fleet)


def test_migrate_slot_refuses_without_headroom(models):
    _, _, model, params = models
    fleet = _fleet(model, params, engine_kw=dict(n_slots=1))
    probed = False
    with scripted_clock():
        fleet.begin_serve(
            [Request(rid=0, n_prefill=10, n_decode=4), Request(rid=1, n_prefill=8, n_decode=30)],
            LagrangianPolicy,
        )
        while True:
            eng = fleet.engines[0]
            slots = list(eng.slots.active_slots)
            if slots and not probed and fleet.engines[1].slots.active_slots:
                assert not fleet.engines[1].can_import(1)
                assert not fleet.migrate_slot(0, slots[0], 1)
                assert eng.slots.request_of[slots[0]] is not None
                assert fleet.migration_events == 0
                probed = True
            if not fleet.step():
                break
        fleet.finish_serve().validate()
    assert probed, "rid 0 and rid 1 were never in flight together"
    with pytest.raises(ValueError, match="coincide"):
        fleet.migrate_slot(0, 0, 0)


# --------------------------------------------------------------------------- #
# Drain and recovery                                                          #
# --------------------------------------------------------------------------- #
def test_drain_zero_drops_zero_recompute(models, reference):
    _, _, model, params = models
    fleet = _fleet(model, params)
    with scripted_clock():
        fleet.begin_serve(_drain_requests(), LagrangianPolicy)
        assert _step_until_survivor_idle(fleet)
        n_in_flight = len(fleet.engines[0].slots.active_slots)
        entry = fleet.drain_replica(0)
        while fleet.step():
            pass
        report = fleet.finish_serve()
    done = [r for t in report.traces for r in t.requests]
    assert len(done) == 6 and len({r.rid for r in done}) == 6
    assert all(r.t_done is not None for r in done)
    assert fleet.generated == reference["drain"]
    assert entry["page_copy"] == n_in_flight and entry["recompute"] == 0
    assert report.meta["recomputed_tokens"] == 0.0 and report.meta["drained_replicas"] == 1.0
    assert report.meta["recovered_page_copy"] >= 1.0 and report.meta["recovered_recompute"] == 0.0
    drained = reference["drained"]
    assert fleet.generated == drained["generated"]
    assert entry == drained["entry"] and report.meta == drained["meta"]
    assert report.makespan == drained["makespan"]
    _assert_no_leaks(fleet)


def test_drain_fault_plan_and_api_guards(models, reference):
    _, _, model, params = models
    fleet = _fleet(model, params)
    with scripted_clock():
        clean = fleet.serve(_drain_requests(), LagrangianPolicy)
        report = fleet.serve(
            _drain_requests(), LagrangianPolicy,
            fault_plan=FaultPlan([ReplicaFault(replica=0, at_s=0.5 * clean.makespan, kind="drain")]),
        )
    assert fleet.generated == reference["drain"]
    assert report.meta["drained_replicas"] == 1.0 and report.meta["recomputed_tokens"] == 0.0
    _assert_no_leaks(fleet)
    with scripted_clock():
        fleet.begin_serve(_drain_requests(), LagrangianPolicy)
        for _ in range(4):
            fleet.step()
        fleet.drain_replica(0)
        with pytest.raises(ValueError, match="already retired"):
            fleet.drain_replica(0)
        with pytest.raises(RuntimeError, match="last alive"):
            fleet.drain_replica(1)
        while fleet.step():
            pass
        fleet.finish_serve().validate()
    assert fleet.generated == reference["drain"]
    _assert_no_leaks(fleet)


def test_soft_kill_page_copy_beats_hard_kill_recompute(models, reference):
    _, _, model, params = models
    recomputed = {}
    for readable in (True, False):
        fleet = _fleet(model, params)
        with scripted_clock():
            fleet.begin_serve(_drain_requests(), LagrangianPolicy)
            assert _step_until_survivor_idle(fleet, min_emitted=2)
            fleet._kill_replica(0, fleet.engines[0].clock, pool_readable=readable)
            while fleet.step():
                pass
            report = fleet.finish_serve()
        assert {r.rid for t in report.traces for r in t.requests} == set(range(6))
        assert fleet.generated == reference["drain"], f"diverged (readable={readable})"
        recomputed[readable] = report.meta["recomputed_tokens"]
        if readable:
            assert report.meta["recovered_page_copy"] >= 1.0
            assert report.meta["recovered_recompute"] == 0.0
        else:
            assert report.meta["recovered_page_copy"] == 0.0
            assert report.meta["recovered_recompute"] >= 1.0
            assert report.meta["time_to_recover_s"] > 0.0
        _assert_no_leaks(fleet)
    assert recomputed[True] == 0.0 and recomputed[False] > 0.0


def test_running_steal_improves_straggler_makespan(models):
    _, _, model, params = models
    specs = [ReplicaSpec(speed_factor=1.0), ReplicaSpec(speed_factor=0.25)]

    def requests():
        return [
            Request(rid=0, n_prefill=8, n_decode=4),
            Request(rid=1, n_prefill=10, n_decode=32),
            Request(rid=2, n_prefill=8, n_decode=4),
        ]

    results = {}
    for running in (True, False):
        fleet = _fleet(model, params, specs=specs, work_stealing=True, steal_running=running)
        with scripted_clock():
            report = fleet.serve(requests(), LagrangianPolicy)
        assert all(eng.recomputed_tokens == 0 for eng in fleet.engines)
        _assert_no_leaks(fleet)
        results[running] = (report, dict(fleet.generated), fleet)
    on_report, on_gen, on_fleet = results[True]
    off_report, off_gen, _ = results[False]
    assert on_fleet.migration_events >= 1
    assert [(e["from"], e["to"]) for e in on_fleet.steal_log if e.get("running")] == [(1, 0)]
    assert on_gen == off_gen
    assert on_report.makespan < off_report.makespan


def test_fleet_checkpoint_round_trips_fault_state(models):
    _, _, model, params = models

    def requests():
        return [Request(rid=i, n_prefill=10, n_decode=10) for i in range(6)]

    plan = lambda: FaultPlan([ReplicaFault(replica=0, at_s=0.0)])
    fleet = _fleet(model, params)
    with scripted_clock():
        fleet.begin_serve(requests(), LagrangianPolicy, fault_plan=plan())
        while not fleet.fault_log and fleet.step():
            pass
        assert fleet.fault_log, "kill never applied"
        for _ in range(3):
            fleet.step()
        state = fleet.state_dict()
        pre = {rid: list(t) for rid, t in fleet.generated.items()}
        lost = fleet._lost_preemptions
        fleet2 = _fleet(model, params)
        fleet2.load_state_dict(state, {r.rid: r for r in requests()})
        assert fleet2._dead == {0} and fleet2.alive_replicas == [1]
        assert fleet2._lost_preemptions == lost
        assert fleet2.recovered_requests == fleet.recovered_requests
        assert fleet2.fault_log == fleet.fault_log
        while fleet2.step():
            pass
        report2 = fleet2.finish_serve()
        uninterrupted = _fleet(model, params)
        uninterrupted.serve(requests(), LagrangianPolicy, fault_plan=plan())
    assert report2.meta["dead_replicas"] == 1.0 and report2.meta["fault_events"] == 1.0
    assert report2.meta["lost_preemptions"] == float(lost)
    post = fleet2.generated
    for rid, toks in uninterrupted.generated.items():
        assert pre.get(rid, []) + post.get(rid, []) == toks, f"rid {rid}"


# --------------------------------------------------------------------------- #
# The invariant checks                                                        #
# --------------------------------------------------------------------------- #
def test_debug_invariants_catch_a_tampered_block_table(models):
    _, _, model, params = models
    eng = Engine(model, params, EngineConfig(**ENGINE_CFG, debug_invariants=True), device="cpu")
    eng.profiler.cost_model = CostModel(level_caps=CAPS)
    reqs = [Request(rid=0, n_prefill=10, n_decode=8)]
    clients = build_clients(eng.cfg.n_slots, reqs, None)
    eng.begin_serve(reqs, clients, GlobalQueueScheduler(reqs), LagrangianPolicy())
    while not eng.slots.active_slots:
        eng.serve_step()
    eng.serve_step()                                         # a clean stage passes
    slot = eng.slots.active_slots[0]
    eng.slots.cache["block_tables"][slot, 0] += 1
    with pytest.raises(AssertionError, match="diverged from"):
        eng.serve_step()
