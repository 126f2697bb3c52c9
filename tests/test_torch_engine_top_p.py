"""Port parity, engine under seeded top-p sampling on the float32 smoke
Qwen3: every stream equals the JAX engine's for the same seed.

A request's stream is a pure function of (seed, rid, token index), so one
reference serve of a workload fixes the stream that every port serve of it
must give: fused and per-token decode on both KV layouts, mixed rounds and
alternating chunk rounds, a request migrated by page-copy at any decode
step, and prefix-cache hits. The reference serves run once, in the module
fixture; the cost model is pinned and the fleets read a scripted clock."""
import pytest

from repro.core import CostModel as RefCostModel
from repro.core import GlobalQueueScheduler as RefGlobalQueue
from repro.core import LagrangianPolicy as RefLagrangian
from repro.core import PrefillFirstPolicy as RefPrefillFirst
from repro.core import Request as RefRequest
from repro.core import build_clients as ref_build_clients
from repro.data import WorkloadSpec as RefSpec
from repro.data import gsm8k_like_workload as ref_workload
from repro.data import shared_prefix_workload as ref_prefix_workload
from repro.serving.engine import Engine as RefEngine
from repro.serving.engine import EngineConfig as RefEngineConfig
from repro.serving.fleet import Fleet as RefFleet
from repro.serving.fleet import FleetConfig as RefFleetConfig
from repro.serving.profiler import OnlineProfiler as RefProfiler
from repro.serving.sampler import TopPSampler as RefTopP
from repro_torch.core import (
    CostModel,
    GlobalQueueScheduler,
    LagrangianPolicy,
    PrefillFirstPolicy,
    Request,
    build_clients,
)
from repro_torch.data import WorkloadSpec, gsm8k_like_workload, shared_prefix_workload
from repro_torch.serving import Engine, EngineConfig, Fleet, FleetConfig, OnlineProfiler, TopPSampler
from torch_port_helpers import port_model_and_params, ref_model_and_params, scripted_clock

CAPS = (32, 64, 128)
SEED = 3
# mixed prompt/decode lengths, so slots stop at different iterations of a
# shared horizon (the reference's fused-decode workload)
SPEC = dict(
    n_requests=10, input_mean=18, input_std=6, output_mean=12, output_std=8,
    output_max=24, input_max=28,
)
ENGINE = dict(n_slots=4, max_len=64, prefill_seq_buckets=(32,), straggler_factor=1e9)
PAGED = dict(kv_layout="paged", page_size=16, prefill_chunk=24, num_pages=16)
# the reference's prefix-cache workload: two groups sharing 16 and 27 tokens
PREFIX_SPEC = dict(
    n_requests=6, input_mean=32, input_std=4, output_mean=8, output_std=2,
    output_max=10, input_max=40,
)
PREFIX_WORKLOAD = dict(seed=2, n_groups=2, prefix_mean=20.0, prefix_std=6.0, known_lengths=True)
PREFIX_ENGINE = dict(
    n_slots=4, max_len=64, kv_layout="paged", page_size=8, prefill_chunk=16,
    straggler_factor=1e9,
)
# the reference's migration fleet: two paged replicas, one token a stage
FLEET_ENGINE = dict(
    n_slots=2, max_len=64, prefill_seq_buckets=(32,), kv_layout="paged",
    page_size=16, prefill_chunk=16, decode_horizon=1, mixed_schedule=False,
)
FLEET_CFG = dict(n_replicas=2, assign="round_robin", dispatch="round_robin", work_stealing=False)


def _bound_requests(cls=Request):
    return [cls(rid=0, n_prefill=10, n_decode=6), cls(rid=1, n_prefill=8, n_decode=3)]


def _ref_serve(model, params, workload, engine_kw, sampler, seed=SEED):
    cm = RefCostModel(level_caps=CAPS)
    reqs = workload()
    clients = ref_build_clients(4, reqs, None)
    eng = RefEngine(
        model, params, RefEngineConfig(**engine_kw, sample_seed=seed),
        profiler=RefProfiler(initial=cm, refit_every=10**9), sampler=sampler,
    )
    eng.serve(reqs, clients, RefGlobalQueue(reqs), RefPrefillFirst())
    return eng.generated


@pytest.fixture(scope="module")
def streams():
    """The reference's streams: the fused-decode workload (dense, K = 8),
    the shared-prefix workload (no cache) and the migration fleet's pair."""
    ref_model, ref_params = ref_model_and_params()
    model, params = port_model_and_params(ref_params)
    out = dict(model=model, params=params)
    out["fused"] = _ref_serve(
        ref_model, ref_params, lambda: ref_workload(RefSpec(**SPEC), seed=0, known_lengths=True),
        dict(ENGINE, decode_horizon=8), RefTopP(top_p=0.95),
    )
    out["prefix"] = _ref_serve(
        ref_model, ref_params, lambda: ref_prefix_workload(RefSpec(**PREFIX_SPEC), **PREFIX_WORKLOAD),
        PREFIX_ENGINE, RefTopP(top_p=0.9),
    )
    cm = RefCostModel(level_caps=CAPS)
    fleet = RefFleet(
        ref_model, ref_params, RefEngineConfig(**FLEET_ENGINE), RefFleetConfig(**FLEET_CFG),
        cost_model=cm, sampler=RefTopP(top_p=0.9),
        profiler_factory=lambda: RefProfiler(initial=cm, refit_every=10**9),
    )
    with scripted_clock():
        fleet.serve(_bound_requests(RefRequest), RefLagrangian)
    out["bound"] = {rid: list(t) for rid, t in fleet.generated.items()}
    return out


def _serve(streams, engine_kw, sampler=TopPSampler(top_p=0.95), seed=SEED, policy=PrefillFirstPolicy,
           workload=lambda: gsm8k_like_workload(WorkloadSpec(**SPEC), seed=0, known_lengths=True)):
    cm = CostModel(level_caps=CAPS)
    reqs = workload()
    clients = build_clients(4, reqs, None)
    eng = Engine(
        streams["model"], streams["params"], EngineConfig(**engine_kw, sample_seed=seed),
        profiler=OnlineProfiler(initial=cm, refit_every=10**9), sampler=sampler, device="cpu",
    )
    eng.serve(reqs, clients, GlobalQueueScheduler(reqs), policy()).validate()
    return eng


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_fused_top_p_matches_per_token_and_the_reference(streams, layout):
    kw = dict(ENGINE, **(PAGED if layout == "paged" else {}))
    runs = {k: _serve(streams, dict(kw, decode_horizon=k)) for k in (1, 8)}
    assert runs[8].decode_dispatches < runs[1].decode_dispatches
    assert runs[1].generated == runs[8].generated == streams["fused"]


def test_stream_is_a_pure_function_of_seed_and_rid(streams):
    """Paged at K = 4 gives the reference's dense K = 8 stream; another
    seed gives another stream."""
    paged = _serve(streams, dict(ENGINE, **PAGED, decode_horizon=4))
    assert paged.generated == streams["fused"]
    other = _serve(streams, dict(ENGINE, decode_horizon=8), seed=SEED + 1)
    assert other.generated.keys() == streams["fused"].keys()
    assert any(other.generated[r] != streams["fused"][r] for r in other.generated)


def test_mixed_matches_alternating_under_top_p(streams):
    runs = {}
    for mixed in (False, True):
        eng = _serve(
            streams, dict(ENGINE, **PAGED, mixed_schedule=mixed), policy=LagrangianPolicy,
        )
        runs[mixed] = eng
    assert runs[True].mixed_rounds > 0 and runs[False].mixed_rounds == 0
    assert runs[False].generated == runs[True].generated == streams["fused"]


def test_prefix_cache_top_p_matches_the_reference(streams):
    workload = lambda: shared_prefix_workload(WorkloadSpec(**PREFIX_SPEC), **PREFIX_WORKLOAD)  # noqa: E731
    runs = {
        cache: _serve(streams, dict(PREFIX_ENGINE, prefix_cache=cache), sampler=TopPSampler(top_p=0.9),
                      workload=workload)
        for cache in (False, True)
    }
    assert runs[True].cache_hit_tokens > 0
    assert runs[False].generated == runs[True].generated == streams["prefix"]


@pytest.mark.parametrize("num_pages", [None, 8])
def test_bound_migration_parity_every_decode_step_top_p(streams, num_pages):
    """The top-p case of the reference's page-copy test: rid 0 moves from
    replica 0 to replica 1 the moment it has emitted e tokens, for every e;
    its stream continues the reference's with nothing recomputed."""
    for e in range(1, 6):
        cm = CostModel(level_caps=CAPS)
        fleet = Fleet(
            streams["model"], streams["params"], EngineConfig(**FLEET_ENGINE, num_pages=num_pages),
            FleetConfig(**FLEET_CFG), cost_model=cm, sampler=TopPSampler(top_p=0.9),
            profiler_factory=lambda: OnlineProfiler(initial=cm, refit_every=10**9), device="cpu",
        )
        with scripted_clock():
            fleet.begin_serve(_bound_requests(), LagrangianPolicy)
            migrated = False
            while True:
                eng = fleet.engines[0]
                for slot in list(eng.slots.active_slots) if not migrated else ():
                    if eng.slots.request_of[slot].rid == 0 and eng.slots.emitted[slot] == e:
                        assert fleet.migrate_slot(0, slot, 1) == "page_copy"
                        migrated = True
                if not fleet.step():
                    break
            report = fleet.finish_serve()
        assert migrated, f"never saw rid 0 bound with emitted == {e}"
        report.validate()
        assert report.meta["migration_events"] == 1.0 and report.meta["recomputed_tokens"] == 0.0
        assert fleet.generated == streams["bound"], f"stream diverged at emitted={e}"
