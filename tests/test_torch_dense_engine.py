"""Port parity, dense-layout engine: whole-prompt prefill stages that preempt
decoding, then fused decode, against the reference engine under the hybrid
and the baseline policy — identical ``Engine.generated`` streams, the same
stage kinds and tokens per stage, equal decode dispatches, and prefill
stages run while decoders were active. Also: the port's launcher builds the
engine the reference launcher builds (same layout, same schedule, same
tokens). The cost model is pinned (no refits) and straggler mitigation is
off on both engines, so no wall-clock reading can steer either schedule."""
import numpy as np
import pytest

from repro.core import CostModel as RefCostModel
from repro.core import GlobalQueueScheduler as RefGlobalQueue
from repro.core import LagrangianPolicy as RefLagrangian
from repro.core import PrefillFirstPolicy as RefPrefillFirst
from repro.core import SortingPreemptiveScheduler as RefSorting
from repro.core import build_clients as ref_build_clients
from repro.core import solve_offline as ref_solve_offline
from repro.data import WorkloadSpec as RefSpec
from repro.data import gsm8k_like_workload as ref_workload
from repro.serving.engine import Engine as RefEngine
from repro.serving.engine import EngineConfig as RefEngineConfig
from repro.serving.profiler import OnlineProfiler as RefProfiler
from repro_torch.core import (
    CostModel,
    GlobalQueueScheduler,
    LagrangianPolicy,
    PrefillFirstPolicy,
    SortingPreemptiveScheduler,
    build_clients,
    solve_offline,
)
from repro_torch.data import WorkloadSpec, gsm8k_like_workload
from repro_torch.launch import serve as port_launcher
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.kv_slots import SlotManager
from repro_torch.serving.profiler import OnlineProfiler
from torch_port_helpers import port_model_and_params, ref_model_and_params

# ragged output lengths, so slots free up at different rounds and the
# policies open prefill stages while other slots decode
SPEC = dict(
    n_requests=10, input_mean=20, input_std=6, output_mean=12, output_std=8,
    output_mu0=12, output_sigma0=8, output_max=32, input_max=40,
)
ENGINE = dict(n_slots=4, max_len=80, kv_layout="dense", straggler_factor=1e9)
CAPS = (32, 64, 128)


def _stages(trace):
    return [(s.kind.name, s.tokens, s.rounds) for s in trace.stages]


def _ref_scheduling(policy, reqs, n, cm):
    if policy == "baseline":
        return ref_build_clients(n, reqs, None), RefGlobalQueue, RefPrefillFirst()
    clients = ref_build_clients(n, reqs, ref_solve_offline(reqs, n, cm).assignment)
    return clients, RefSorting, RefLagrangian()


def _scheduling(policy, reqs, n, cm):
    if policy == "baseline":
        return build_clients(n, reqs, None), GlobalQueueScheduler, PrefillFirstPolicy()
    clients = build_clients(n, reqs, solve_offline(reqs, n, cm).assignment)
    return clients, SortingPreemptiveScheduler, LagrangianPolicy()


def _scheduler(cls, clients, reqs):
    return cls(reqs) if cls in (RefGlobalQueue, GlobalQueueScheduler) else cls(clients)


@pytest.fixture(scope="module")
def weights():
    ref_model, ref_params = ref_model_and_params()
    model, params = port_model_and_params(ref_params)
    return ref_model, ref_params, model, params


@pytest.fixture(scope="module", params=["hybrid", "baseline"])
def both_serves(request, weights):
    policy = request.param
    ref_model, ref_params, model, params = weights
    ref_cm = RefCostModel(level_caps=CAPS)
    ref_reqs = ref_workload(RefSpec(**SPEC), seed=3, known_lengths=True)
    clients, sched, pol = _ref_scheduling(policy, ref_reqs, 4, ref_cm)
    ref_eng = RefEngine(ref_model, ref_params, RefEngineConfig(**ENGINE),
                        profiler=RefProfiler(initial=ref_cm, refit_every=10**9))
    ref_trace = ref_eng.serve(ref_reqs, clients, _scheduler(sched, clients, ref_reqs), pol)

    cm = CostModel(level_caps=CAPS)
    reqs = gsm8k_like_workload(WorkloadSpec(**SPEC), seed=3, known_lengths=True)
    clients, sched, pol = _scheduling(policy, reqs, 4, cm)
    eng = Engine(model, params, EngineConfig(**ENGINE),
                 profiler=OnlineProfiler(initial=cm, refit_every=10**9), device="cpu")
    trace = eng.serve(reqs, clients, _scheduler(sched, clients, reqs), pol)
    return (ref_eng, ref_trace), (eng, trace)


def test_dense_engine_generates_the_reference_streams(both_serves):
    (ref_eng, _), (eng, trace) = both_serves
    assert isinstance(eng.slots, SlotManager)
    assert eng.generated == ref_eng.generated
    trace.validate()


def test_dense_engine_schedules_the_reference_stages(both_serves):
    (ref_eng, ref_trace), (eng, trace) = both_serves
    assert _stages(trace) == _stages(ref_trace)
    kinds = [k for k, *_ in _stages(trace)]
    assert "PREFILL" in kinds and "DECODE" in kinds and "MIXED" not in kinds
    for key in ("mixed_rounds", "decode_dispatches", "preemption_events"):
        assert trace.meta[key] == ref_trace.meta[key]
    # the preempting branch ran: a prefill stage froze active decoders
    assert trace.meta["prefill_stall_time_s"] > 0 and ref_trace.meta["prefill_stall_time_s"] > 0
    assert "shared_pages_peak" not in trace.meta
    assert all(eng.slots.request_of[s] is None for s in range(4))


def test_launcher_serves_what_the_reference_launcher_serves(weights):
    """Each launcher's engine set-up (``repro/launch/serve.py:67-81`` and the
    port's ``engine_config`` / ``workload_spec``) with the hybrid policy, on
    the same weights, at a smoke size: the same default layout, the same
    stages and identical tokens."""
    ref_model, ref_params, model, params = weights
    n_slots, n_requests = 4, 8
    ref_cm = RefCostModel(level_caps=(32, 64, 128, 256))
    ref_reqs = ref_workload(RefSpec(
        n_requests=n_requests, input_mean=20, input_std=6,
        output_mean=24, output_std=10, output_max=48, input_max=30,
    ), seed=0, known_lengths=True)
    clients, sched, pol = _ref_scheduling("hybrid", ref_reqs, n_slots, ref_cm)
    ref_cfg = RefEngineConfig(n_slots=n_slots, max_len=128, prefill_seq_buckets=(32,),
                              straggler_factor=1e9)
    ref_eng = RefEngine(ref_model, ref_params, ref_cfg,
                        profiler=RefProfiler(initial=ref_cm, refit_every=10**9))
    ref_trace = ref_eng.serve(ref_reqs, clients, sched(clients), pol)

    cm = CostModel(level_caps=(32, 64, 128, 256))
    reqs = gsm8k_like_workload(port_launcher.workload_spec(n_requests), seed=0,
                               known_lengths=True)
    clients, sched, pol = port_launcher.build_scheduling("hybrid", reqs, n_slots, cm)
    cfg = port_launcher.engine_config(n_slots)
    cfg.straggler_factor = 1e9
    eng = Engine(model, params, cfg, profiler=OnlineProfiler(initial=cm, refit_every=10**9),
                 device="cpu")
    trace = eng.serve(reqs, clients, sched, pol)

    assert cfg.kv_layout == ref_cfg.kv_layout == "dense"
    assert EngineConfig().kv_layout == RefEngineConfig().kv_layout
    assert _stages(trace) == _stages(ref_trace)
    assert eng.generated == ref_eng.generated
    assert [r.n_prefill for r in reqs] == [r.n_prefill for r in ref_reqs]
    assert np.sum([len(v) for v in eng.generated.values()]) == sum(r.n_decode for r in reqs)
