"""Port parity, engine: the port's paged + mixed engine under hybrid
scheduling against the reference engine under the same settings — identical
``Engine.generated`` streams, the same stage kinds and tokens per stage, and
a trace that validates. The cost model is pinned (no refits) and straggler
mitigation is off on both engines, so no wall-clock reading can steer either
schedule."""
import jax
import numpy as np
import pytest

from repro.core import CostModel as RefCostModel
from repro.core import LagrangianPolicy as RefLagrangian
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
    LagrangianPolicy,
    SortingPreemptiveScheduler,
    build_clients,
    solve_offline,
)
from repro_torch.data import WorkloadSpec, gsm8k_like_workload
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.profiler import OnlineProfiler
from torch_port_helpers import port_model_and_params, ref_model_and_params

SPEC = dict(
    n_requests=10, input_mean=20, input_std=6, output_mean=12, output_std=5,
    output_max=16, input_max=40,
)
ENGINE = dict(
    n_slots=4, max_len=64, kv_layout="paged", mixed_schedule=True,
    prefill_chunk=16, straggler_factor=1e9,
)
CAPS = (32, 64, 128)


def _stages(trace):
    return [(s.kind.name, s.tokens, s.chunk_tokens, s.rounds) for s in trace.stages]


@pytest.fixture(scope="module")
def both_serves():
    ref_model, ref_params = ref_model_and_params()
    model, params = port_model_and_params(ref_params)

    ref_cm = RefCostModel(level_caps=CAPS)
    ref_reqs = ref_workload(RefSpec(**SPEC), seed=3, known_lengths=True)
    ref_asn = ref_solve_offline(ref_reqs, 4, ref_cm).assignment
    ref_clients = ref_build_clients(4, ref_reqs, ref_asn)
    ref_eng = RefEngine(
        ref_model, ref_params, RefEngineConfig(**ENGINE),
        profiler=RefProfiler(initial=ref_cm, refit_every=10**9),
    )
    ref_trace = ref_eng.serve(ref_reqs, ref_clients, RefSorting(ref_clients), RefLagrangian())

    cm = CostModel(level_caps=CAPS)
    reqs = gsm8k_like_workload(WorkloadSpec(**SPEC), seed=3, known_lengths=True)
    asn = solve_offline(reqs, 4, cm).assignment
    clients = build_clients(4, reqs, asn)
    eng = Engine(
        model, params, EngineConfig(**ENGINE),
        profiler=OnlineProfiler(initial=cm, refit_every=10**9), device="cpu",
    )
    trace = eng.serve(reqs, clients, SortingPreemptiveScheduler(clients), LagrangianPolicy())
    return (ref_asn, ref_eng, ref_trace), (asn, eng, trace)


def test_engine_generates_the_reference_streams(both_serves):
    (ref_asn, ref_eng, _), (asn, eng, trace) = both_serves
    assert asn == ref_asn                      # same offline plan on both sides
    assert eng.generated == ref_eng.generated
    trace.validate()


def test_engine_schedules_the_reference_stages(both_serves):
    (_, ref_eng, ref_trace), (_, eng, trace) = both_serves
    assert _stages(trace) == _stages(ref_trace)
    kinds = {k for k, *_ in _stages(trace)}
    assert "MIXED" in kinds and "DECODE" in kinds     # the path under test ran
    for key in ("mixed_rounds", "decode_dispatches", "preemption_events"):
        assert trace.meta[key] == ref_trace.meta[key]
    assert all(eng.slots.request_of[s] is None for s in range(4))
    assert eng.slots.allocator.num_used == 0


def test_engine_rejects_what_the_port_does_not_serve():
    _, ref_params = ref_model_and_params()
    model, params = port_model_and_params(ref_params)
    with pytest.raises(NotImplementedError, match="paged"):
        Engine(model, params, EngineConfig(kv_layout="dense"), device="cpu")
    with pytest.raises(NotImplementedError, match="observ"):
        Engine(model, params, EngineConfig(observe=object()), device="cpu")
    with pytest.raises(ValueError, match="model lives on"):
        Engine(model, params, EngineConfig(), device="meta")
