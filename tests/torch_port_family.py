"""Shared set-up of the engine parity tests of the other decoders
(``test_torch_family_engine_*.py``): one workload through the JAX engine and
the port's on the same perturbed float32 weights, each under a scripted
clock with the cost model pinned and straggler mitigation off, so no
wall-clock reading steers either schedule; and the comparison."""
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
from torch_port_helpers import family_models, scripted_clock

# ragged prompts (up to 40 tokens: Mixtral's ring of 8 wraps in every
# prefill) and outputs, so slots free up at different rounds and prefill
# stages preempt decoding
SPEC = dict(n_requests=8, input_mean=20, input_std=8, output_mean=12, output_std=8,
            output_mu0=12, output_sigma0=8, output_max=24, input_max=40)
CAPS = (32, 64, 128)


def engine_settings(layout):
    if layout == "dense":
        return dict(n_slots=3, max_len=64, kv_layout="dense", straggler_factor=1e9)
    return dict(n_slots=3, max_len=64, kv_layout="paged", mixed_schedule=True,
                prefill_chunk=16, straggler_factor=1e9)


def stages(trace):
    return [(s.kind.name, s.tokens, s.chunk_tokens, s.rounds) for s in trace.stages]


def both_serves(arch, layout):
    """The same workload through the JAX engine and the port's, hybrid
    scheduling, on the same perturbed float32 weights."""
    ref_model, ref_params, model, params = family_models(arch)
    ref_cm = RefCostModel(level_caps=CAPS)
    ref_reqs = ref_workload(RefSpec(**SPEC), seed=3, known_lengths=True)
    clients = ref_build_clients(3, ref_reqs, ref_solve_offline(ref_reqs, 3, ref_cm).assignment)
    ref_eng = RefEngine(ref_model, ref_params, RefEngineConfig(**engine_settings(layout)),
                        profiler=RefProfiler(initial=ref_cm, refit_every=10**9))
    with scripted_clock():
        ref_trace = ref_eng.serve(ref_reqs, clients, RefSorting(clients), RefLagrangian())

    cm = CostModel(level_caps=CAPS)
    reqs = gsm8k_like_workload(WorkloadSpec(**SPEC), seed=3, known_lengths=True)
    clients = build_clients(3, reqs, solve_offline(reqs, 3, cm).assignment)
    eng = Engine(model, params, EngineConfig(**engine_settings(layout)),
                 profiler=OnlineProfiler(initial=cm, refit_every=10**9), device="cpu")
    with scripted_clock():
        trace = eng.serve(reqs, clients, SortingPreemptiveScheduler(clients), LagrangianPolicy())
    return (ref_eng, ref_trace), (eng, trace)


def check_same_serve(serves, layout):
    (ref_eng, ref_trace), (eng, trace) = serves
    trace.validate()
    assert eng.generated == ref_eng.generated
    assert stages(trace) == stages(ref_trace)
    for key in ("mixed_rounds", "decode_dispatches", "preemption_events",
                "prefill_stall_time_s"):
        assert trace.meta[key] == ref_trace.meta[key], key
    # under the scripted clock both engines read their clocks alike
    assert [(s.t_start, s.t_end) for s in trace.stages] == \
        [(s.t_start, s.t_end) for s in ref_trace.stages]
    assert trace.summary() == ref_trace.summary()
    kinds = {k for k, *_ in stages(trace)}
    assert "DECODE" in kinds and ("MIXED" in kinds) == (layout == "paged")
