"""Port parity, engine under page pressure with prefix caching: a
shared-prefix workload on a pool too small for every slot, so admissions
adopt cached pages (copy-on-write at the divergence page) and decoders are
preempted and recomputed (which needs a queue-backed scheduler: global
queue + Lagrangian policy). The port's engine must give the reference's
streams and stage sequence, with the cost model pinned on both sides."""
import pytest

from repro.core import CostModel as RefCostModel
from repro.core import GlobalQueueScheduler as RefGlobalQueue
from repro.core import LagrangianPolicy as RefLagrangian
from repro.core import build_clients as ref_build_clients
from repro.data import WorkloadSpec as RefSpec
from repro.data import shared_prefix_workload as ref_workload
from repro.serving.engine import Engine as RefEngine
from repro.serving.engine import EngineConfig as RefEngineConfig
from repro.serving.profiler import OnlineProfiler as RefProfiler
from repro_torch.core import CostModel, GlobalQueueScheduler, LagrangianPolicy, build_clients
from repro_torch.data import WorkloadSpec, shared_prefix_workload
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.profiler import OnlineProfiler
from torch_port_helpers import port_model_and_params, ref_model_and_params

SPEC = dict(
    n_requests=10, input_mean=24, input_std=6, output_mean=14, output_std=5,
    output_max=20, input_max=40,
)
WORKLOAD = dict(seed=5, n_groups=2, prefix_mean=16.0, prefix_std=2.0, known_lengths=True)
ENGINE = dict(
    n_slots=4, max_len=64, kv_layout="paged", mixed_schedule=True,
    prefill_chunk=16, page_size=8, num_pages=14, prefix_cache=True,
    straggler_factor=1e9,
)
CAPS = (32, 64, 128)


def _serve(engine_cls, config_cls, profiler_cls, cm_cls, workload, spec_cls,
           clients_fn, sched_cls, pol_cls, model, params, **kw):
    cm = cm_cls(level_caps=CAPS)
    reqs = workload(spec_cls(**SPEC), **WORKLOAD)
    clients = clients_fn(4, reqs, None)
    eng = engine_cls(model, params, config_cls(**ENGINE),
                     profiler=profiler_cls(initial=cm, refit_every=10**9), **kw)
    trace = eng.serve(reqs, clients, sched_cls(reqs), pol_cls())
    return eng, trace


@pytest.fixture(scope="module")
def both_serves():
    ref_model, ref_params = ref_model_and_params()
    model, params = port_model_and_params(ref_params)
    ref = _serve(RefEngine, RefEngineConfig, RefProfiler, RefCostModel, ref_workload,
                 RefSpec, ref_build_clients, RefGlobalQueue, RefLagrangian,
                 ref_model, ref_params)
    port = _serve(Engine, EngineConfig, OnlineProfiler, CostModel, shared_prefix_workload,
                  WorkloadSpec, build_clients, GlobalQueueScheduler, LagrangianPolicy,
                  model, params, device="cpu")
    return ref, port


def test_prefix_cached_preempting_serve_matches_reference(both_serves):
    (ref_eng, ref_trace), (eng, trace) = both_serves
    assert eng.generated == ref_eng.generated
    stages = lambda tr: [(s.kind.name, s.tokens, s.chunk_tokens, s.rounds) for s in tr.stages]
    assert stages(trace) == stages(ref_trace)
    for key in ("cached_prefill_tokens", "cow_copies", "preemption_events",
                "recomputed_tokens", "shared_pages_peak"):
        assert trace.meta[key] == ref_trace.meta[key], key
    # the paths under test ran
    assert trace.meta["cached_prefill_tokens"] > 0
    assert trace.meta["preemption_events"] > 0
    trace.validate()
