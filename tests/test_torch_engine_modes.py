"""The paper's four scheduling modes on the real engine, port against
reference: ``baseline`` (global FCFS, prefill-first), ``offline``
(bin-packed backlogs, no stealing), ``online`` (round-robin backlogs,
Algorithm 1, the Lagrangian rule) and ``hybrid`` (bin-packed backlogs,
Algorithm 1, the Lagrangian rule), each built for the engine as
``core.simulate`` builds it (the port through ``launch.serve.
build_scheduling``, which ``chip_smoke.py``'s phase paper serves), on the
float32 smoke Qwen3 with 4 slots, on the dense and the paged layout. Both
engines read a scripted clock and their cost models are pinned, so each
mode must give the reference's token streams, its stage list (kind, times,
bin, busy slots, tokens, rounds) and its ``summary()``.

Also the bucket-overflow repair: the error names both bucket tables of
``EngineConfig``, and a dense prompt past the largest seq bucket is refused
with it (the reference's ``tests/test_paged.py:312,318``)."""
import dataclasses

import pytest

from repro import core as ref_core
from repro.data import WorkloadSpec as RefSpec
from repro.data import gsm8k_like_workload as ref_workload
from repro.serving.engine import Engine as RefEngine
from repro.serving.engine import EngineConfig as RefEngineConfig
from repro.serving.profiler import OnlineProfiler as RefProfiler
from repro_torch.core import (
    CostModel,
    GlobalQueueScheduler,
    PrefillFirstPolicy,
    Request,
    StageRecord,
    build_clients,
)
from repro_torch.data import WorkloadSpec, gsm8k_like_workload
from repro_torch.launch.serve import build_scheduling
from repro_torch.serving.engine import Engine, EngineConfig, _bucket
from repro_torch.serving.profiler import OnlineProfiler
from torch_port_helpers import port_model_and_params, ref_model_and_params, scripted_clock

MODES = ("baseline", "offline", "online", "hybrid")
N_SLOTS = 4
CAPS = (32, 64, 128, 256)
# GSM8K-shaped: ragged prompts and outputs, 3 requests a slot
SPEC = dict(n_requests=12, input_mean=20, input_std=8, input_max=40,
            output_mean=10, output_std=6, output_mu0=10, output_sigma0=6, output_max=24)
LAYOUTS = {
    "dense": dict(n_slots=N_SLOTS, max_len=64, prefill_seq_buckets=(64,), kv_layout="dense"),
    "paged": dict(n_slots=N_SLOTS, max_len=64, kv_layout="paged", page_size=16,
                  prefill_chunk=16),
}
STAGE_FIELDS = [f.name for f in dataclasses.fields(StageRecord)]


def _ref_scheduling(mode, reqs, n, cm):
    """The reference's clients, scheduler and policy as its ``simulate``
    builds them (``repro/core/simulator.py:236-262``)."""
    if mode == "baseline":
        clients = [ref_core.ClientState(cid=j) for j in range(n)]
        return clients, ref_core.GlobalQueueScheduler(reqs), ref_core.PrefillFirstPolicy()
    if mode in ("offline", "hybrid"):
        asn = ref_core.solve_offline(reqs, n, cm).assignment
    else:
        asn = ref_core.round_robin_assign(reqs, n)
    clients = ref_core.build_clients(n, reqs, asn)
    if mode == "offline":
        return clients, ref_core.StaticBacklogScheduler(clients), ref_core.PrefillFirstPolicy()
    return clients, ref_core.SortingPreemptiveScheduler(clients), ref_core.LagrangianPolicy()


def _stages(trace):
    return [{f: (getattr(s, f).value if f == "kind" else getattr(s, f)) for f in STAGE_FIELDS}
            for s in trace.stages]


@pytest.fixture(scope="module")
def weights():
    ref_model, ref_params = ref_model_and_params()
    model, params = port_model_and_params(ref_params)
    return ref_model, ref_params, model, params


@pytest.fixture(scope="module", params=list(LAYOUTS))
def serves(request, weights):
    """Each mode served in turn by one engine of each package on one layout
    (a serve resets the engine's per-serve state; one engine a layout keeps
    the reference's compilations to one set)."""
    ref_model, ref_params, model, params = weights
    layout = LAYOUTS[request.param]
    ref_cm, cm = ref_core.CostModel(level_caps=CAPS), CostModel(level_caps=CAPS)
    ref_eng = RefEngine(ref_model, ref_params, RefEngineConfig(**layout),
                        profiler=RefProfiler(initial=ref_cm, refit_every=10**9))
    eng = Engine(model, params, EngineConfig(**layout),
                 profiler=OnlineProfiler(initial=cm, refit_every=10**9), device="cpu")
    out = {}
    for mode in MODES:
        with scripted_clock():
            ref_reqs = ref_workload(RefSpec(**SPEC), seed=5, known_lengths=True)
            clients, sched, pol = _ref_scheduling(mode, ref_reqs, N_SLOTS, ref_cm)
            ref_trace = ref_eng.serve(ref_reqs, clients, sched, pol, policy_name=mode)

            reqs = gsm8k_like_workload(WorkloadSpec(**SPEC), seed=5, known_lengths=True)
            clients, sched, pol = build_scheduling(mode, reqs, N_SLOTS, cm)
            trace = eng.serve(reqs, clients, sched, pol, policy_name=mode)
        out[mode] = (dict(eng.generated), trace), (dict(ref_eng.generated), ref_trace)
    return request.param, out


@pytest.mark.parametrize("mode", MODES)
def test_mode_gives_the_reference_streams(serves, mode):
    _, out = serves
    (generated, trace), (ref_generated, _) = out[mode]
    assert generated == ref_generated
    assert sum(len(v) for v in generated.values()) == sum(r.n_decode for r in trace.requests)
    trace.validate()


@pytest.mark.parametrize("mode", MODES)
def test_mode_gives_the_reference_stages_and_summary(serves, mode):
    _, out = serves
    (_, trace), (_, ref_trace) = out[mode]
    assert _stages(trace) == _stages(ref_trace)
    assert trace.summary() == ref_trace.summary()


def test_modes_schedule_differently(serves):
    """The configurations are different schedules, so the comparison above
    would notice a mode built as another. On the dense layout (the paper's
    alternating PD competition) all four differ. On the paged layout,
    offline and hybrid share the bin-packed backlogs and, on this workload,
    the same schedule: mixed steps run a slot's prefill chunks inside the
    decode rounds under either policy."""
    layout, out = serves
    sched = {m: [(s["kind"], sorted(s["busy"].items())) for s in _stages(out[m][0][1])]
             for m in MODES}
    distinct = {"dense": MODES, "paged": ("baseline", "offline", "online")}[layout]
    assert all(sched[a] != sched[b] for a in distinct for b in distinct if a < b)
    if layout == "paged":
        assert sched["offline"] == sched["hybrid"]


def test_bucket_overflow_raises():
    assert _bucket(30, (32, 64)) == 32
    with pytest.raises(ValueError, match="exceeds the largest bucket") as err:
        _bucket(65, (32, 64))
    assert "prefill_seq_buckets" in str(err.value) and "prefill_req_buckets" in str(err.value)


def test_engine_rejects_oversize_prompt(weights):
    """A dense prompt longer than the largest seq bucket is refused, and the
    message names the table to raise."""
    _, _, model, params = weights
    reqs = [Request(rid=0, n_prefill=100, n_decode=4)]
    eng = Engine(model, params, EngineConfig(**{**LAYOUTS["dense"], "max_len": 80}), device="cpu")
    eng.profiler.cost_model = CostModel(level_caps=(32, 64, 128))
    clients = build_clients(N_SLOTS, reqs, None)
    with pytest.raises(ValueError, match="prefill_seq_buckets"):
        eng.serve(reqs, clients, GlobalQueueScheduler(reqs), PrefillFirstPolicy())
