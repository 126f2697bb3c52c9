"""Shared set-up of the engine-option parity tests
(``test_torch_engine_{policies,options,horizons,checkpoint}.py``): the
float32 smoke Qwen3 on 4 slots in both packages, each engine's cost model
pinned (no refits) and straggler mitigation off, both engines reading a
scripted clock. A setting is served by a reference engine and a port engine
built from the same keyword arguments, and the two serves must agree on
token streams, the stage list (kind, times, bin, busy slots, tokens,
rounds), the trace's counters and its ``summary()``.

Engines are cached by setting for the module that builds them: the
reference compiles its dispatches once an engine, so settings served
several times (the policies) share one engine a package."""
import dataclasses

from repro import core as ref_core
from repro import data as ref_data
from repro.serving.engine import Engine as RefEngine
from repro.serving.engine import EngineConfig as RefEngineConfig
from repro.serving.profiler import OnlineProfiler as RefProfiler
from repro_torch import core, data
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.profiler import OnlineProfiler
from torch_port_helpers import port_model_and_params, ref_model_and_params, scripted_clock

N_SLOTS = 4
CAPS = (32, 64, 128, 256)
# GSM8K-shaped: ragged prompts and outputs, 3 requests a slot
SPEC = dict(n_requests=12, input_mean=20, input_std=8, input_max=40,
            output_mean=10, output_std=6, output_mu0=10, output_sigma0=6, output_max=24)
PAGED = dict(n_slots=N_SLOTS, max_len=64, kv_layout="paged", page_size=16,
             prefill_chunk=16, straggler_factor=1e9)
ALTERNATING = dict(PAGED, mixed_schedule=False)
DENSE = dict(n_slots=N_SLOTS, max_len=64, kv_layout="dense", prefill_seq_buckets=(32, 64),
             straggler_factor=1e9)
STAGE_FIELDS = [f.name for f in dataclasses.fields(core.StageRecord)]


@dataclasses.dataclass(frozen=True)
class Package:
    """One package's names, so a setting is written once for both."""

    core: object
    data: object


REF = Package(ref_core, ref_data)
PORT = Package(core, data)

_weights = {}


def weights():
    """(reference model, its params, port model, its params), built once a
    test process."""
    if not _weights:
        ref_model, ref_params = ref_model_and_params()
        model, params = port_model_and_params(ref_params)
        _weights["w"] = (ref_model, ref_params, model, params)
    return _weights["w"]


def engine(pkg, engine_kw, **kw):
    """A ``pkg`` engine of ``engine_kw`` on the smoke Qwen3, its cost model
    pinned (``CAPS``, no refits); ``kw`` goes to the engine (a sampler, a
    speed factor, an overload policy)."""
    ref_model, ref_params, model, params = weights()
    cm = pkg.core.CostModel(level_caps=CAPS)
    if pkg is PORT:
        return Engine(model, params, EngineConfig(**engine_kw), device="cpu",
                      profiler=OnlineProfiler(initial=cm, refit_every=10**9), **kw)
    return RefEngine(ref_model, ref_params, RefEngineConfig(**engine_kw),
                     profiler=RefProfiler(initial=cm, refit_every=10**9), **kw)


def gsm8k(pkg, seed=5, **spec):
    """The GSM8K-shaped requests of ``SPEC`` (updated by ``spec``)."""
    return pkg.data.gsm8k_like_workload(pkg.data.WorkloadSpec(**{**SPEC, **spec}), seed=seed,
                                        known_lengths=True)


def fcfs(pkg, reqs, policy="PrefillFirstPolicy"):
    """One global FCFS queue over idle slots, under ``pkg.core.<policy>``."""
    clients = pkg.core.build_clients(N_SLOTS, reqs, None)
    return clients, pkg.core.GlobalQueueScheduler(reqs), getattr(pkg.core, policy)()


def arrivals(pkg, reqs, policy="LagrangianPolicy"):
    """The arrival-gated queue (``ArrivalQueueScheduler``)."""
    clients = pkg.core.build_clients(N_SLOTS, reqs, None)
    return clients, pkg.core.ArrivalQueueScheduler(reqs), getattr(pkg.core, policy)()


def run(eng, reqs, scheduling, validate=True, steps=None):
    """Serve through the step API (``Engine.serve``'s loop) and return the
    closed trace; with ``steps``, stop after that many stages and return the
    open session's engine instead."""
    clients, sched, policy = scheduling
    eng.begin_serve(reqs, clients, sched, policy)
    n = 0
    while steps is None or n < steps:
        status = eng.serve_step()
        if status == "done":
            break
        assert status != "idle", "engine deadlock: pending but no candidate"
        n += 1
    return eng if steps is not None else eng.finish_serve(validate=validate)


def stages(trace):
    return [{f: (getattr(s, f).value if f == "kind" else getattr(s, f)) for f in STAGE_FIELDS}
            for s in trace.stages]


def outcome(eng, trace):
    """What a serve must share with the reference's."""
    return dict(streams=dict(eng.generated), stages=stages(trace), meta=dict(trace.meta),
                summary=trace.summary())


def serve_both(make_reqs, scheduling, engine_kw=None, engines=None, validate=True, **kw):
    """Serve ``make_reqs(pkg)`` under ``scheduling(pkg, reqs)`` on a
    reference and a port engine (``engines`` = (reference, port), or new
    ones of ``engine_kw`` and ``kw``), both on the scripted clock. Returns
    (port outcome, reference outcome, port engine)."""
    ref_eng, eng = engines or (engine(REF, engine_kw, **kw), engine(PORT, engine_kw, **kw))
    out = []
    with scripted_clock():
        for pkg, e in ((REF, ref_eng), (PORT, eng)):
            reqs = make_reqs(pkg)
            out.append(outcome(e, run(e, reqs, scheduling(pkg, reqs), validate=validate)))
    return out[1], out[0], eng


def assert_same(port, ref):
    assert port["streams"] == ref["streams"]
    assert port["stages"] == ref["stages"]
    assert port["meta"] == ref["meta"]
    assert port["summary"] == ref["summary"]
