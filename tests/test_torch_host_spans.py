"""The engine's host spans (``repro_torch.obs.host``): every ``serve_step`` is
one ``engine.step`` whose phases tile it in order, the stage's launch and
wait are its duration, the policy span is its decision time, the spans reach
the profiler only while it records, and the ring detects a wrap."""
import pytest
import torch

import repro_torch.obs.host as host_mod
from repro_torch.core import LagrangianPolicy
from repro_torch.core.iteration import Decision
from repro_torch.core.types import StageKind
from repro_torch.obs.host import PHASES, HostSpans
from torch_port_engine import ALTERNATING, DENSE, PAGED, PORT, engine, fcfs, gsm8k

# (engine settings, speed factor, the dispatch kind of a prefill stage)
SERVES = {
    "paged-mixed": (PAGED, 1.0, "chunk"),
    "paged-chunk-rounds": (ALTERNATING, 2.0, "chunk"),
    "dense": (DENSE, 0.5, "prefill"),
}
KINDS = {StageKind.MIXED: "mixed", StageKind.DECODE: "decode"}


class RefusesOnce(LagrangianPolicy):
    """Refuses the first stage it is offered, so that the engine retries."""

    refused = False

    def decide(self, snap, cost_model, **kw):
        if not self.refused:
            self.refused = True
            return Decision(prefill=False)
        return super().decide(snap, cost_model, **kw)


def _steps(eng, policy=None, limit=None):
    """Serve the GSM8K-shaped set step by step; per step, the step span,
    the stage it added (or None) and its new decision times."""
    reqs = gsm8k(PORT)
    clients, sched, lagrangian = fcfs(PORT, reqs, "LagrangianPolicy")
    eng.begin_serve(reqs, clients, sched, policy or lagrangian)
    trace = eng._sv.trace
    out = []
    while limit is None or len(out) < limit:
        mark, n_stages, n_dec = eng.host.count, len(trace.stages), len(trace.decision_times_ms)
        status = eng.serve_step()
        (step,) = eng.host.since(mark)
        stage = trace.stages[-1] if len(trace.stages) > n_stages else None
        out.append((step, stage, trace.decision_times_ms[n_dec:]))
        if status == "done":
            break
        assert status == "ran"
    return out


def _attempts(step):
    """The step's phase names, split where a retry starts scheduling again."""
    runs = []
    for p in step.phases:
        if p.name == PHASES[0]:
            runs.append([])
        runs[-1].append(p.name)
    return runs


@pytest.mark.parametrize("serve", sorted(SERVES))
def test_every_step_is_one_span_tiled_by_its_phases(serve):
    cfg, speed, prefill_kind = SERVES[serve]
    eng = engine(PORT, cfg, speed_factor=speed)
    steps = _steps(eng)
    assert [s.id for s, _, _ in steps] == list(range(len(steps)))
    kinds = set()
    for step, stage, decisions in steps:
        phases = step.phases
        assert step.start <= phases[0].start and phases[-1].end <= step.end
        assert all(a.end <= b.start and a.start <= a.end for a, b in zip(phases, phases[1:]))
        attempts = _attempts(step)
        for names in attempts:
            assert names == list(PHASES[:len(names)])
        # one policy span a decision, equal to its decision time
        policy = [p for p in phases if p.name == "engine.policy"]
        assert len(policy) == len(decisions)
        for p, ms in zip(policy, decisions):
            assert (p.end - p.start) * 1e3 == ms
        if stage is None:
            assert step.kind is None and len(attempts[-1]) <= 3
            continue
        # a stage: every phase once in its last attempt, launch + wait its time
        assert attempts[-1] == list(PHASES)
        by = {p.name: p.end - p.start for p in phases[-len(PHASES):]}
        assert by["engine.launch"] + by["engine.wait"] == pytest.approx(
            (stage.t_end - stage.t_start) * speed, rel=1e-9, abs=1e-12)
        want = KINDS.get(stage.kind, prefill_kind)
        assert step.kind == want
        assert step.shape and step.shape[0] >= 1
        kinds.add(want)
    assert kinds >= {"decode", prefill_kind}
    if cfg is PAGED:
        assert "mixed" in kinds


def test_a_retry_records_its_phases_again_in_order():
    eng = engine(PORT, PAGED)
    (step, stage, decisions), *_ = _steps(eng, policy=RefusesOnce(), limit=1)
    attempts = _attempts(step)
    assert len(attempts) == 2 and len(decisions) == 2
    assert attempts[0] == list(PHASES[:3]) and attempts[1] == list(PHASES)
    assert stage is not None and step.kind == "chunk"


def test_spans_reach_the_profiler_only_while_it_records(monkeypatch):
    entered = []
    real = host_mod._RecordFunctionFast

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(host_mod, "_RecordFunctionFast", counting)
    _steps(engine(PORT, PAGED), limit=4)
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        steps = _steps(engine(PORT, PAGED), limit=5)
    names = [e.name for e in prof.events()]
    # the phases tile the step, so the step opens no range of its own
    assert "engine.step" not in names and "engine.step" not in entered
    for name in PHASES:
        n = sum(1 for s, _, _ in steps for p in s.phases if p.name == name)
        assert names.count(name) == n == entered.count(name)
    entered.clear()
    _steps(engine(PORT, PAGED), limit=2)
    assert entered == []


def test_the_ring_keeps_a_mark_and_detects_a_wrap():
    spans = HostSpans(capacity=4)

    def step():
        spans.begin(0.0)
        spans.enter("engine.policy")
        spans.end()

    mark = spans.count
    for _ in range(3):
        step()
    assert [s.id for s in spans.since(mark)] == [0, 1, 2]
    later = spans.count
    step()
    assert [s.id for s in spans.since(later)] == [3]
    assert [s.id for s in spans.since(mark)] == [0, 1, 2, 3]
    step()
    with pytest.raises(RuntimeError, match="wrapped"):
        spans.since(mark)
    assert [s.id for s in spans.since(later)] == [3, 4]
    assert spans.since(spans.count) == []
    assert spans.count == 5


def test_host_spans_stay_out_of_the_engine_checkpoint():
    eng = engine(PORT, PAGED)
    _steps(eng, limit=6)
    assert eng.host.count == 6

    def walk(x):
        yield x
        if isinstance(x, dict):
            x = list(x.values())
        if isinstance(x, (list, tuple)):
            for v in x:
                yield from walk(v)

    assert not any(isinstance(x, (HostSpans, host_mod.StepSpan, host_mod.Span))
                   for x in walk(eng.state_dict()))
