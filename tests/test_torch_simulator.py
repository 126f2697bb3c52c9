"""Port parity of the paper's simulator (``repro_torch.core.simulator``, a
verbatim copy of the reference's): on the same requests the port's
``simulate`` equals the reference's exactly — ``summary()``, every field of
every ``StageRecord`` and every request's bookkeeping — in every mode on the
paper's workload (1319 requests, 200 clients, ``PAPER_COST_MODEL``, seed 0)
and on random small cases (the reference's invariant cases, with oracle
estimates and explicit iteration policies too). Both simulators' decision
timers read a ``ScriptedClock``, so ``decision_times_ms`` and the summary's
decision columns compare exactly as well. Then the reference's own checks
of ``tests/test_simulator.py``, run on the port: paper reproduction bands,
decision latency (on the scripted clock), Gantt and the oracle copy."""
import contextlib
import dataclasses

import numpy as np
import pytest

import repro.core.simulator as ref_sim_mod
import repro_torch.core.simulator as port_sim_mod
from repro import core as ref_core
from repro import data as ref_data
from repro_torch import core as port_core
from repro_torch import data as port_data
from repro_torch.core import CostModel, PAPER_COST_MODEL, simulate
from repro_torch.core.gantt import ascii_gantt, client_accounting, stage_csv, utilization_timeline
from repro_torch.core.types import make_requests
from repro_torch.data import PAPER_PREDICTOR_NOISE_STD, WorkloadSpec, gsm8k_like_workload
from torch_port_arrays import ScriptedClock

SMALL_CM = dict(level_caps=(64, 128, 256, 512))
MODES = ("baseline", "offline", "online", "hybrid", "static_rr", "global_fcfs")
STAGE_FIELDS = [f.name for f in dataclasses.fields(port_core.StageRecord)]
REQUEST_FIELDS = [f.name for f in dataclasses.fields(port_core.Request)]


@contextlib.contextmanager
def scripted_sim_clocks():
    """Both simulators time their decisions on a ScriptedClock."""
    saved = ref_sim_mod.time, port_sim_mod.time
    ref_sim_mod.time, port_sim_mod.time = ScriptedClock(), ScriptedClock()
    try:
        yield
    finally:
        ref_sim_mod.time, port_sim_mod.time = saved


def _stage(s):
    return {f: (getattr(s, f).value if f == "kind" else getattr(s, f)) for f in STAGE_FIELDS}


def _request(r):
    return {f: getattr(r, f) for f in REQUEST_FIELDS}


def assert_same_trace(trace, ref):
    assert trace.summary() == ref.summary()
    assert len(trace.stages) == len(ref.stages)
    for i, (s, r) in enumerate(zip(trace.stages, ref.stages)):
        assert _stage(s) == _stage(r), f"stage {i}"
    assert [_request(r) for r in trace.requests] == [_request(r) for r in ref.requests]
    assert trace.decision_times_ms == ref.decision_times_ms
    assert trace.policy_name == ref.policy_name and trace.meta == ref.meta


def _paper(pkg_data, seed=0):
    return pkg_data.gsm8k_like_workload(
        seed=seed, estimate_noise_std=pkg_data.PAPER_PREDICTOR_NOISE_STD)


@pytest.fixture(scope="module")
def paper_traces():
    """Each mode on the paper's workload, simulated by both packages."""
    out = {}
    with scripted_sim_clocks():
        for mode in MODES:
            ref = ref_core.simulate(_paper(ref_data), 200, ref_core.PAPER_COST_MODEL, mode=mode)
            port = simulate(_paper(port_data), 200, PAPER_COST_MODEL, mode=mode)
            out[mode] = port, ref
    return out


@pytest.mark.parametrize("mode", MODES)
def test_simulate_equals_the_reference_on_the_paper_workload(paper_traces, mode):
    port, ref = paper_traces[mode]
    assert len(port.requests) == 1319 and port.num_clients == 200
    assert_same_trace(port, ref)


# The reference's random invariant cases (tests/test_simulator.py:24 draws
# them with hypothesis; here numpy draws them from each case's seed), each
# simulated by both packages, some with oracle estimates or an explicit
# iteration policy.
POLICY_NAMES = (None, "balanced_lagrangian", "amortized", "decode_first",
                "utilization_weighted", "dynamic_batch")


def _random_case(case):
    rng = np.random.default_rng(case)
    n, j = int(rng.integers(2, 31)), int(rng.integers(1, 7))
    prefill = rng.integers(1, 200, size=n).tolist()
    decode = rng.integers(1, 60, size=n).tolist()
    mode = MODES[case % len(MODES)]
    return n, j, prefill, decode, mode, bool(case % 3 == 1), POLICY_NAMES[case % len(POLICY_NAMES)]


@pytest.mark.parametrize("case", range(24))
def test_simulate_equals_the_reference_on_random_cases(case):
    n, j, prefill, decode, mode, oracle, policy = _random_case(case)
    with scripted_sim_clocks():
        ref = ref_core.simulate(
            ref_core.make_requests(prefill, decode), j, ref_core.CostModel(**SMALL_CM),
            mode=mode, oracle_estimates=oracle,
            iteration_policy=policy and ref_core.make_policy(policy))
        reqs = make_requests(prefill, decode)
        tr = simulate(reqs, j, CostModel(**SMALL_CM), mode=mode, oracle_estimates=oracle,
                      iteration_policy=policy and port_core.make_policy(policy))
    assert_same_trace(tr, ref)
    # the reference's invariants, on the port's trace
    assert 0.0 < tr.utilization <= 1.0 and tr.makespan > 0
    assert all(r.t_done is not None and r.decoded == r.n_decode for r in tr.requests)
    assert tr.total_generated_tokens == sum(decode)
    cap = CostModel(**SMALL_CM).max_level.cap_tokens
    for s in tr.stages:
        if s.kind.value == "prefill" and len(s.busy) > 1:
            assert s.tokens <= cap


def test_paper_reproduction_bands(paper_traces):
    """The reference's check on the port: the four configurations land
    within ±3pp / ±8% of the paper's numbers and keep its ordering."""
    results = {m: (paper_traces[m][0].utilization * 100, paper_traces[m][0].makespan)
               for m in ("baseline", "offline", "online", "hybrid")}
    paper = {
        "baseline": (80.2, 201.0),
        "offline": (85.5, 197.08),
        "online": (86.19, 193.33),
        "hybrid": (89.06, 190.58),
    }
    for mode, (pu, pt) in paper.items():
        u, t = results[mode]
        assert abs(u - pu) < 3.0, f"{mode}: util {u:.2f} vs paper {pu}"
        assert abs(t - pt) / pt < 0.08, f"{mode}: time {t:.2f} vs paper {pt}"
    assert results["baseline"][0] < results["offline"][0]
    assert results["offline"][0] < results["online"][0] + 1.5
    assert results["online"][0] < results["hybrid"][0]
    assert results["hybrid"][1] < results["baseline"][1]


def test_decision_latency_budget(monkeypatch):
    """The reference's budget check, on a scripted clock: each decision
    reads the clock twice, so it lasts one 2**-10 s step; the check covers
    that every decision is timed and recorded, not the host's speed."""
    monkeypatch.setattr(port_sim_mod, "time", ScriptedClock())
    reqs = gsm8k_like_workload(seed=1, estimate_noise_std=PAPER_PREDICTOR_NOISE_STD)
    tr = simulate(reqs, 200, PAPER_COST_MODEL, mode="hybrid")
    assert set(tr.decision_times_ms) == {ScriptedClock.STEP * 1e3}
    assert max(tr.decision_times_ms) < 10.0
    assert sorted(tr.decision_times_ms)[len(tr.decision_times_ms) // 2] < 5.0


def test_gantt_renders():
    reqs = gsm8k_like_workload(
        WorkloadSpec(n_requests=20, output_max=32, output_mean=16, output_std=8,
                     input_mean=16, input_std=4),
        seed=0,
    )
    tr = simulate(reqs, 4, CostModel(**SMALL_CM), mode="hybrid")
    g = ascii_gantt(tr, width=40, max_clients=4)
    assert "makespan" in g and "#" in g
    csv = stage_csv(tr)
    assert csv.startswith("kind,")
    acct = client_accounting(tr)
    assert len(acct) == 4
    tl = utilization_timeline(tr, 10)
    assert len(tl) == 10 and all(0 <= u <= 1.001 for u in tl)


def test_oracle_estimates_copy_requests():
    reqs = gsm8k_like_workload(
        WorkloadSpec(n_requests=10, output_max=32, output_mean=16, output_std=8,
                     input_mean=16, input_std=4),
        seed=0,
    )
    before = [r.n_decode_est for r in reqs]
    simulate(reqs, 2, CostModel(**SMALL_CM), mode="hybrid", oracle_estimates=True)
    assert [r.n_decode_est for r in reqs] == before
    assert all(r.t_done is None for r in reqs)
