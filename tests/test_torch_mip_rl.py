"""Port parity of the paper's original MIP (Eqs. 1–25, ``core/mip.py``) and
the Q-learning iteration policy (``core/rl_policy.py``), both verbatim
copies of the reference's: the same toy instances give the reference's
objective and solution, as a MIP and relaxed, and the same re-costed hybrid
schedule; the same seed and episodes train a Q-table equal to the
reference's bit for bit, which then takes the same decisions. Then the
reference's own checks (``tests/test_misc.py:28,40``,
``tests/test_rl_policy.py``, ``tests/test_beyond_paper.py``) on the port;
the long-prompt case's three paper-scale simulations run in a subprocess
while the rest of the module runs."""
import dataclasses
import functools
import json

import numpy as np
import pytest

import repro_torch.core as port_core
from repro import core as ref_core
from repro import data as ref_data
from repro.core import rl_policy as ref_rl
from repro_torch import data as port_data
from repro_torch.core import (
    PAPER_COST_MODEL,
    AmortizedPolicy,
    BalancedLagrangianPolicy,
    LagrangianPolicy,
    recost_trace_mip_semantics,
    simulate,
    toy_instance,
)
from repro_torch.core.rl_policy import RLPolicy, train_rl_policy
from repro_torch.data import PAPER_PREDICTOR_NOISE_STD, PAPER_WORKLOAD_SPEC, gsm8k_like_workload
from torch_port_jobs import Job, run_all

SOLUTION_ARRAYS = ("x", "p", "d", "w", "y")
# tests/test_beyond_paper.py's long-prompt case, on the port: three
# paper-scale simulations, run in a subprocess beside this module's tests
STARVATION_JOB = """
import dataclasses, json
from repro_torch.core import (PAPER_COST_MODEL, BalancedLagrangianPolicy, LagrangianPolicy,
                              PrefillFirstPolicy, simulate)
from repro_torch.data import PAPER_PREDICTOR_NOISE_STD, PAPER_WORKLOAD_SPEC, gsm8k_like_workload
spec = dataclasses.replace(PAPER_WORKLOAD_SPEC, input_mean=400.0, input_std=120.0)
out = {}
for name, pol in (("paper", LagrangianPolicy), ("ours", BalancedLagrangianPolicy),
                  ("base", PrefillFirstPolicy)):
    reqs = gsm8k_like_workload(spec, seed=0, estimate_noise_std=PAPER_PREDICTOR_NOISE_STD)
    tr = simulate(reqs, 200, PAPER_COST_MODEL, mode="hybrid", iteration_policy=pol())
    out[name] = [tr.utilization, tr.makespan]
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def starvation_job(tmp_path_factory):
    job = Job("starvation", ["-c", STARVATION_JOB], tmp_path_factory.mktemp("starvation"))
    yield job
    job.stop()


@functools.lru_cache(maxsize=None)
def _solved(pkg, seed, relax):
    """The toy instance of ``seed`` and its solution, by package."""
    core = ref_core if pkg == "repro" else port_core
    m = core.OriginalMIP(*core.toy_instance(seed=seed))
    return m, m.solve(time_limit_s=60, relax=relax)


@pytest.mark.parametrize("relax", [False, True], ids=["mip", "lp"])
@pytest.mark.parametrize("seed", [0, 1])
def test_original_mip_equals_the_reference(seed, relax):
    (port, sol), (ref, ref_sol) = _solved("repro_torch", seed, relax), _solved("repro", seed, relax)
    assert (port.I, port.J, port.K, port.L, port.n_var) == (ref.I, ref.J, ref.K, ref.L, ref.n_var)
    assert sol.status == ref_sol.status
    assert sol.objective == ref_sol.objective and sol.mip_gap == ref_sol.mip_gap
    for name in SOLUTION_ARRAYS:
        np.testing.assert_array_equal(getattr(sol, name), getattr(ref_sol, name), err_msg=name)
    assert sol.stage_times.keys() == ref_sol.stage_times.keys()
    for k in sol.stage_times:
        np.testing.assert_array_equal(sol.stage_times[k], ref_sol.stage_times[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_recost_equals_the_reference(seed):
    reqs, j, _, cm = toy_instance(seed=seed)
    ref_reqs, ref_j, _, ref_cm = ref_core.toy_instance(seed=seed)
    tr = simulate(reqs, j, cm, mode="hybrid", oracle_estimates=True)
    ref_tr = ref_core.simulate(ref_reqs, ref_j, ref_cm, mode="hybrid", oracle_estimates=True)
    assert recost_trace_mip_semantics(tr, cm, j) == ref_core.recost_trace_mip_semantics(
        ref_tr, ref_cm, ref_j)


def test_mip_toy_optimal_and_feasible():
    reqs, J, K, cm = toy_instance(seed=0)
    m, sol = _solved("repro_torch", 0, False)
    assert sol.status == "optimal"
    m.check_solution(sol)
    tr = simulate(reqs, J, cm, mode="hybrid", oracle_estimates=True)
    hyb = recost_trace_mip_semantics(tr, cm, J)
    assert hyb >= sol.objective - 1e-9          # MIP is a valid lower bound
    assert hyb <= sol.objective * 1.25          # heuristic near-optimal


def test_mip_lp_relaxation_bounds_mip():
    _, sol = _solved("repro_torch", 1, False)
    _, rel = _solved("repro_torch", 1, True)
    assert rel.objective <= sol.objective + 1e-9


# ------------------------------------------------------------------ RL -- #
def _rl_workload(pkg_data, seed):
    spec = dataclasses.replace(pkg_data.PAPER_WORKLOAD_SPEC, n_requests=200)
    return pkg_data.gsm8k_like_workload(
        spec, seed=seed, estimate_noise_std=pkg_data.PAPER_PREDICTOR_NOISE_STD)


@pytest.fixture(scope="module")
def trained():
    """``tests/test_rl_policy.py``'s training run (12 episodes, 50 clients),
    in both packages."""
    port = train_rl_policy(lambda ep: _rl_workload(port_data, 2000 + ep), 50,
                           PAPER_COST_MODEL, episodes=12)
    ref = ref_rl.train_rl_policy(lambda ep: _rl_workload(ref_data, 2000 + ep), 50,
                                 ref_core.PAPER_COST_MODEL, episodes=12)
    return port, ref


def test_rl_q_table_equals_the_reference(trained):
    port, ref = trained
    assert port.q.dtype == ref.q.dtype and port.q.shape == ref.q.shape
    assert port.q.tobytes() == ref.q.tobytes()
    assert (port.epsilon, port.name) == (ref.epsilon, ref.name)


def test_rl_policy_decides_as_the_reference(trained):
    port, ref = trained
    tr = simulate(_rl_workload(port_data, 0), 50, PAPER_COST_MODEL, mode="hybrid",
                  iteration_policy=port)
    ref_tr = ref_core.simulate(_rl_workload(ref_data, 0), 50, ref_core.PAPER_COST_MODEL,
                               mode="hybrid", iteration_policy=ref)
    assert [(s.kind.value, s.t_start, s.t_end, s.busy, s.tokens) for s in tr.stages] == [
        (s.kind.value, s.t_start, s.t_end, s.busy, s.tokens) for s in ref_tr.stages]
    assert tr.utilization == ref_tr.utilization and tr.makespan == ref_tr.makespan


def test_rl_policy_trains_and_beats_untrained(trained):
    port, _ = trained
    assert np.abs(port.q).sum() > 0
    reqs = _rl_workload(port_data, 0)
    tr_trained = simulate(reqs, 50, PAPER_COST_MODEL, mode="hybrid", iteration_policy=port)
    tr_zero = simulate(reqs, 50, PAPER_COST_MODEL, mode="hybrid", iteration_policy=RLPolicy())
    assert tr_trained.utilization >= tr_zero.utilization - 0.02
    assert tr_trained.utilization > 0.5


# ---------------------------------------------------- beyond the paper -- #
def _run(spec, pol, seed=0):
    reqs = gsm8k_like_workload(spec, seed=seed, estimate_noise_std=PAPER_PREDICTOR_NOISE_STD)
    return simulate(reqs, 200, PAPER_COST_MODEL, mode="hybrid", iteration_policy=pol)


def test_balanced_equals_paper_on_gsm8k():
    a = _run(PAPER_WORKLOAD_SPEC, LagrangianPolicy())
    b = _run(PAPER_WORKLOAD_SPEC, BalancedLagrangianPolicy())
    assert abs(a.makespan - b.makespan) < 0.5
    assert abs(a.utilization - b.utilization) < 0.005


def test_balanced_fixes_long_prompt_starvation(starvation_job):
    (rc, out, err), = run_all([starvation_job], 300).values()
    assert rc == 0, err[-3000:]
    (paper_u, paper_t), (ours_u, ours_t), (base_u, _) = json.loads(out).values()
    assert paper_u < base_u - 0.15                       # the failure mode
    assert ours_u > base_u                               # fixed, and better
    assert ours_t < paper_t * 0.70


def test_amortized_beats_paper_on_its_own_benchmark():
    paper = _run(PAPER_WORKLOAD_SPEC, LagrangianPolicy())
    ours = _run(PAPER_WORKLOAD_SPEC, AmortizedPolicy())
    assert ours.utilization > paper.utilization
    assert ours.makespan < paper.makespan
