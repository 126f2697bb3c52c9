"""The paper's experiment layer on the port, against the reference: every
row of ``repro_torch.launch.paper_tables`` has the ``derived`` column of
``benchmarks/paper_tables.py``'s row (the hundred-case studies at
``n_cases=5``; both simulators time their decisions on a scripted clock, so
even the decision-latency row compares exactly; ``us_per_call`` is wall
time and is not compared), ``examples/torch_quickstart.py`` and
``torch_policy_lab.py`` print what ``quickstart.py`` and ``policy_lab.py``
print, and ``torch_offline_rlhf.py`` prints the simulated part of
``offline_rlhf.py`` (its solver's milliseconds aside) before it trains the
port's model. The two serving examples run on the CPU and print their
modes. Every example runs once, as a script in a subprocess whose working
directory is a temporary one, with ``--device cpu`` where it takes a
device; all of the module's scripts run at once."""
import json
import re

import pytest

from torch_port_jobs import ROOT, Job, run_all

BENCHES = (
    "bench_baseline", "bench_offline", "bench_online_only", "bench_hybrid",
    "bench_lower_bound", "bench_hundred_cases", "bench_decision_latency", "bench_mip_toy",
    "bench_offline_solver", "bench_beyond_paper_policies", "bench_beyond_hundred_cases",
)
# each package's benches in three jobs of similar length
BENCH_GROUPS = (
    BENCHES[:5] + ("bench_decision_latency", "bench_mip_toy", "bench_offline_solver"),
    ("bench_hundred_cases", "bench_beyond_hundred_cases"),
    ("bench_beyond_paper_policies",),
)
N_CASES = 5
TABLES_JOB = """
import json, sys
pkg, names = sys.argv[1], sys.argv[2].split(",")
if pkg == "repro":
    import repro.core.simulator as sim
    from benchmarks import paper_tables as pt
else:
    import repro_torch.core.simulator as sim
    from repro_torch.launch import paper_tables as pt

class Clock:                     # torch_port_arrays.ScriptedClock, without torch
    calls = 0
    def perf_counter(self):
        self.calls += 1
        return self.calls * 2.0 ** -10

sim.time = Clock()
rows = {n: getattr(pt, n)(**({"n_cases": %d} if "hundred" in n else {})) for n in names}
print(json.dumps(rows))
""" % N_CASES
SIM_EXAMPLES = ("quickstart", "policy_lab", "offline_rlhf")
DEVICE_EXAMPLES = ("offline_rlhf", "serve_engine", "serve_fleet")
TIMEOUT_S = 600


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cwd = tmp_path_factory.mktemp("paper_tables")
    argvs = {}
    for name in SIM_EXAMPLES:
        argvs[f"ref-{name}"] = [ROOT / "examples" / f"{name}.py"]
    for name in ("quickstart", "policy_lab") + DEVICE_EXAMPLES:
        argv = [ROOT / "examples" / f"torch_{name}.py"]
        if name in DEVICE_EXAMPLES:
            argv += ["--device", "cpu"]
        if name == "serve_engine":
            argv += ["--trace", cwd / "serve_engine.trace.json"]
        argvs[f"port-{name}"] = argv
    for pkg in ("repro", "repro_torch"):
        for i, group in enumerate(BENCH_GROUPS):
            argvs[f"{pkg}-tables-{i}"] = ["-c", TABLES_JOB, pkg, ",".join(group)]
    jobs = [Job(name, argv, cwd) for name, argv in argvs.items()]
    out = run_all(jobs, TIMEOUT_S)
    for name, (rc, _, err) in out.items():
        assert rc == 0, f"{name} exited {rc}:\n{err[-3000:]}"
    return cwd, out


def _rows(runs, pkg):
    _, out = runs
    rows = {}
    for i in range(len(BENCH_GROUPS)):
        rows.update(json.loads(out[f"{pkg}-tables-{i}"][1]))
    return rows


@pytest.mark.parametrize("bench", BENCHES)
def test_paper_table_rows_equal_the_reference(runs, bench):
    port, ref = _rows(runs, "repro_torch")[bench], _rows(runs, "repro")[bench]
    assert [(name, derived) for name, _, derived in port] == [
        (name, derived) for name, _, derived in ref]
    assert all(us >= 0 for _, us, _ in port)


def test_paper_tables_main_prints_every_row(capsys, monkeypatch):
    """``main()`` prints the CSV header and a line a row, and a bench that
    raises as a FAILED line and exit code 1 (the benches stubbed: the
    module's jobs ran the real ones)."""
    from repro_torch.launch import paper_tables

    def broken():
        raise RuntimeError("boom")

    stubs = [lambda i=i: [(f"row{i}", 1.0, f"derived {i}")] for i in range(2)]
    monkeypatch.setattr(paper_tables, "ALL_BENCHES", stubs)
    assert paper_tables.main([]) == 0
    assert capsys.readouterr().out.splitlines() == [
        "name,us_per_call,derived", 'row0,1.0,"derived 0"', 'row1,1.0,"derived 1"']
    monkeypatch.setattr(paper_tables, "ALL_BENCHES", stubs + [broken])
    assert paper_tables.main([]) == 1
    assert capsys.readouterr().out.splitlines()[-1] == 'broken,-1,"FAILED: RuntimeError: boom"'


@pytest.mark.parametrize("name", ("quickstart", "policy_lab"))
def test_example_prints_what_its_reference_prints(runs, name):
    _, out = runs
    port, ref = out[f"port-{name}"][1], out[f"ref-{name}"][1]
    assert port == ref
    modes = ("baseline", "offline", "online", "hybrid") if name == "quickstart" else (
        "prefill_first", "lagrangian(paper)", "balanced(ours)", "amortized(ours)",
        "util_weighted", "dynamic_batch")
    for mode in modes:
        assert re.search(rf"^\s*{re.escape(mode)}\s+util=", port, re.M), mode


def test_offline_rlhf_example_plans_as_its_reference_and_trains(runs):
    _, out = runs
    port, ref = out["port-offline_rlhf"][1].splitlines(), out["ref-offline_rlhf"][1].splitlines()
    assert len(port) == len(ref) == 4
    wall = re.compile(r", \d+ ms with ")
    assert wall.sub(", _ ms with ", port[0]) == wall.sub(", _ ms with ", ref[0])
    assert port[1:3] == ref[1:3]
    m = re.fullmatch(r"policy-model training: loss (\S+) → (\S+) over 40 steps "
                     r"\(checkpointed every 10\)", port[3])
    assert m and float(m[2]) < float(m[1]) - 1.0, port[3]


def test_serve_engine_example(runs):
    cwd, out = runs
    text = out["port-serve_engine"][1]
    for mode in ("baseline", "hybrid", "hybrid-paged-alt", "hybrid-paged"):
        assert re.search(rf"^{re.escape(mode)}\s+util=", text, re.M), mode
    assert "token streams identical across cache off/on: True" in text
    trace = json.loads((cwd / "serve_engine.trace.json").read_text())
    assert trace["traceEvents"]
    assert f"wrote {cwd / 'serve_engine.trace.json'} ({len(trace['traceEvents'])} events" in text


def test_serve_fleet_example(runs):
    _, out = runs
    text = out["port-serve_fleet"][1]
    for mode in ("round_robin", "lpt", "lpt/no-steal", "hetero lpt", "blind lpt"):
        assert re.search(rf"^{re.escape(mode)}\s+makespan=", text, re.M), mode
    assert "completed=12/12 exactly-once=True" in text
    assert "streams bit-identical to no-fault=True" in text
