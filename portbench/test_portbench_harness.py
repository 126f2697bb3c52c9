"""The harness's contract on the CPU: traffic by seed, discovery by file
name, the shape of BENCHMARK.json, the result line's schema, what a run
imports, and no result without a card."""
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import bench, generate, smoke_cell

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "portbench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("mix", ["gsm8k_backlog"])
def test_traffic_is_fixed_by_the_seed(mix):
    m = json.loads((HERE / "traffic" / f"{mix}.json").read_text())
    a, b, c = (generate.requests(m, s, rnd=1) for s in (2**31 + 17, 2**31 + 17, 2**31 + 18))
    assert a == b and a != c
    assert all(0 <= r["rid"] < 2**31 for r in a + c)
    strip = lambda reqs: [{k: v for k, v in r.items() if k != "rid"} for r in reqs]  # noqa: E731
    # the mix's order_seed fixes the work: another run seed serves the same
    # sizes and estimates in the same order, under other request ids
    assert strip(a) == strip(c)
    # another round serves the same sizes in another order
    d = generate.requests(m, 2**31 + 17, rnd=2)
    for key in ("n_prefill", "n_decode"):
        assert sorted(r[key] for r in a) == sorted(r[key] for r in d)
        assert [r[key] for r in a] != [r[key] for r in d]


def test_a_mix_states_its_order_seed():
    m = json.loads((HERE / "traffic" / "gsm8k_backlog.json").read_text())
    with pytest.raises(KeyError):
        generate.requests({k: v for k, v in m.items() if k != "order_seed"}, 5)


def test_gsm8k_rounds_keep_the_papers_moments():
    m = json.loads((HERE / "traffic" / "gsm8k_backlog.json").read_text())
    reqs = generate.requests(m, 5, rnd=0)
    p = sum(r["n_prefill"] for r in reqs) / len(reqs)
    d = sum(r["n_decode"] for r in reqs) / len(reqs)
    assert len(reqs) == 660 and abs(p - 68.43) < 0.5 and abs(d - 344.83) < 1.5


def test_every_name_finds_its_file():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(bench.metric_reader(m["name"])), m["name"]
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert (HERE / cfg["reference"]).exists()
    for w in SPEC["workloads"]:
        cell = bench.load_cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer, w["name"]
        assert len(cell.spec["check"]["limits"]) == 1
        assert set(cell.spec["check"]["limits"]) <= {"logit_gap_max", "logit_gap_mean", "mismatch_share"}


def test_benchmark_json_keeps_the_contracts_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"] and SPEC["paths"] == ["portbench"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in SPEC[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and all(w in e2e[m["moves"]].get("workloads", [w]) for w in m["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs) and all(w["chips"] == 1 for w in SPEC["workloads"])


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
def test_the_result_line_has_the_contracts_keys(traced):
    out = bench.run_cell(smoke_cell.cell(False), 2**31 + 3, 1.5, traced, 0.0,
                         device="cpu", require_chip=False)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    cell = smoke_cell.cell(False)
    want = {m["name"] for m in (cell.per_layer if traced else cell.end_to_end)}
    # a CPU run has no device trace: those metrics are left out, never 0
    device_only = {"k1_roofline.backlog", "device_idle.backlog"}
    always = {"slot_util.backlog", "host_share.backlog", "mfu.backlog"} if traced else want
    assert always <= set(out["metrics"]) <= want - device_only
    for m in out["metrics"].values():
        assert isinstance(m["value"], float) and m["unit"]
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(out))


def _modules_after(code: str):
    res = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": f"{ROOT}:{ROOT / 'src'}"})
    assert res.returncode == 0, res.stderr[-2000:]
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


def test_harness_traffic_and_readers_load_no_jax_and_no_jax_package():
    found = _modules_after(
        "from portbench import bench, generate, yardstick, devtrace, weights\n"
        "for m in bench.load_json(bench.ROOT.parent / 'BENCHMARK.json')['per_layer']:\n"
        "    bench.metric_reader(m['name'])\n"
        "import portbench.smoke_cell as s, torch\n"
        "bench.run_cell(s.cell(True), 9, 1.0, False, 0.0, device='cpu', require_chip=False)")
    assert not found & {"jax", "jaxlib", "flax", "repro"}


def test_a_run_names_forbidden_modules_by_whole_top_level_name():
    found = _modules_after(
        "import sys, types\n"
        "sys.modules['jax.numpy'] = types.ModuleType('jax.numpy')\n"
        "sys.modules['repro_torch_extra'] = types.ModuleType('repro_torch_extra')\n"
        "from portbench import bench\n"
        "assert bench.forbidden_modules() == ['jax'], bench.forbidden_modules()")
    assert "repro" not in found


def test_reference_loads_nothing_of_the_program():
    found = _modules_after("import portbench.reference.decoder")
    assert not found & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_no_card_no_result(tmp_path):
    """Without a CUDA device, and in a directory holding only BENCHMARK.json
    and the benchmark's files, a run exits non-zero and prints no result."""
    bare = tmp_path / "bare"
    bare.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", bare)
    shutil.copytree(HERE, bare / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    for where in (ROOT, bare):
        res = subprocess.run([sys.executable, "portbench/run.py", "--workload", "sc2-gsm8k-backlog",
                              "--seed", "1", "--seconds", "1", "--trace", "0"],
                             cwd=where, capture_output=True, text=True, timeout=120)
        assert res.returncode != 0 and "{" not in res.stdout


def test_the_check_scores_at_most_its_cap_of_a_request():
    idx = bench.scored(512, 64)
    assert len(set(idx.tolist())) == 64 and idx[0] == 0 and idx[-1] == 511
    assert list(idx) == sorted(idx)
    assert bench.scored(10, 64).tolist() == list(range(10))


def test_the_sample_spreads_over_many_requests():
    """About 1,000 scored tokens, at most 64 a request, come from a dozen
    requests or more: the longest first, then others drawn from the seed,
    finished requests only."""
    rec = bench.Records(end=1.0)
    for i in range(100):
        n = 512 if i % 2 else 40
        rec.reqs[i] = bench.Req(i, 50, n, 0.0)
        rec.served[i] = list(range(n))
    rec.reqs[100] = bench.Req(100, 50, 600, 0.0)
    rec.served[100] = list(range(10))                # unfinished
    picked = bench.sample(rec, 5, 1000, 32, 64)
    assert picked[0].n_decode == 512 and 100 not in {r.rid for r in picked}
    assert sum(min(r.n_decode, 64) for r in picked) >= 1000 and len(picked) >= 16
    assert [r.rid for r in bench.sample(rec, 5, 1000, 32, 64)] == [r.rid for r in picked]
    assert [r.rid for r in bench.sample(rec, 6, 1000, 32, 64)] != [r.rid for r in picked]
    assert len(bench.sample(rec, 5, 10**6, 32, 64)) == 32
