"""The readers of the engine's host spans on the CPU cell
(``hostspans.py``, ``metrics/*_share.backlog.py``): they read numbers, the
engine's phases and the harness's tile the window, and a program without
host spans leaves them silent and every other reader as it was."""
import sys

import pytest
import torch

from portbench import bench, hostspans, smoke_cell, yardstick
from portbench.devtrace import SubWindow
from portbench.weights import leaves

SEED = 2**31 + 11
SECONDS = 2.0
NEW = ("sched_share.backlog", "feed_share.backlog", "commit_share.backlog")


@pytest.fixture(scope="module", params=[False, True], ids=["trace0", "trace1"])
def driven(request):
    """A window of the dense smoke cell, traced or not, and what the host
    spans' readers read while its engine lives (as ``run_cell`` reads them,
    right after the window)."""
    cell = smoke_cell.cell(False)
    built = bench.build(cell, SEED, torch.device("cpu"))
    prof = cell.spec["profile"]
    sub = SubWindow(prof["start_s"], prof["seconds"], lambda: None) if request.param else None
    rec = bench.drive(built["engine"], cell, SEED, SECONDS, lambda: None, sub)
    numel = {p: x.numel() for p, x in leaves(built["weights"])}
    run = bench.Run(cell=cell, rec=rec, setup_s=0.0, flops=yardstick.flop_counts(cell.arch, numel))
    read = dict(
        values={name: bench.metric_reader(name)(run) for name in NEW},
        # a step begun at the window's end (the stamp before it crossed
        # the end) is the next window's: at most one
        mine={id(s) for s in built["engine"].host.since(0) if s.clock < run.end},
        count=built["engine"].host.count,
        phases=hostspans.phase_seconds(run.end), steps=hostspans.window_steps(run.end),
    )
    return run, read, request.param


def test_the_four_readers_read_shares_of_the_window(driven):
    _, read, _ = driven
    assert all(isinstance(v, float) and 0 < v < 100 for v in read["values"].values()), read
    steps, origin = read["steps"]
    assert read["count"] - 1 <= len(steps) <= read["count"] and origin is not None
    assert {id(s) for s in steps} == read["mine"]


def test_engine_and_harness_phases_tile_the_window(driven):
    """The engine's steps lie inside the harness's ``serve_step`` phase and
    their phases tile them; what the engine's and the harness's phases leave
    of the window is the harness's own work around each step (the clock
    moved, a ``record_function`` entered and left: well under half a
    millisecond a step; on the card's host ~0.1% of a window)."""
    run, read, traced = driven
    engine = sum(read["phases"].values())
    harness = run.rec.phases
    steps, origin = read["steps"]
    inside = sum(min(s.end, origin + run.end) - s.start for s in steps)
    assert engine == pytest.approx(inside, rel=1e-9)
    per_step = 5e-4 * len(steps)
    assert 0 <= harness["serve_step"] - inside <= per_step
    if not traced:
        # traced, the profiler's start and stop lie outside every phase too
        covered = engine + harness["plan"] + harness["stamp"]
        assert 0 <= run.end - covered <= per_step, (engine, harness)


def test_without_host_spans_the_new_readers_are_silent_and_the_others_unchanged(driven, monkeypatch):
    run, _, _ = driven
    others = [m["name"] for m in run.cell.per_layer if m["name"] not in NEW]
    before = {name: bench.metric_reader(name)(run) for name in others}
    for name in NEW:
        bench.metric_reader(name)(run)
    assert {name: bench.metric_reader(name)(run) for name in others} == before
    monkeypatch.setitem(sys.modules, "repro_torch.obs.host", None)
    assert all(bench.metric_reader(name)(run) is None for name in NEW)
    assert {name: bench.metric_reader(name)(run) for name in others} == before


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
def test_the_phase_tool_measures_a_cpu_window(traced):
    from portbench import phases

    out = phases.measure(smoke_cell.cell(False), SEED, 1.0, traced, torch.device("cpu"), 0.0)
    assert out["card"] == "cpu" and out["stages"] > 0
    assert ("profiler_s" in out) == traced
    assert set(out["shares"]) == {"sched", "feed", "launch", "commit", "wait", "host_share",
                                  "harness_plan_stamp"}
    assert sum(v["n"] for v in out["by_key"].values()) == out["stages"]
    assert 0 < out["recorder_us_per_step"] < 1e4


def test_a_second_engine_stepping_in_the_window_raises():
    """The readers read one engine: where two stepped in the window (a cell
    with replicas), they raise rather than read either."""
    from repro_torch.obs.host import HostSpans

    a, b = HostSpans(), HostSpans()
    for h, clock in ((a, 0.0), (b, 0.0), (a, 0.5), (b, 0.5)):
        h.begin(clock)
        h.end()
    with pytest.raises(RuntimeError, match="more than one engine"):
        hostspans.window_steps(1.0)
    del a
    steps, origin = hostspans.window_steps(1.0)
    assert [s.id for s in steps] == [0, 1] and origin is not None
