"""Where the engine's host time goes in one window of a cell, on the card.

    python3 portbench/phases.py --workload sc2-gsm8k-backlog --seed 7 \\
        --seconds 50 --trace 0

Drives the cell's window as ``run.py`` does (the same build and ``drive``;
no correctness check) and prints one JSON line: the harness's phases and the
engine's (``Engine.host`` spans clipped to the window), the shares the
benchmark's ``*_share.backlog`` readers report beside ``host_share`` (and
those of ``engine.launch`` and ``engine.wait``), each
dispatch key's mean ``engine.launch`` and ``engine.wait`` in ms (with
``--trace 1`` split into the steps the profiler recorded and the rest, the
traced second's idle gaps and the seconds the profiler's start and stop
took), and what the recorder costs a step with no profiler running
(``HostSpans`` timed alone on this host).
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]


def recorder_us(n: int = 20000) -> float:
    """Microseconds a step of a fresh recorder costs: one step with every
    phase, tagged, as ``serve_step`` records it."""
    from repro_torch.obs.host import PHASES, HostSpans

    spans = HostSpans()
    t0 = time.perf_counter()
    for _ in range(n):
        spans.begin(0.0)
        for name in PHASES[1:]:
            spans.enter(name)
        spans.tag("decode", (1,))
        spans.end()
    return (time.perf_counter() - t0) / n * 1e6


def by_key(steps):
    """{kind:shape: launch and wait ms (mean, median), count}."""
    out = {}
    for s in steps:
        ph = {p.name: p.end - p.start for p in s.phases[-3:]}
        out.setdefault(f"{s.kind}:{'x'.join(map(str, s.shape))}", []).append(
            (ph["engine.launch"] * 1e3, ph["engine.wait"] * 1e3))
    return {k: dict(n=len(v), launch_mean_ms=statistics.fmean(a for a, _ in v),
                    launch_median_ms=statistics.median(a for a, _ in v),
                    wait_mean_ms=statistics.fmean(b for _, b in v))
            for k, v in sorted(out.items())}


def measure(cell, seed: int, seconds: float, traced: bool, device, t_process: float):
    """One window of ``cell`` on ``device``; returns the result line's object."""
    import torch

    from portbench import bench, hostspans, yardstick
    from portbench.devtrace import SubWindow

    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    eng = bench.build(cell, seed, device)["engine"]
    sync()
    prof = cell.spec["profile"]
    sub = SubWindow(prof["start_s"], prof["seconds"], sync) if traced else None
    profiler_s = {}
    if sub is not None:
        sub.warm()
        # the profiler's start and stop run between steps, outside every phase
        for name in ("_begin", "_end"):
            def timed(step, f=getattr(sub, name), name=name):
                t = time.perf_counter()
                f(step)
                profiler_s[name.strip("_")] = time.perf_counter() - t
            setattr(sub, name, timed)
    setup_s = time.perf_counter() - t_process
    rec = bench.drive(eng, cell, seed, seconds, sync, sub)
    end = rec.end
    phases = hostspans.phase_seconds(end)
    steps, _ = hostspans.window_steps(end)
    staged = [s for s in steps if s.kind is not None]
    out = {
        "workload": cell.name, "seed": seed, "trace": int(traced),
        "card": bench.power_limit() if cuda else "cpu",
        "setup_s": setup_s, "steps": len(steps), "stages": len(staged),
        "output_tok_s": yardstick.output_tokens((r.stamps for r in rec.reqs.values()), end) / end,
        "harness_phases_s": rec.phases, "engine_phases_s": phases,
        "shares": {"sched": hostspans.share(end, hostspans.SCHED),
                   "feed": hostspans.share(end, hostspans.FEED),
                   "launch": hostspans.share(end, ("engine.launch",)),
                   "commit": hostspans.share(end, hostspans.COMMIT),
                   "wait": hostspans.share(end, ("engine.wait",)),
                   "host_share": 100 * yardstick.host_share(rec.stages, end),
                   "harness_plan_stamp": 100 * (rec.phases.get("plan", 0.0)
                                                + rec.phases.get("stamp", 0.0)) / end},
        "recorder_us_per_step": recorder_us(),
    }
    if traced:
        out["profiler_s"] = profiler_s
    if traced and rec.trace is not None:
        first, last = rec.trace.first_step, rec.trace.last_step
        out["by_key_profiled"] = by_key(staged[first:last])
        out["by_key_unprofiled"] = by_key(staged[:first] + staged[last:])
        out["busy_s"], out["window_s"] = rec.trace.busy_s, rec.trace.window_s
        out["idle_gaps"] = [[n[:120], s] for n, s in rec.trace.gaps[:16]]
    else:
        out["by_key"] = by_key(staged)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]
    import torch

    from portbench import bench

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    out = measure(bench.load_cell(args.workload), args.seed, args.seconds, bool(args.trace),
                  torch.device("cuda"), T_PROCESS)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
