"""Readings for the limits, in one process on the card.

    python3 portbench/prove.py --workload sc2-gsm8k-backlog \\
        --seeds 11,12,13 --seconds 30 --control

Serves the cell once a seed (the weights drawn again in place for each
seed, a fresh engine over them, as a run builds it) and judges each serve as
a run does; with ``--control`` it also reads the fp8 control on the same
sequences and holds it to the cell's limits, put in the program's place.
One JSON line a seed. Exits non-zero where the program is not correct on a
seed, or where the control is. The benchmark's own runs run neither.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]
    import torch

    from portbench import bench, yardstick
    from portbench.weights import draw
    from repro_torch.serving.engine import Engine

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    sync = lambda: torch.cuda.synchronize(dev)  # noqa: E731
    cell = bench.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    built = bench.build(cell, seeds[0], dev)
    eng, weights = built.pop("engine"), built["weights"]
    print(json.dumps({"setup_s": time.perf_counter() - T_PROCESS, "card": bench.power_limit(),
                      "graphs": eng.graphs.stats()}), flush=True)
    failures = 0
    for i, seed in enumerate(seeds):
        draw(weights, cell.config["tree"], cell.arch, seed)
        if i:
            # a fresh engine over the same model and weights: a backlog run
            # abandons its open round, which leaves slots bound
            del eng
            gc.collect()
            torch.cuda.empty_cache()
            eng = Engine(built["model"], weights, bench.engine_config(cell.engine), device=dev)
            eng.warm_serving_shapes()
        t0 = time.perf_counter()
        rec = bench.drive(eng, cell, seed, args.seconds, sync)
        served_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        v = bench.judge(cell, rec, weights, seed, dev, control=args.control)
        reqs = list(rec.reqs.values())
        print(json.dumps({
            "seed": seed, "served_s": served_s, "judge_s": time.perf_counter() - t0,
            "sampled": v["sampled"], "served_checked": v.get("served_checked", 0),
            "readings": v["readings"], "checks": v["checks"], "correct": v["correct"],
            "control": v.get("control"), "control_checks": v.get("control_checks"),
            "control_correct": v.get("control_correct"),
            "output_tok_s": yardstick.output_tokens((r.stamps for r in reqs), rec.end) / rec.end,
            "window": bench.window_summary(rec), "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        }), flush=True)
        failures += (not v["correct"]) + bool(v.get("control_correct"))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
