"""Run one cell of the benchmark on the CUDA device.

    python3 portbench/run.py --workload sc2-gsm8k-backlog --seed 7 \\
        --seconds 30 --trace 0

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks`` (each number the check compared, with
its limit; the same lines end standard error). Exits non-zero and prints no
result where there is no CUDA device or fewer than the cell asks for, where
the program under test is missing, or where a module of JAX or of the JAX
package is loaded once the window has closed.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]
    from portbench.bench import forbidden_modules, load_cell, run_cell

    cell = load_cell(args.workload)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), T_PROCESS)
    if out is None:
        return 2
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
