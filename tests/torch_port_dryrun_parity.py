"""The port's full-size dry-run against the reference's compiled cells, on
every applicable cell of a production mesh.

    PYTHONPATH=src python tests/torch_port_dryrun_parity.py [--multi-pod]
        [--arch A ...] [--cell C ...] [--detail] [--json OUT]

The reference compiles each cell (``get_config``, one microbatch, Mixtral's
serve cells at FSDP weights, its ``plan_for(..., multi_pod)`` sharding) on
the 16 x 16 (``("data", "model")``) or 2 x 16 x 16 (``("pod", "data",
"model")``) mesh of fake XLA devices, in subprocesses started first
(``torch_port_dryrun.REF_SCRIPT``, a few archs each); the port traces the
same cells on a fake world of 256 or 512 ranks (``trace_cells``, xLSTM's
long cells bounded). Each cell is held to ``full_size_verdict``'s bar with
``FULL_SIZE_GAPS`` (``test_torch_dryrun_full.py``): one row a cell — the
difference in argument bytes, the port's dot FLOPs and collective elements
over the reference's, the verdict and the port's trace seconds. Exits 1 on
a cell that breaks the bar. ``--detail`` prints, under each cell, the
reference's largest dots by ``op_name`` and collectives by shape beside the
port's registered FLOPs by operation.

It lives beside the tests because it drives the JAX package: no module of
``repro_torch`` imports it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from torch_port_dryrun import (  # noqa: E402
    full_cells_for,
    full_size_verdict,
    reference_results,
    start_reference,
    trace_cells,
)

#: the archs a reference subprocess compiles (each within REF_BUDGET_S)
REF_GROUPS = (("mixtral_8x22b", "olmoe_1b_7b", "qwen3_8b"),
              ("starcoder2_7b", "granite_3_8b", "nemotron_4_15b"),
              ("qwen2_vl_7b", "xlstm_350m", "recurrentgemma_9b", "whisper_small"))
CELL_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _detail(port: dict, ref: dict, top: int = 8) -> None:
    for op, f in sorted(ref["dot_flops_by_op"].items(), key=lambda kv: -kv[1])[:top]:
        print(f"      reference {f:11.4g}  {op[-110:]}")
    for shape, n in sorted(ref["collective_shapes"].items(), key=lambda kv: -kv[1])[:top]:
        print(f"      reference x{n:<6g} {shape}")
    for op, f in sorted(port["cost"]["registered_by_op"].items(), key=lambda kv: -kv[1])[:top]:
        print(f"      port      {f:11.4g}  {op}")
    for kind, c in port["collectives"].items():
        if c["count"]:
            print(f"      port      x{c['count']:<6g} {kind}: {c['elements']:.4g} elements")


def main() -> int:
    from test_torch_dryrun_full import FULL_SIZE_GAPS

    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch.mesh import fake_world, make_production_mesh

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--multi-pod", action="store_true", help="2 x 16 x 16 (default 16 x 16)")
    ap.add_argument("--arch", nargs="*", default=ARCH_IDS)
    ap.add_argument("--cell", nargs="*", default=CELL_NAMES)
    ap.add_argument("--detail", action="store_true")
    ap.add_argument("--json", help="write every cell's records and verdict here")
    args = ap.parse_args()

    shape = (2, 16, 16) if args.multi_pod else (16, 16)
    mesh_id = "x".join(map(str, shape))
    t0 = time.time()
    groups = [[a for a in g if a in args.arch] for g in REF_GROUPS]
    cells = {a: full_cells_for([a], args.cell, fsdp_at_serve=("mixtral_8x22b",)) for a in args.arch}
    procs = [start_reference([c for a in g for c in cells[a]], shape, full=True, detail=args.detail)
             for g in groups if g]
    fake_world(shape[0] * shape[1] * (shape[2] if len(shape) > 2 else 1))
    mesh = make_production_mesh(multi_pod=args.multi_pod, device="cpu")
    port = {}
    for a in args.arch:
        for cell in cells[a]:
            port.update(trace_cells([cell], mesh, full=True))
    ref = {}
    for proc in procs:
        ref.update(reference_results(proc, budget=3600))

    print(f"| mesh | cell | argument bytes, port - reference | dot FLOPs, port / reference "
          f"| collective elements, port / reference | verdict | port trace s |")
    print("|---|---|---|---|---|---|---|")
    failed, out = 0, {}
    for key, p in port.items():
        arch, name = key.split("/")
        gap = FULL_SIZE_GAPS.get((mesh_id, arch, name))
        v = full_size_verdict(p, ref[key], gap)
        verdict = "FAIL: " + "; ".join(v["problems"]) if v["problems"] else (
            "gap (recorded)" if gap else "ok")
        failed += bool(v["problems"])
        print(f"| {mesh_id} | {key} | {v['arg_diff']} | {v['flops']:.4f} | {v['elements']:.4f} "
              f"| {verdict} | {p['trace_s']} |", flush=True)
        if args.detail:
            _detail(p, ref[key])
        out[key] = {"port": p, "reference": ref[key], "verdict": v}
    print(f"{len(port)} cells on {mesh_id}, {failed} breaking the bar, {time.time() - t0:.1f} s")
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
