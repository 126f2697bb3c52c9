"""Roofline analysis from the port's dry-run records (counterpart of
``repro.launch.roofline``, the reference's algebra with the H100's
constants).

Reads ``experiments/dryrun_torch/*.json`` (written by
``repro_torch.launch.dryrun``) and derives the three per-step roofline terms
for an NVIDIA H100 80GB HBM3 (SXM, 700 W; spec-sheet figures,
``launch.mesh``):

    compute    = traced_FLOPs_per_chip / 989 TF/s (dense bf16)
    memory     = HBM_bytes_per_chip / 3.35 TB/s
    collective = collective_bytes_per_chip / 50 GB/s (one 400 Gb/s NDR
                 port a GPU: the production meshes' collectives cross nodes)

The FLOPs and collective bytes are ``trace_analysis``'s per-device totals
(rank 0's program of the traced step). HBM bytes use the reference's
lower-bound traffic model, (argument_bytes + temp_bytes + output_bytes -
alias_bytes) per step: the step's working set, read or written once. These
are predictions for an H100 mesh computed on the CPU, not measurements.

MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) for training;
2·N[_active]·D for single forward passes (prefill/decode), per chip.
"""
from __future__ import annotations

import argparse
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

from ..configs import SHAPES_BY_NAME, get_config
from .mesh import HBM_BW, ICI_BW_PER_LINK, PEAK_FLOPS_BF16
from .plan import WHISPER_DECODER_PROMPT

RESULTS_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_per_chip: float
    hlo_flops_per_chip: float
    fit_gb: float
    tag: str = ""

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / traced FLOPs — how much of the step's compute is useful."""
        if self.hlo_flops_per_chip <= 0:
            return 0.0
        return self.model_flops_per_chip / self.hlo_flops_per_chip

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU bound: useful FLOPs / (bound time × peak)."""
        if self.bound_s <= 0:
            return 0.0
        return self.model_flops_per_chip / (self.bound_s * PEAK_FLOPS_BF16)


def model_flops_per_chip(arch: str, shape: str, chips: int) -> float:
    """Analytic useful FLOPs per chip for one step of the cell."""
    cfg = get_config(arch)
    cell = SHAPES_BY_NAME[shape]
    n_active = cfg.active_param_count()
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        total = 6.0 * n_active * tokens
    elif cell.kind == "prefill":
        if cfg.family == "audio":
            # encoder processes seq_len frames; decoder prompt is small
            tokens = cell.global_batch * (cell.seq_len + WHISPER_DECODER_PROMPT)
            total = 2.0 * n_active * tokens  # enc+dec share the 2·N·D model
        else:
            tokens = cell.global_batch * cell.seq_len
            total = 2.0 * n_active * tokens
    else:  # decode: one token per sequence
        tokens = cell.global_batch
        total = 2.0 * n_active * tokens
    return total / chips


def load_results(results_dir: Path = RESULTS_DIR) -> List[dict]:
    out = []
    for p in sorted(results_dir.glob("*.json")):
        try:
            out.append(json.loads(p.read_text()))
        except json.JSONDecodeError:
            continue
    return out


def roofline_for(result: dict) -> Optional[Roofline]:
    if result.get("status") != "ok":
        return None
    chips = result["chips"]
    mem = result["memory"]
    # donated outputs alias argument buffers — count them once
    hbm_bytes = (
        mem["argument_bytes"]
        + mem["temp_bytes"]
        + max(0, mem["output_bytes"] - mem["alias_bytes"])
    )
    flops = result["cost"]["flops"]
    coll = result.get("collective_bytes_total", 0.0)
    mf = model_flops_per_chip(result["arch"], result["shape"], chips)
    return Roofline(
        arch=result["arch"],
        shape=result["shape"],
        mesh=result["mesh"],
        compute_s=flops / PEAK_FLOPS_BF16,
        memory_s=hbm_bytes / HBM_BW,
        collective_s=coll / ICI_BW_PER_LINK,
        model_flops_per_chip=mf,
        hlo_flops_per_chip=flops,
        fit_gb=hbm_bytes / 2**30,
        tag=result.get("tag", ""),
    )


def table(results_dir: Path = RESULTS_DIR, mesh: str = "16x16", tag: str = "") -> str:
    rows = []
    for r in load_results(results_dir):
        if r.get("mesh") != mesh or r.get("tag", "") != tag:
            continue
        rl = roofline_for(r)
        if rl is None:
            rows.append(
                f"| {r['arch']} | {r['shape']} | {r.get('status')} | "
                f"{r.get('reason', r.get('error', ''))[:60]} |"
            )
            continue
        rows.append(
            f"| {rl.arch} | {rl.shape} | {rl.compute_s:.4f} | {rl.memory_s:.4f} | "
            f"{rl.collective_s:.4f} | **{rl.dominant}** | {rl.useful_ratio:.3f} | "
            f"{rl.roofline_fraction * 100:.1f}% | {rl.fit_gb:.1f} |"
        )
    header = (
        "| arch | shape | compute (s) | memory (s) | collective (s) | dominant | "
        "MODEL/HLO | roofline frac | fit GB/chip |\n"
        "|---|---|---|---|---|---|---|---|---|"
    )
    return header + "\n" + "\n".join(rows)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--tag", default="")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()
    if args.json:
        out = []
        for r in load_results():
            rl = roofline_for(r)
            if rl is not None and r.get("mesh") == args.mesh and r.get("tag", "") == args.tag:
                out.append(rl.__dict__ | {
                    "dominant": rl.dominant,
                    "useful_ratio": rl.useful_ratio,
                    "roofline_fraction": rl.roofline_fraction,
                })
        print(json.dumps(out, indent=2))
    else:
        print(table(mesh=args.mesh, tag=args.tag))


if __name__ == "__main__":
    main()
