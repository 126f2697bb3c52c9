"""A cell at a size the CPU holds, for the benchmark's tests: the two
configurations' families (a dense GELU decoder with biases and layernorm, a
top-2 MoE over 8 experts with RMSNorm) at widths of 64, served by the
program's engine on the CPU with the kernels' plain versions.

    python3 portbench/smoke_cell.py dense 3 0

runs one such cell through the whole harness (``bench.run_cell`` without
the look for a chip) and prints its result line.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Dict

HERE = Path(__file__).resolve().parent

# Limits at this size only, from CPU readings of the bf16 program and the
# fp8 control on seeds 1-6 (192 steps of the control's test, whose clock
# counts steps; 160-182 served tokens of 24 requests, at most 8 a request):
# the dense model's widest gap 0.0002-0.0037 against the control's
# 0.031-0.050; the MoE's mean gap 0.0001-0.0029 against 0.011-0.022 (its
# widest gap does not separate: 0.003-0.224 against 0.25-0.36). Each limit
# lies past the middle of its two readings. On a wall-clock window a busy
# host finishes fewer requests, and on a sample of a few the two readings
# come close.
SMOKE_LIMITS = {False: {"logit_gap_max": 0.018}, True: {"logit_gap_mean": 0.0075}}


def arch(moe: bool, dtype: str = "bfloat16") -> Dict:
    return dict(
        name="smoke-moe" if moe else "smoke-dense", family="moe" if moe else "dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4 if moe else 2, head_dim=16,
        d_ff=32 if moe else 128, vocab_size=256,
        n_experts=8 if moe else 0, experts_per_token=2 if moe else 0,
        moe_capacity_factor=2.0, moe_group_size=512,       # the OLMoE cell's factor
        mlp_kind="swiglu" if moe else "gelu", norm_kind="rmsnorm" if moe else "layernorm",
        norm_eps=1e-5, use_bias=not moe, rope_theta=10000.0, tie_embeddings=not moe,
        dtype=dtype,
    )


def config(moe: bool, dtype: str = "bfloat16") -> Dict:
    """A configuration file's content: the full-size file's weight tree over
    the smoke sizes (the tied dense one has no ``embed.unembed``)."""
    full = json.loads((HERE / "configs" / ("olmoe-1b-7b.json" if moe else "starcoder2-7b.json")).read_text())
    return dict(arch=arch(moe, dtype), tree=full["tree"], reference="reference/decoder.py")


MIX = dict(kind="backlog", round_size=12, order_seed=31,
           prompt=dict(dist="normal", mean=12, std=4, min=1, max=24),
           output=dict(dist="normal", mean=10, std=5, min=1, max=16),
           estimate_noise_std=2.0)


def spec(moe: bool = False) -> Dict:
    return dict(
        engine=dict(n_slots=4, max_len=64, kv_layout="paged", page_size=8, prefill_chunk=8,
                    prefill_req_buckets=[1, 2, 4], mixed_token_buckets=[8, 16],
                    max_decode_horizon=4, mixed_schedule=True),
        profile=dict(start_s=1.0, seconds=0.5),
        check=dict(served_tokens=200, max_requests=24, tokens_per_request=8,
                   limits=dict(SMOKE_LIMITS[moe])),
    )


def cell(moe: bool):
    """A ``bench.Cell`` reporting the metrics of the full-size backlog
    cells."""
    from portbench import bench

    full = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    name = "sc2-gsm8k-backlog"
    return bench.Cell(
        name=name, entry=dict(name=name, chips=1), config=config(moe), mix=MIX,
        spec=spec(moe),
        end_to_end=[m for m in full["end_to_end"] if bench.reports(m, name)],
        per_layer=[m for m in full["per_layer"] if bench.reports(m, name)],
    )


if __name__ == "__main__":
    t0 = time.perf_counter()
    sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]
    from portbench import bench

    moe = sys.argv[1] == "moe"
    out = bench.run_cell(cell(moe), 1234567890123, float(sys.argv[2]), sys.argv[3] == "1",
                         t0, device="cpu", require_chip=False)
    print(json.dumps(out))
