"""Policy lab — compare iteration policies beyond the paper's (§VI future
directions): utilization-weighted amortization and the dynamic-batch tail
rule, across several workload shapes.

    PYTHONPATH=src python examples/torch_policy_lab.py
"""
import dataclasses

from repro_torch.core import (
    PAPER_COST_MODEL,
    AmortizedPolicy,
    BalancedLagrangianPolicy,
    DynamicBatchPolicy,
    LagrangianPolicy,
    PrefillFirstPolicy,
    UtilizationWeightedPolicy,
    simulate,
)
from repro_torch.data import (
    PAPER_PREDICTOR_NOISE_STD,
    PAPER_WORKLOAD_SPEC,
    gsm8k_like_workload,
)

WORKLOADS = {
    "paper(gsm8k)": PAPER_WORKLOAD_SPEC,
    "short-outputs": dataclasses.replace(
        PAPER_WORKLOAD_SPEC, output_mean=80.0, output_std=40.0, output_mu0=80.0,
        output_sigma0=40.0,
    ),
    "long-prompts": dataclasses.replace(
        PAPER_WORKLOAD_SPEC, input_mean=400.0, input_std=120.0,
    ),
}

POLICIES = {
    "prefill_first": PrefillFirstPolicy,
    "lagrangian(paper)": LagrangianPolicy,
    "balanced(ours)": BalancedLagrangianPolicy,
    "amortized(ours)": AmortizedPolicy,
    "util_weighted": UtilizationWeightedPolicy,
    "dynamic_batch": DynamicBatchPolicy,
}


def main():
    for wname, spec in WORKLOADS.items():
        print(f"\n=== workload: {wname} ===")
        reqs = gsm8k_like_workload(
            spec, seed=0, estimate_noise_std=PAPER_PREDICTOR_NOISE_STD
        )
        for pname, pcls in POLICIES.items():
            tr = simulate(
                reqs, 200, PAPER_COST_MODEL, mode="hybrid", iteration_policy=pcls()
            )
            print(
                f"  {pname:18s} util={tr.utilization * 100:6.2f}%  "
                f"total={tr.makespan:7.2f}s  bins={tr.num_bins:4d}"
            )


if __name__ == "__main__":
    main()
