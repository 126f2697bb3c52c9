from .workload import (
    WorkloadSpec,
    attach_slos,
    gsm8k_like_workload,
    shared_prefix_workload,
    PAPER_WORKLOAD_SPEC,
    PAPER_PREDICTOR_NOISE_STD,
)
