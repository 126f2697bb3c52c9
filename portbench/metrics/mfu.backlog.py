"""The model FLOPs of the work that reached the host in the window (2 x the
active weights a processed token multiplies, routed experts only; 2 x the
unembedding a sampled token; 4 x head_dim x heads a visible pair and layer)
over window x 989 TFLOP/s (H100 SXM, dense bf16)."""
from portbench import yardstick


def read(run):
    flops = yardstick.window_flops(run.reqs, run.end, run.flops)
    return 100 * flops / (run.end * yardstick.BF16_FLOPS_PER_S) if flops > 0 else None
