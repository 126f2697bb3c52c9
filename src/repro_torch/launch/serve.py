"""Serving launcher of the port — the paper's system, end to end on a model.

    python -m repro_torch.launch.serve --arch qwen3_8b --policy hybrid \\
        --requests 32 --slots 8 --device cuda

Runs the paged, mixed-step continuous-batching engine on the smoke-size
configuration with random weights drawn from ``--seed`` and prints the
utilization / throughput summary the paper's Figs. 6–9 compare (and an ASCII
Gantt chart with ``--gantt``). ``--device`` defaults to ``cuda`` and the
launcher raises if no CUDA device exists; ``--device cpu`` runs the plain
PyTorch versions of the kernels instead.
"""
from __future__ import annotations

import argparse

from ..configs import ARCH_IDS, get_smoke_config
from ..core import (
    CostModel,
    GlobalQueueScheduler,
    LagrangianPolicy,
    PrefillFirstPolicy,
    SortingPreemptiveScheduler,
    StaticBacklogScheduler,
    build_clients,
    solve_offline,
)
from ..core.gantt import ascii_gantt
from ..data import WorkloadSpec, gsm8k_like_workload
from ..models.transformer import TransformerLM
from ..serving.engine import Engine, EngineConfig


def build_scheduling(mode, reqs, n_slots, cm):
    if mode == "baseline":
        return build_clients(n_slots, reqs, None), GlobalQueueScheduler(reqs), PrefillFirstPolicy()
    if mode == "offline":
        asn = solve_offline(reqs, n_slots, cm).assignment
        clients = build_clients(n_slots, reqs, asn)
        return clients, StaticBacklogScheduler(clients), PrefillFirstPolicy()
    if mode == "online":
        clients = build_clients(
            n_slots, reqs, [[r.rid for r in reqs[j::n_slots]] for j in range(n_slots)]
        )
        return clients, SortingPreemptiveScheduler(clients), LagrangianPolicy()
    if mode == "hybrid":
        asn = solve_offline(reqs, n_slots, cm).assignment
        clients = build_clients(n_slots, reqs, asn)
        return clients, SortingPreemptiveScheduler(clients), LagrangianPolicy()
    raise ValueError(mode)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3_8b")
    ap.add_argument("--policy", choices=["baseline", "offline", "online", "hybrid"],
                    default="hybrid")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gantt", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    model = TransformerLM(cfg, device=args.device)
    params = model.init_params(args.seed)
    spec = WorkloadSpec(
        n_requests=args.requests, input_mean=20, input_std=6,
        output_mean=24, output_std=10, output_max=48, input_max=30,
    )
    reqs = gsm8k_like_workload(spec, seed=args.seed, known_lengths=True)
    cm = CostModel(level_caps=(32, 64, 128, 256))
    clients, sched, pol = build_scheduling(args.policy, reqs, args.slots, cm)
    eng = Engine(
        model, params,
        EngineConfig(n_slots=args.slots, max_len=128, prefill_seq_buckets=(32,)),
        device=args.device,
    )
    eng.profiler.cost_model = cm
    trace = eng.serve(reqs, clients, sched, pol, policy_name=args.policy)
    s = trace.summary()
    print(
        f"policy={args.policy} device={eng.device} "
        f"util={s['utilization'] * 100:.1f}% "
        f"makespan={s['makespan_s']:.2f}s speed={s['generation_speed_tok_s']:.0f} tok/s "
        f"bins={s['num_bins']} decisions p50={s['mean_decision_ms']:.3f}ms"
    )
    if args.gantt:
        print(ascii_gantt(trace, width=90, max_clients=args.slots))


if __name__ == "__main__":
    main()
