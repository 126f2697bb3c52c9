"""Fleet serving demo on the PyTorch port: N real engine replicas under the paper's hybrid
offline-online scheduler at replica granularity.

Builds a 2-replica fleet over ONE set of model weights (each replica owns
an independent paged KV pool), serves a skewed workload three ways —

  * ``round_robin``       — round_robin_assign partition + round-robin
                            dispatch, no stealing (the unbalanced baseline);
  * ``lpt``               — solve_offline (LPT + local search) partition +
                            least-estimated-load dispatch + work stealing
                            (the full hybrid);
  * ``lpt/no-steal``      — ablation: balanced partition, stealing off.

— and prints the fleet report (makespan, fleet utilization vs the flat-pool
``theoretical_lower_bound``, steal events) plus per-replica Gantt rows on a
shared time axis, where round-robin's straggler replica shows up as a tail
of idle columns.

A second, HETEROGENEOUS round then emulates a mixed-generation fleet on
this one host (``ReplicaSpec.speed_factor`` scales each replica's
virtual-time stage clock — the 0.33× replica's Gantt rows are visibly
denser, the same tokens stretched over more of the shared axis) and
compares the R||Cmax-aware partition (``assign="lpt"``) against the
speed-blind P||Cmax one (``assign="lpt_blind"``).

A final FAILURE-RECOVERY round kills replica 0 mid-serve via a
``FaultPlan``: the fleet re-queues its queued and in-flight requests onto
the survivor (recompute-on-resume), every request completes exactly once
with token streams bit-identical to the no-fault serve, and the Gantt shows
replica 0's rows going idle at the kill instant while the survivor's tail
stretches to absorb the load (goodput before/after printed).

Dispatch-policy flags live on ``FleetConfig``: ``assign`` ("lpt" |
"lpt_blind" | "round_robin"), ``dispatch`` ("least_load" | "round_robin"),
``work_stealing`` (bool), ``n_replicas``; per-replica speeds/cost priors
ride on ``Fleet(replica_specs=[ReplicaSpec(...), ...])``.

    PYTHONPATH=src python examples/torch_serve_fleet.py               # on the GPU
    PYTHONPATH=src python examples/torch_serve_fleet.py --device cpu  # plain PyTorch path

``--device`` defaults to ``cuda`` and raises where there is no CUDA device.
"""
import argparse

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import CostModel, LagrangianPolicy, ReplicaSpec, Request
from repro_torch.core.gantt import fleet_ascii_gantt
from repro_torch.models.transformer import TransformerLM
from repro_torch.serving.engine import EngineConfig
from repro_torch.serving.fleet import FaultPlan, Fleet, FleetConfig, ReplicaFault


def skewed_workload():
    """Decode-heavy requests at every other position — adversarial for a
    round-robin split over 2 replicas (they all land on replica 0)."""
    reqs = []
    for rid in range(12):
        if rid % 2 == 0 and rid < 8:
            reqs.append(Request(rid=rid, n_prefill=24, n_decode=64))
        else:
            reqs.append(Request(rid=rid, n_prefill=16, n_decode=8))
    return reqs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = ArchConfig(
        name="demo-120m", family="dense", n_layers=4, d_model=256, n_heads=8,
        n_kv_heads=4, d_ff=512, vocab_size=1024,
    )
    model = TransformerLM(cfg, device=device)
    params = model.init_params(seed=0)
    cm = CostModel(level_caps=(32, 64, 128, 256))
    ecfg = EngineConfig(
        n_slots=4, max_len=128, prefill_seq_buckets=(32,),
        kv_layout="paged", page_size=16, prefill_chunk=32,
    )

    modes = {
        "round_robin": FleetConfig(
            n_replicas=2, assign="round_robin", dispatch="round_robin",
            work_stealing=False,
        ),
        "lpt": FleetConfig(n_replicas=2, assign="lpt", dispatch="least_load"),
        "lpt/no-steal": FleetConfig(
            n_replicas=2, assign="lpt", dispatch="least_load",
            work_stealing=False,
        ),
    }
    for name, fc in modes.items():
        fleet = Fleet(model, params, ecfg, fc, cost_model=cm, device=device)
        fleet.serve(skewed_workload(), LagrangianPolicy)    # warm
        report = fleet.serve(skewed_workload(), LagrangianPolicy)
        s = report.summary()
        print(
            f"{name:14s} makespan={s['makespan_s']:7.3f}s  "
            f"fleet util={s['fleet_utilization'] * 100:5.1f}%  "
            f"speed={s['generation_speed_tok_s']:7.0f} tok/s  "
            f"lb_ratio={s['lb_ratio']:.2f}  steals={s['steal_events']}  "
            f"replica makespans={s['replica_makespans_s']}"
        )
        print(fleet_ascii_gantt(report, width=84))

    # ---- heterogeneous fleet: one replica at a third of the speed ------- #
    print("== heterogeneous fleet (speeds x1.0 / x0.33) ==")
    specs = [ReplicaSpec(speed_factor=1.0), ReplicaSpec(speed_factor=0.33)]
    het_modes = {
        "hetero lpt": FleetConfig(
            n_replicas=2, assign="lpt", dispatch="least_load",
            work_stealing=False,
        ),
        "blind lpt": FleetConfig(
            n_replicas=2, assign="lpt_blind", dispatch="least_load",
            work_stealing=False,
        ),
    }
    for name, fc in het_modes.items():
        fleet = Fleet(model, params, ecfg, fc, cost_model=cm,
                      replica_specs=specs, device=device)
        fleet.warm_serving_shapes()          # warm before profiled stages
        report = fleet.serve(skewed_workload(), LagrangianPolicy)
        s = report.summary()
        print(
            f"{name:14s} makespan={s['makespan_s']:7.3f}s  "
            f"fleet util={s['fleet_utilization'] * 100:5.1f}% "
            f"(speed-weighted)  solver={s['offline_solver']}  "
            f"replica requests={s['replica_requests']}"
        )
        print(fleet_ascii_gantt(report, width=84))

    # ---- failure recovery: replica 0 dies halfway through the serve ----- #
    print("== failure recovery (replica 0 killed at t = 50% of no-fault) ==")
    fc = FleetConfig(n_replicas=2, assign="lpt", dispatch="least_load")
    fleet = Fleet(model, params, ecfg, fc, cost_model=cm, device=device)
    fleet.serve(skewed_workload(), LagrangianPolicy)        # warm
    for eng in fleet.engines:
        eng.warm_serving_shapes()     # post-kill admission shapes too
    base = fleet.serve(skewed_workload(), LagrangianPolicy)
    base_gen = {rid: list(t) for rid, t in fleet.generated.items()}

    kill_at = 0.5 * base.makespan
    report = fleet.serve(
        skewed_workload(), LagrangianPolicy,
        fault_plan=FaultPlan([ReplicaFault(replica=0, at_s=kill_at)]),
    )
    done = [r for t in report.traces for r in t.requests]
    identical = fleet.generated.keys() == base_gen.keys() and all(
        fleet.generated[rid] == base_gen[rid] for rid in base_gen
    )
    print(
        f"killed replica 0 at t={kill_at:.3f}s: "
        f"completed={len(done)}/12 exactly-once="
        f"{len({r.rid for r in done}) == len(done)}  "
        f"recovered={fleet.recovered_requests}  "
        f"streams bit-identical to no-fault={identical}"
    )
    print(
        f"goodput before fault={base.goodput:7.0f} tok/s  "
        f"after fault={report.goodput:7.0f} tok/s  "
        f"makespan {base.makespan:.3f}s -> {report.makespan:.3f}s "
        f"(survivor absorbs the dead replica's queued + in-flight work; "
        f"replica 0's Gantt rows go idle past the kill instant)"
    )
    print(fleet_ascii_gantt(report, width=84))


if __name__ == "__main__":
    main()
