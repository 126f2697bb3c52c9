"""End to end: serve a small model with batched requests on the port.

Runs the REAL continuous-batching engine of the PyTorch port (prefill/decode
of an actual transformer, on the GPU through the hand-written kernels, or on
the CPU through their plain versions) under the vLLM-style baseline and the paper's
hybrid scheduler, with the online profiler calibrating the cost model live —
the whole paper stack against real compute.

Decode is *fused*: ``EngineConfig.max_decode_horizon`` (default 8) lets the
policy commit up to K decode iterations to one on-device dispatch — sampling
included — instead of one host round-trip per token; pass
``decode_horizon=K`` to pin the horizon, or ``max_decode_horizon=1`` for the
per-token baseline. Token streams are identical either way (the per-mode
``dispatches/token`` column is what changes).

The paged modes contrast the two scheduling shapes: ``hybrid-paged-alt``
alternates prefill chunk rounds with decode stages (decoders freeze behind
every chunk — the ``stall`` column), while ``hybrid-paged`` (mixed-step, the
default) co-dispatches prefill chunks inside decode rounds under the
policy's ``prefill_share`` pricing, so the stall is ~0 and stages show as
'M' in the Gantt. Token streams are identical across all modes.

    PYTHONPATH=src python examples/torch_serve_engine.py                # on the GPU
    PYTHONPATH=src python examples/torch_serve_engine.py --device cpu \
        --trace /tmp/serve_engine.trace.json

``--device`` defaults to ``cuda`` and raises where there is no CUDA device.
The observability demo writes its Perfetto trace to ``--trace`` (by default
``torch_serve_engine.trace.json`` in the system's temporary directory).
"""
import argparse
import os
import tempfile

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import (
    CostModel,
    GlobalQueueScheduler,
    LagrangianPolicy,
    PrefillFirstPolicy,
    SortingPreemptiveScheduler,
    build_clients,
    solve_offline,
)
from repro_torch.core.gantt import ascii_gantt
from repro_torch.data import WorkloadSpec, gsm8k_like_workload, shared_prefix_workload
from repro_torch.models.transformer import TransformerLM
from repro_torch.obs import (
    Observation,
    capacity_table,
    check_capacity_conservation,
    lifecycle_table,
    perfetto_trace,
    write_trace,
)
from repro_torch.serving.engine import Engine, EngineConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default=os.path.join(tempfile.gettempdir(),
                                                    "torch_serve_engine.trace.json"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = ArchConfig(
        name="demo-120m", family="dense", n_layers=4, d_model=256, n_heads=8,
        n_kv_heads=4, d_ff=512, vocab_size=1024,
    )
    model = TransformerLM(cfg, device=device)
    params = model.init_params(seed=0)
    spec = WorkloadSpec(
        n_requests=32, input_mean=24, input_std=8, output_mean=32,
        output_std=14, output_max=64, input_max=32,
    )
    cm = CostModel(level_caps=(32, 64, 128, 256))

    for mode in ("baseline", "hybrid", "hybrid-paged-alt", "hybrid-paged"):
        reqs = gsm8k_like_workload(spec, seed=7, known_lengths=True)
        if mode == "hybrid-paged":
            layout = dict(kv_layout="paged", page_size=16, prefill_chunk=32)
        elif mode == "hybrid-paged-alt":
            layout = dict(
                kv_layout="paged", page_size=16, prefill_chunk=32,
                mixed_schedule=False,
            )
        else:
            layout = {}
        eng = Engine(
            model, params,
            EngineConfig(
                n_slots=8, max_len=128, prefill_seq_buckets=(32,), **layout
            ),
            device=device,
        )
        eng.profiler.cost_model = cm
        if mode == "baseline":
            clients = build_clients(8, reqs, None)
            sched, pol = GlobalQueueScheduler(reqs), PrefillFirstPolicy()
        else:
            asn = solve_offline(reqs, 8, cm).assignment
            clients = build_clients(8, reqs, asn)
            sched, pol = SortingPreemptiveScheduler(clients), LagrangianPolicy()
        tr = eng.serve(reqs, clients, sched, pol, policy_name=mode)
        s = tr.summary()
        kv = (
            f"  peak KV={eng.slots.peak_kv_bytes() / 1024:.0f} KiB"
            if mode.startswith("hybrid-paged") else ""
        )
        dpt = eng.decode_dispatches / max(eng.decoded_tokens, 1)
        print(
            f"{mode:16s} util={s['utilization'] * 100:5.1f}%  "
            f"wall={s['makespan_s']:6.2f}s  speed={s['generation_speed_tok_s']:6.0f} tok/s  "
            f"prefill stages={s['num_bins']}  dispatches/token={dpt:.3f}  "
            f"mixed rounds={s['mixed_rounds']}  "
            f"stall={s['prefill_stall_time_s']:.3f}s  "
            f"profiler refits={eng.profiler.fits}{kv}"
        )
        print(ascii_gantt(tr, width=90, max_clients=8))

    # shared-prefix demo: the same prompts through the refcounted prefix
    # cache — members of a hot template group adopt the published KV pages
    # read-only and only compute their unique tails (COW at divergence).
    # Token streams must not change; only the computed/cached split does.
    print("shared-prefix demo (3 Zipf-hot templates, prefix cache off vs on):")
    gens = {}
    for cache_on in (False, True):
        reqs = shared_prefix_workload(
            spec, seed=7, n_groups=3, prefix_mean=20.0, prefix_std=4.0,
            known_lengths=True,
        )
        eng = Engine(
            model, params,
            EngineConfig(
                n_slots=8, max_len=128, prefill_seq_buckets=(32,),
                kv_layout="paged", page_size=16, prefill_chunk=32,
                prefix_cache=cache_on,
            ),
            device=device,
        )
        eng.profiler.cost_model = cm
        tr = eng.serve(
            reqs, build_clients(8, reqs, None), GlobalQueueScheduler(reqs),
            PrefillFirstPolicy(),
            policy_name="cache-on" if cache_on else "cache-off",
        )
        gens[cache_on] = dict(eng.generated)
        total = sum(r.n_prefill for r in reqs)
        print(
            f"  prefix cache {'on ' if cache_on else 'off'}: "
            f"computed prefill={tr.computed_prefill_tokens:4d} tok  "
            f"cached={tr.cached_prefill_tokens:4d} tok  "
            f"hit-rate={eng.cache_hit_tokens / total * 100:4.1f}%  "
            f"shared pages peak={eng.slots.shared_pages_peak}  "
            f"cow copies={eng.slots.cow_copies}"
        )
        if cache_on:
            print(ascii_gantt(tr, width=90, max_clients=8))
    print(f"token streams identical across cache off/on: {gens[False] == gens[True]}")

    # observability demo: the same mixed-step serve with an Observation
    # attached — per-request lifecycle spans, the capacity-attribution
    # rollup (every slot-second classified, rows summing exactly to
    # makespan x slots), and a Perfetto trace for ui.perfetto.dev.
    print("observability demo (hybrid-paged serve, observe=Observation()):")
    obs = Observation()
    reqs = gsm8k_like_workload(spec, seed=7, known_lengths=True)
    eng = Engine(
        model, params,
        EngineConfig(
            n_slots=8, max_len=128, prefill_seq_buckets=(32,),
            kv_layout="paged", page_size=16, prefill_chunk=32, observe=obs,
        ),
        device=device,
    )
    eng.profiler.cost_model = cm
    eng.serve(
        reqs, build_clients(8, reqs, None), GlobalQueueScheduler(reqs),
        LagrangianPolicy(), policy_name="observed",
    )
    check_capacity_conservation(obs)
    print(capacity_table(obs))
    print("first 3 request lifecycles:")
    print(lifecycle_table(obs, rids=[0, 1, 2]))
    path = write_trace(obs, args.trace)
    n_events = len(perfetto_trace(obs)["traceEvents"])
    print(
        f"wrote {path} ({n_events} events, "
        f"{len(obs.audit.records)} audit records) — open in ui.perfetto.dev"
    )


if __name__ == "__main__":
    main()
