"""Quickstart — the paper's scheduler in 40 lines.

Simulates the paper's GSM8K × LLaMA-65B experiment (Table III settings) in
all four configurations and prints the utilization / total-time comparison
(Figs. 6–9), plus the theoretical lower bound (Eq. 32) and an ASCII Gantt.

    PYTHONPATH=src python examples/torch_quickstart.py
"""
from repro_torch.core import PAPER_COST_MODEL, simulate, theoretical_lower_bound
from repro_torch.core.gantt import ascii_gantt
from repro_torch.data import PAPER_PREDICTOR_NOISE_STD, gsm8k_like_workload


def main():
    requests = gsm8k_like_workload(
        seed=0, estimate_noise_std=PAPER_PREDICTOR_NOISE_STD
    )
    print(f"{len(requests)} requests, 200 clients (paper Table III)\n")

    lb = theoretical_lower_bound(requests, 200, PAPER_COST_MODEL)
    print(
        f"theoretical lower bound (Eq. 32): {lb.total:.2f}s "
        f"(prefill* {lb.t_prefill_star:.2f} + decode* {lb.t_decode_star:.2f}; "
        f"paper: 180 = 13 + 167)\n"
    )

    paper = {
        "baseline": "80.2% / 201.00s",
        "offline": "85.5% / 197.08s",
        "online": "86.19% / 193.33s",
        "hybrid": "89.06% / 190.58s",
    }
    last = None
    for mode in ("baseline", "offline", "online", "hybrid"):
        tr = simulate(requests, 200, PAPER_COST_MODEL, mode=mode)
        print(
            f"{mode:9s} util={tr.utilization * 100:6.2f}%  "
            f"total={tr.makespan:7.2f}s  "
            f"speed={tr.generation_speed:7.1f} tok/s   (paper: {paper[mode]})"
        )
        last = tr
    print("\nGantt of the hybrid run (paper Fig. 9):")
    print(ascii_gantt(last, width=100, max_clients=20))


if __name__ == "__main__":
    main()
