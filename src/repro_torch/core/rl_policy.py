"""RL iteration scheduler — the paper's future-work #2, implemented.

"a simple reinforcement learning model could be trained to assist the
scheduler in making decisions dynamically" (§VI). The state variables the
paper names (prefill waiting, decoding clients, expected decode/prefill
time) are cheap to derive — we discretize them into a small Q-table and
train with tabular Q-learning directly inside the simulator.

State: (idle-fraction bucket, candidate C_d/C_p ratio bucket,
        pending-pressure bucket); actions: {decode, prefill}.
Reward: −(stage duration) · (fraction of clients NOT doing useful work) —
i.e., the idle client-time each decision buys, which telescopes to the
trace's total idle area (= (1−utilization)·J·makespan), so minimizing it is
exactly maximizing the paper's objective.

Training runs in the event-driven simulator (thousands of decisions per
second), so a policy trains in seconds; see EXPERIMENTS.md §Beyond-paper.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .cost_model import CostModel
from .iteration import IterationPolicy, SystemSnapshot

N_IDLE_BUCKETS = 6
N_RATIO_BUCKETS = 6
N_PRESSURE_BUCKETS = 3


def _state(snap: SystemSnapshot, cm: CostModel) -> Tuple[int, int, int]:
    idle_frac = snap.n_idle / max(snap.n_clients, 1)
    idle_b = min(int(idle_frac * N_IDLE_BUCKETS), N_IDLE_BUCKETS - 1)
    cand = snap.candidate
    if cand:
        c_p = cm.quantized_prefill_time(
            min(cand.total_prefill_tokens, cm.max_level.cap_tokens)
        )
        c_d = cm.decode_per_token * cand.total_decode_est
        ratio = c_d / max(c_p, 1e-9)
    else:
        ratio = 0.0
    ratio_b = min(int(ratio / 0.5), N_RATIO_BUCKETS - 1)  # 0.5-wide buckets
    press = snap.pending_requests / max(snap.n_idle, 1)
    press_b = 0 if press <= 1 else (1 if press <= 4 else 2)
    return idle_b, ratio_b, press_b


@dataclass
class RLPolicy(IterationPolicy):
    """Tabular Q-policy over the paper's suggested state variables."""

    q: np.ndarray = field(
        default_factory=lambda: np.zeros(
            (N_IDLE_BUCKETS, N_RATIO_BUCKETS, N_PRESSURE_BUCKETS, 2), np.float64
        )
    )
    epsilon: float = 0.0
    rng: np.random.Generator = field(default_factory=lambda: np.random.default_rng(0))
    name: str = "rl"

    # training hooks (filled by the trainer between decisions)
    _last: Optional[Tuple[Tuple[int, int, int], int]] = None

    def decide_prefill(self, snap: SystemSnapshot, cost_model: CostModel) -> bool:
        # Structural progress guards (not learnable): drain-phase admission
        # and capacity saturation (see BalancedLagrangianPolicy) — the RL
        # policy learns only the genuine wait-vs-fire trade-off region.
        cand = snap.candidate
        if snap.pending_requests <= snap.n_idle:
            return True
        if snap.n_idle > len(cand.requests) and snap.pending_requests > len(cand.requests):
            return True
        if cand.total_prefill_tokens >= cost_model.max_level.cap_tokens:
            return True
        s = _state(snap, cost_model)
        if self.epsilon > 0 and self.rng.random() < self.epsilon:
            a = int(self.rng.integers(0, 2))
        else:
            a = int(np.argmax(self.q[s]))
        self._last = (s, a)
        return bool(a)


def train_rl_policy(
    make_requests,
    n_clients: int,
    cost_model: CostModel,
    episodes: int = 60,
    alpha: float = 0.2,
    gamma: float = 0.98,
    seed: int = 0,
) -> RLPolicy:
    """Q-learning in the simulator. ``make_requests(episode)`` supplies a
    fresh workload per episode (same distribution as evaluation)."""
    from .online import SortingPreemptiveScheduler, build_clients
    from .offline import solve_offline
    from .simulator import SimConfig, Simulator

    policy = RLPolicy(rng=np.random.default_rng(seed))

    class TrainingPolicy(IterationPolicy):
        name = "rl-training"

        def __init__(self):
            self.prev_sa = None

        def __call__(self, snap: SystemSnapshot, cm: CostModel) -> bool:
            # reward for the PREVIOUS decision materializes as the idle
            # client-time since then; approximate by the idle area of the
            # stage the previous action produced.
            s = _state(snap, cm)
            cand = snap.candidate
            guard = (
                bool(cand)
                and (
                    snap.pending_requests <= snap.n_idle
                    or (snap.n_idle > len(cand.requests)
                        and snap.pending_requests > len(cand.requests))
                    or cand.total_prefill_tokens >= cm.max_level.cap_tokens
                )
            )
            if not cand:
                a = 0
            elif snap.n_active == 0 or guard:
                a = 1
            else:
                if policy.rng.random() < policy.epsilon:
                    a = int(policy.rng.integers(0, 2))
                else:
                    a = int(np.argmax(policy.q[s]))
            if self.prev_sa is not None:
                ps, pa, pt, pidle = self.prev_sa
                dt = snap.now - pt
                reward = -dt * (pidle / max(snap.n_clients, 1))
                target = reward + gamma * np.max(policy.q[s])
                policy.q[ps + (pa,)] += alpha * (target - policy.q[ps + (pa,)])
            self.prev_sa = (s, a, snap.now, snap.n_idle)
            return bool(a)

    for ep in range(episodes):
        policy.epsilon = max(0.02, 0.4 * (1 - ep / max(episodes - 1, 1)))
        reqs = make_requests(ep)
        res = solve_offline(reqs, n_clients, cost_model)
        clients = build_clients(n_clients, reqs, res.assignment)
        sched = SortingPreemptiveScheduler(clients)
        sim = Simulator(
            reqs,
            SimConfig(n_clients=n_clients, cost_model=cost_model,
                      record_decisions=False),
            sched,
            TrainingPolicy(),
            clients=clients,
            policy_name="rl-train",
        )
        sim.run()
    policy.epsilon = 0.0
    return policy
