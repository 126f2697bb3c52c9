"""Per-request timelines and the capacity-attribution rollup.

``request_timelines`` groups the span log into one ordered event list per
request; ``lifecycle_table`` renders them human-readable. The heavier
artifact is ``capacity_attribution``: every slot-second of every replica's
makespan classified into exactly one of

    busy · cache_hit · preempted · stall · migration · idle_gap

The engine emits one capacity sample per executed stage (each of its
``n_slots`` slots contributes exactly the stage duration to exactly one
class), and the time *between* stages — arrival fast-forwards, drained
tails — is attributed to ``idle_gap`` as the residual against
``makespan × n_slots``. The rollup therefore sums exactly to
makespan × slots per replica **by construction**, and
``check_capacity_conservation`` hard-fails if the per-stage samples ever
overrun the replica's capacity (which would make the residual negative).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

CAPACITY_CLASSES = (
    "busy", "cache_hit", "preempted", "stall", "migration", "idle_gap",
)


def request_timelines(obs) -> Dict[int, list]:
    """Ordered span events per request id (fleet instants excluded)."""
    out: Dict[int, list] = {}
    for ev in obs.spans.events:
        if ev.rid < 0:
            continue
        out.setdefault(ev.rid, []).append(ev)
    for evs in out.values():
        evs.sort(key=lambda e: (e.t, e.event_id))
    return out


def lifecycle_table(obs, rids: Optional[Sequence[int]] = None) -> str:
    """Render per-request timelines as an aligned text table."""
    timelines = request_timelines(obs)
    if rids is None:
        rids = sorted(timelines.keys())
    lines = [f"{'rid':>5s}  {'t(s)':>9s}  {'replica':>7s}  {'slot':>4s}  event"]
    for rid in rids:
        for ev in timelines.get(rid, []):
            slot = "-" if ev.slot is None else str(ev.slot)
            extra = ""
            if ev.attrs:
                extra = "  " + " ".join(
                    f"{k}={v}" for k, v in sorted(ev.attrs.items())
                )
            lines.append(
                f"{rid:5d}  {ev.t:9.4f}  {ev.replica:7d}  {slot:>4s}  "
                f"{ev.kind}{extra}"
            )
    return "\n".join(lines)


def capacity_attribution(obs) -> Dict[int, Dict[str, float]]:
    """Per-replica slot-seconds by class, summing to makespan × slots.

    Requires the serve to have finished (``finish_replica`` recorded each
    replica's makespan and slot count). Raises if per-stage attribution
    exceeds the replica's total capacity beyond float tolerance.
    """
    rows: Dict[int, Dict[str, float]] = {}
    for replica, info in obs.replicas.items():
        rows[replica] = {c: 0.0 for c in CAPACITY_CLASSES}
        rows[replica]["makespan_s"] = info["makespan"]
        rows[replica]["n_slots"] = float(info["n_slots"])
    for sample in obs.capacity_samples:
        row = rows.get(sample["replica"])
        if row is None:
            # stage from a replica that never finished (e.g. killed before
            # finish_serve) — no capacity denominator, skip
            continue
        for cls, v in sample["classes"].items():
            row[cls] = row.get(cls, 0.0) + v
    for replica, row in rows.items():
        capacity = row["makespan_s"] * row["n_slots"]
        attributed = sum(row[c] for c in CAPACITY_CLASSES)
        residual = capacity - attributed
        tol = 1e-6 * max(1.0, capacity)
        if residual < -tol:
            raise AssertionError(
                f"replica {replica}: attributed {attributed:.6f}s of "
                f"slot-time exceeds capacity {capacity:.6f}s "
                f"(makespan {row['makespan_s']:.6f}s x {row['n_slots']:.0f} "
                f"slots)"
            )
        # idle_gap absorbs the residual so rows sum EXACTLY to capacity:
        # in-stage free slots were already attributed per stage; this adds
        # the between-stage gaps (arrival fast-forwards, drained tails).
        row["idle_gap"] += max(0.0, residual)
        total = sum(row[c] for c in CAPACITY_CLASSES)
        row["total"] = total
        row["capacity"] = capacity
    return rows


def check_capacity_conservation(obs, tol: float = 1e-6) -> bool:
    """Hard check: per replica, class rows sum to makespan × slots."""
    rows = capacity_attribution(obs)
    for replica, row in rows.items():
        capacity = row["capacity"]
        err = abs(row["total"] - capacity)
        if err > tol * max(1.0, capacity):
            raise AssertionError(
                f"replica {replica}: capacity attribution sums to "
                f"{row['total']:.9f}s, expected {capacity:.9f}s"
            )
    return True


def capacity_table(obs) -> str:
    """Render the capacity-attribution rollup as an aligned text table."""
    rows = capacity_attribution(obs)
    cols = CAPACITY_CLASSES
    lines = [
        "replica  " + "  ".join(f"{c:>9s}" for c in cols)
        + "  " + f"{'total':>9s}" + "  " + f"{'capacity':>9s}"
    ]
    for replica in sorted(rows):
        row = rows[replica]
        lines.append(
            f"{replica:7d}  "
            + "  ".join(f"{row[c]:9.3f}" for c in cols)
            + f"  {row['total']:9.3f}  {row['capacity']:9.3f}"
        )
    return "\n".join(lines)
