"""Gantt accounting and rendering (the paper's Figs. 6–9).

Renders a ScheduleTrace as (a) an ASCII Gantt (downsampled), (b) a CSV of
stage records, and (c) per-client busy/idle accounting. Terminal-friendly —
no plotting dependencies ship in the container.
"""
from __future__ import annotations

import io
from typing import List, Optional

from .types import ScheduleTrace, StageKind


def stage_csv(trace: ScheduleTrace) -> str:
    """CSV of stage records: kind,t_start,t_end,bin,n_busy,tokens,level."""
    buf = io.StringIO()
    buf.write("kind,t_start,t_end,bin,n_busy,tokens,level\n")
    for s in trace.stages:
        buf.write(
            f"{s.kind.value},{s.t_start:.6f},{s.t_end:.6f},{s.bin_index},"
            f"{len(s.busy) + len(s.busy_partial)},{s.tokens},"
            f"{s.level if s.level is not None else ''}\n"
        )
    return buf.getvalue()


def client_accounting(trace: ScheduleTrace) -> List[dict]:
    """Per-client busy time / utilization over the makespan."""
    busy = [0.0] * trace.num_clients
    for s in trace.stages:
        for cid in (*s.busy, *s.busy_partial):
            busy[cid] += s.duration
    span = trace.makespan or 1.0
    return [
        {"client": cid, "busy_s": round(b, 4), "utilization": round(b / span, 4)}
        for cid, b in enumerate(busy)
    ]


def ascii_gantt(
    trace: ScheduleTrace,
    width: int = 100,
    max_clients: int = 40,
    every_nth_client: Optional[int] = None,
    span: Optional[float] = None,
) -> str:
    """Downsampled ASCII Gantt.

    '#' = decoding, 'P' = in prefill, 'M' = mixed (decode + piggybacked
    prefill chunks), '.' = idle. One row per (sampled) client; columns are
    equal time buckets. A bucket shows the dominant state. ``span`` fixes
    the time axis (fleet rendering aligns every replica to the fleet
    makespan); default is the trace's own makespan.
    """
    if not trace.stages:
        return "(empty trace)"
    span = span or trace.makespan
    n = trace.num_clients
    step = every_nth_client or max(1, n // max_clients)
    rows = list(range(0, n, step))
    # occupancy[cid][col] in {0 idle, 1 prefill, 2 decode, 3 mixed}
    occ = {cid: [[0.0, 0.0, 0.0, 0.0] for _ in range(width)] for cid in rows}
    for s in trace.stages:
        c0 = int(s.t_start / span * width)
        c1 = max(c0 + 1, int(s.t_end / span * width + 0.999999))
        if s.kind is StageKind.PREFILL:
            kind = 1
        elif s.kind is StageKind.MIXED:
            kind = 3
        else:
            kind = 2
        for cid in rows:
            state = kind if (cid in s.busy or cid in s.busy_partial) else 0
            for col in range(c0, min(c1, width)):
                # apportion stage duration to bucket overlap (approximate)
                occ[cid][col][state] += s.duration / (c1 - c0)
    chars = {0: ".", 1: "P", 2: "#", 3: "M"}
    out = io.StringIO()
    slo_tag = ""
    if trace.slo_tracked_requests:
        slo_tag = (
            f" goodput={trace.goodput:.1f} tok/s "
            f"slo={trace.slo_attainment * 100:.0f}%"
        )
    cache_tag = ""
    if trace.cached_prefill_tokens:
        cache_tag = (
            f" prefill={trace.computed_prefill_tokens}tok computed"
            f"+{trace.cached_prefill_tokens}tok cached"
        )
    out.write(
        f"Gantt [{trace.policy_name}] makespan={trace.makespan:.2f}s "
        f"util={trace.utilization * 100:.2f}% "
        f"busy-window util={trace.busy_window_utilization * 100:.2f}% "
        f"speed={trace.generation_speed:.1f} tok/s{slo_tag}{cache_tag}\n"
    )
    for cid in rows:
        line = "".join(
            chars[max(range(4), key=lambda k: occ[cid][col][k])] for col in range(width)
        )
        out.write(f"c{cid:>4} |{line}|\n")
    out.write(
        f"       {'':<1}('#'=decode  'P'=prefill  'M'=mixed  '.'=idle; "
        f"{step} clients/row)\n"
    )
    return out.getvalue()


def fleet_ascii_gantt(
    report,
    width: int = 100,
    max_clients_per_replica: int = 8,
) -> str:
    """Per-replica Gantt rows on ONE shared time axis (the fleet makespan),
    so replica load imbalance is visible as trailing idle columns. Takes a
    ``FleetReport``."""
    span = report.makespan
    if span <= 0:
        return "(empty fleet trace)"
    speeds = report._replica_speeds()
    hetero = any(s != 1.0 for s in speeds)
    out = io.StringIO()
    slo_tag = ""
    if any(t.slo_tracked_requests for t in report.traces):
        slo_tag = (
            f" goodput={report.goodput:.1f} tok/s "
            f"slo={report.slo_attainment * 100:.0f}%"
        )
    fault_tag = ""
    if report.meta.get("dead_replicas"):
        fault_tag = (
            f" dead={int(report.meta['dead_replicas'])} "
            f"recovered={int(report.meta.get('recovered_requests', 0))}"
        )
        if report.meta.get("drained_replicas"):
            fault_tag += f" drained={int(report.meta['drained_replicas'])}"
    if report.meta.get("migration_events"):
        fault_tag += (
            f" migrations={int(report.meta['migration_events'])}"
            f"({int(report.meta.get('migrated_pages', 0))}pg)"
        )
    cached_total = sum(t.cached_prefill_tokens for t in report.traces)
    if cached_total:
        fault_tag += f" cached_prefill={cached_total}tok"
    out.write(
        f"Fleet Gantt [{report.policy_name}] replicas={report.n_replicas} "
        f"makespan={span:.2f}s util={report.utilization * 100:.2f}%"
        f"{' (speed-weighted)' if hetero else ''} "
        f"lb_ratio={report.lb_ratio:.2f} steals={report.steal_events}"
        f"{slo_tag}{fault_tag}\n"
    )
    for i, trace in enumerate(report.traces):
        # a slow replica's rows render visibly denser per request: the same
        # token count stretches over more of the shared fleet time axis
        speed_tag = f" speed=x{speeds[i]:g}" if hetero else ""
        out.write(
            f"-- replica {i}{speed_tag}: makespan={trace.makespan:.2f}s "
            f"util={trace.utilization * 100:.2f}% "
            f"requests={len(trace.requests)}\n"
        )
        out.write(
            ascii_gantt(
                trace, width=width, max_clients=max_clients_per_replica,
                span=span,
            )
        )
    return out.getvalue()


def utilization_timeline(trace: ScheduleTrace, buckets: int = 50) -> List[float]:
    """Utilization per time bucket (for Fig.-style summaries).

    Each stage's busy client-time is apportioned to buckets by overlap and
    then scaled so the bucket shares sum to exactly ``duration × n_busy`` —
    a stage ending on (or within float epsilon of) a bucket edge cannot
    leak a sliver of busy time into the next bucket, and bucket totals
    always reconcile with the trace's total busy time.
    """
    if not trace.stages:
        return []
    span = trace.makespan
    busy = [0.0] * buckets
    for s in trace.stages:
        n_busy = len(s.busy) + len(s.busy_partial)
        if n_busy == 0 or s.duration <= 0:
            continue
        b0 = s.t_start / span * buckets
        b1 = s.t_end / span * buckets
        i = min(int(b0), buckets - 1)
        parts = []                       # (bucket, overlap in bucket units)
        while i < buckets:
            lo, hi = max(b0, i), min(b1, i + 1)
            if hi - lo > 1e-12:          # skip float-epsilon edge slivers
                parts.append((i, hi - lo))
            if b1 <= i + 1:
                break
            i += 1
        total = sum(w_i for _, w_i in parts)
        if total <= 0:
            continue
        for i, w_i in parts:
            busy[i] += s.duration * n_busy * (w_i / total)
    denom = span / buckets * trace.num_clients
    return [round(b / denom, 4) for b in busy]
