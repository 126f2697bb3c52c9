"""Perfetto / Chrome ``trace_event`` exporter.

Converts an :class:`~repro_torch.obs.Observation` into the JSON object format
that `ui.perfetto.dev <https://ui.perfetto.dev>`_ (and chrome://tracing)
load directly:

  * one *process* per replica, one *thread* per slot — so the track
    layout mirrors the fleet: replica rows, slot lanes;
  * ``ph:"X"`` complete events for each request's prefill and decode
    phases on the slot where they ran (preempt/migrate split the phase);
  * ``ph:"i"`` instant events for faults, condemnations, steals, COW
    copies, fencings and health transitions on a per-replica control lane;
  * ``ph:"M"`` metadata events naming every track.

Timestamps are fleet virtual time converted to microseconds.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from .lifecycle import request_timelines

_US = 1e6
CONTROL_LANE = 9999        # tid for per-replica instant events

# fleet-level span kinds exported as instants
_INSTANT_KINDS = {
    "fault", "injected_fault", "condemn", "steal", "cow_copy", "fenced",
    "health_transition", "migration", "overload_defer",
}


def _phase_events(obs) -> List[dict]:
    """``ph:"X"`` slices: each request's prefill/decode segments per slot."""
    out: List[dict] = []
    for rid, evs in sorted(request_timelines(obs).items()):
        open_t = None        # (t, replica, slot, phase_name)
        for ev in evs:
            if ev.kind in ("admit", "resume") and ev.slot is not None:
                if open_t is None:
                    open_t = (ev.t, ev.replica, ev.slot, f"prefill r{rid}")
            elif ev.kind in ("prefill_done", "first_token"):
                if open_t is not None:
                    t0, rep, slot, name = open_t
                    out.append(_complete(name, rep, slot, t0, ev.t, rid))
                if ev.slot is not None:
                    open_t = (ev.t, ev.replica, ev.slot, f"decode r{rid}")
            elif ev.kind in ("preempt", "migrate_out", "complete"):
                if open_t is not None:
                    t0, rep, slot, name = open_t
                    out.append(_complete(name, rep, slot, t0, ev.t, rid))
                    open_t = None
            elif ev.kind == "migrate_in" and ev.slot is not None:
                open_t = (ev.t, ev.replica, ev.slot, f"decode r{rid}")
        # phase left open (e.g. request in flight at checkpoint): close at
        # its last event so the trace stays well-formed
        if open_t is not None and evs:
            t0, rep, slot, name = open_t
            t1 = max(e.t for e in evs)
            if t1 > t0:
                out.append(_complete(name, rep, slot, t0, t1, rid))
    return out


def _complete(
    name: str, replica: int, slot: int, t0: float, t1: float, rid: int
) -> dict:
    return {
        "name": name,
        "ph": "X",
        "pid": replica,
        "tid": slot,
        "ts": t0 * _US,
        "dur": max(0.0, (t1 - t0)) * _US,
        "cat": "request",
        "args": {"rid": rid},
    }


def _instant_events(obs) -> List[dict]:
    out: List[dict] = []
    for ev in obs.spans.events:
        if ev.kind not in _INSTANT_KINDS:
            continue
        args = {k: v for k, v in ev.attrs.items()}
        if ev.rid >= 0:
            args["rid"] = ev.rid
        out.append({
            "name": ev.kind,
            "ph": "i",
            "s": "p",            # process-scoped instant
            "pid": ev.replica,
            "tid": CONTROL_LANE if ev.slot is None else ev.slot,
            "ts": ev.t * _US,
            "cat": "control",
            "args": args,
        })
    return out


def _metadata_events(obs) -> List[dict]:
    out: List[dict] = []
    slots_of: Dict[int, int] = {
        r: int(info["n_slots"]) for r, info in obs.replicas.items()
    }
    # replicas seen only via events (e.g. killed before finish)
    for ev in obs.spans.events:
        slots_of.setdefault(ev.replica, 0)
    for replica in sorted(slots_of):
        out.append({
            "name": "process_name", "ph": "M", "pid": replica, "tid": 0,
            "args": {"name": f"replica {replica}"},
        })
        for slot in range(slots_of[replica]):
            out.append({
                "name": "thread_name", "ph": "M",
                "pid": replica, "tid": slot,
                "args": {"name": f"slot {slot}"},
            })
        out.append({
            "name": "thread_name", "ph": "M",
            "pid": replica, "tid": CONTROL_LANE,
            "args": {"name": "control"},
        })
    return out


def perfetto_trace(obs) -> dict:
    """The full trace as a Chrome ``trace_event`` JSON object."""
    events = _metadata_events(obs) + _phase_events(obs) + _instant_events(obs)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "source": "repro_torch.obs",
            "metrics": obs.registry.scalars(),
        },
    }


def write_trace(obs, path: str) -> str:
    """Write the Perfetto trace JSON to ``path``; returns the path."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(perfetto_trace(obs), f)
    return path
