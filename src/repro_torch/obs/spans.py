"""Causal request-lifecycle span events in fleet virtual time.

Every request emits a chain of events — arrival → admit → first_token →
prefill_done → (preempt → resume)* → (migrate_out → migrate_in)* →
complete — each carrying the replica and slot where it happened. Events
are causally linked: each event's ``parent`` is the id of the previous
event for the same request, and because a :class:`~repro_torch.obs.Observation`
is shared by every replica of a fleet, a ``migrate_out`` on replica 0 is
the parent of the ``migrate_in`` on replica 1 — one chain per request
across the whole fleet, no per-replica stitching needed.

Fleet-level instants (faults, fencing, steals, COW copies, health
transitions) use ``rid=-1`` and carry no parent: they are points on the
global timeline, not members of a request's causal chain.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional


@dataclasses.dataclass
class SpanEvent:
    """One point on a request's causal timeline."""

    event_id: int
    rid: int                      # request id; -1 for fleet-level instants
    kind: str                     # "arrival", "admit", "preempt", ...
    t: float                      # fleet virtual time (seconds)
    replica: int = 0
    slot: Optional[int] = None
    parent: Optional[int] = None  # event_id of the previous event for rid
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)


class SpanLog:
    """Append-only event log with per-request causal chaining."""

    def __init__(self) -> None:
        self.events: List[SpanEvent] = []
        self._last: Dict[int, int] = {}   # rid -> event_id of latest event

    def has(self, rid: int) -> bool:
        return rid in self._last

    def emit(
        self,
        rid: int,
        kind: str,
        t: float,
        replica: int = 0,
        slot: Optional[int] = None,
        attrs: Optional[Dict[str, object]] = None,
        **kw,
    ) -> SpanEvent:
        # attrs may arrive as an explicit dict (keys like "rid"/"slot" that
        # would collide with the positional parameters) or as keywords
        ev = SpanEvent(
            event_id=len(self.events),
            rid=rid,
            kind=kind,
            t=float(t),
            replica=replica,
            slot=slot,
            parent=self._last.get(rid) if rid >= 0 else None,
            attrs={**(attrs or {}), **kw},
        )
        self.events.append(ev)
        if rid >= 0:
            self._last[rid] = ev.event_id
        return ev

    def by_request(self, rid: int) -> List[SpanEvent]:
        return [e for e in self.events if e.rid == rid]

    def request_ids(self) -> List[int]:
        return sorted(self._last.keys())

    def chain(self, rid: int) -> List[SpanEvent]:
        """Walk the parent links back from the request's latest event.

        Returns the chain oldest-first; equals ``by_request(rid)`` exactly
        when the parent links are intact — tests assert that equivalence.
        """
        out: List[SpanEvent] = []
        cur = self._last.get(rid)
        while cur is not None:
            ev = self.events[cur]
            out.append(ev)
            cur = ev.parent
        out.reverse()
        return out

    # ---------------------------------------------------------------- #
    # Checkpointing (JSON string: survives tree_map(np.asarray))        #
    # ---------------------------------------------------------------- #
    def state_dict(self) -> str:
        return json.dumps({
            "events": [dataclasses.asdict(e) for e in self.events],
            "last": {str(k): v for k, v in self._last.items()},
        })

    def load_state_dict(self, blob: str) -> None:
        state = json.loads(blob)
        self.events = [SpanEvent(**e) for e in state.get("events", [])]
        self._last = {int(k): v for k, v in state.get("last", {}).items()}
