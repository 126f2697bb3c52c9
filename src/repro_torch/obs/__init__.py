"""Unified serve observability (counterpart of ``repro.obs``, copied
verbatim but for its own name): typed metrics, causal spans, audit log.

One :class:`Observation` instance records a whole serve — single engine or
an N-replica fleet (every replica shares the same instance, which is what
makes cross-replica span parenting work). Opt in per serve:

    from repro_torch.obs import Observation
    obs = Observation()
    eng = Engine(model, params, EngineConfig(observe=obs, ...))
    eng.serve(...)
    obs.registry.scalars()             # typed metrics
    lifecycle_table(obs)               # per-request timelines
    write_trace(obs, "serve.trace.json")   # open in ui.perfetto.dev

The default is ``observe=None`` and every emission site in the serving
stack is guarded by a single ``if self.obs is not None`` — a disabled
serve executes **zero** observability callbacks (enforced in tests via
the class-level :attr:`Observation.tripwire` hook, which fires on every
public recording method).

An Observation records exactly one serve: create a fresh instance per
serve (checkpoint restore of the *same* serve round-trips through
``state_dict``/``load_state_dict``).

Apart from the Observation, each engine owns a :class:`HostSpans`
(``Engine.host``, module ``host``): wall-clock spans of its own host work,
one ``engine.step`` a ``serve_step`` with its phases (scheduling, policy,
planning, input load, sync, launch, wait, commit). They are always on, fire
no Observation callback, are not in ``state_dict()``, and reach the profiler
(ranges of the same names) only while a ``torch.profiler`` session records.
"""
from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional

from .audit import AuditLog, AuditRecord
from .export import perfetto_trace, write_trace
from .host import HostSpans
from .lifecycle import (
    CAPACITY_CLASSES,
    capacity_attribution,
    capacity_table,
    check_capacity_conservation,
    lifecycle_table,
    request_timelines,
)
from .metrics import MetricDeclarationError, MetricSpec, MetricsRegistry
from .spans import SpanEvent, SpanLog

__all__ = [
    "Observation", "HostSpans",
    "MetricsRegistry", "MetricSpec", "MetricDeclarationError",
    "SpanLog", "SpanEvent",
    "AuditLog", "AuditRecord",
    "CAPACITY_CLASSES", "capacity_attribution", "capacity_table",
    "check_capacity_conservation", "lifecycle_table", "request_timelines",
    "perfetto_trace", "write_trace",
]


class Observation:
    """Facade over the registry, span log, audit log and capacity samples."""

    # Test hook: when set (class-level), called once at the top of every
    # public recording method. Lets tests count obs callbacks — and prove
    # the count is zero for an ``observe=None`` serve.
    tripwire: Optional[Callable[[], None]] = None

    def __init__(self) -> None:
        self.registry = MetricsRegistry()
        self.spans = SpanLog()
        self.audit = AuditLog()
        # per-stage slot-second attribution samples emitted by engines
        self.capacity_samples: List[dict] = []
        # replica -> {"makespan": s, "n_slots": n}, recorded at finish_serve
        self.replicas: Dict[int, dict] = {}

    def _trip(self) -> None:
        if Observation.tripwire is not None:
            Observation.tripwire()

    # ---------------------------------------------------------------- #
    # Spans                                                            #
    # ---------------------------------------------------------------- #
    def span(
        self,
        rid: int,
        kind: str,
        t: float,
        replica: int = 0,
        slot: Optional[int] = None,
        **attrs,
    ) -> SpanEvent:
        self._trip()
        return self.spans.emit(
            rid, kind, t, replica=replica, slot=slot, attrs=attrs
        )

    def instant(
        self, kind: str, t: float, replica: int = 0, **attrs
    ) -> SpanEvent:
        """Fleet-level point event (fault, steal, COW copy, ...). Attrs may
        reference a request by ``rid`` without joining its causal chain."""
        self._trip()
        return self.spans.emit(-1, kind, t, replica=replica, attrs=attrs)

    # ---------------------------------------------------------------- #
    # Audit                                                            #
    # ---------------------------------------------------------------- #
    def audit_record(
        self,
        kind: str,
        t: float,
        replica: int,
        inputs: Dict[str, object],
        chosen: object,
    ) -> AuditRecord:
        self._trip()
        return self.audit.record(kind, t, replica, inputs, chosen)

    # ---------------------------------------------------------------- #
    # Capacity attribution                                             #
    # ---------------------------------------------------------------- #
    def capacity(
        self, replica: int, t0: float, t1: float, classes: Dict[str, float]
    ) -> None:
        """One per-stage sample: slot-seconds of [t0, t1] by class."""
        self._trip()
        self.capacity_samples.append({
            "replica": replica, "t0": float(t0), "t1": float(t1),
            "classes": {k: float(v) for k, v in classes.items()},
        })

    def finish_replica(self, replica: int, makespan: float, n_slots: int) -> None:
        """Record a replica's capacity denominator at end of serve."""
        self._trip()
        self.replicas[replica] = {
            "makespan": float(makespan), "n_slots": int(n_slots),
        }

    # ---------------------------------------------------------------- #
    # Metrics passthrough                                              #
    # ---------------------------------------------------------------- #
    def declare(
        self, name: str, kind: str, unit: str = "", help: str = ""
    ) -> MetricSpec:
        self._trip()
        return self.registry.declare(name, kind, unit=unit, help=help)

    def inc(self, name: str, value: float = 1.0) -> None:
        self._trip()
        self.registry.inc(name, value)

    def set(self, name: str, value: float) -> None:
        self._trip()
        self.registry.set(name, value)

    def observe_value(self, name: str, value: float) -> None:
        self._trip()
        self.registry.observe(name, value)

    def log(self, channel: str, entry: dict) -> None:
        self._trip()
        self.registry.append_log(channel, entry)

    def set_log(self, channel: str, entries: List[dict]) -> None:
        self._trip()
        self.registry.set_log(channel, entries)

    # ---------------------------------------------------------------- #
    # Checkpointing (JSON string leaf: survives tree_map(np.asarray))   #
    # ---------------------------------------------------------------- #
    def state_dict(self) -> str:
        return json.dumps({
            "registry": self.registry.state_dict(),
            "spans": self.spans.state_dict(),
            "audit": self.audit.state_dict(),
            "capacity_samples": self.capacity_samples,
            "replicas": {str(k): v for k, v in self.replicas.items()},
        })

    def load_state_dict(self, blob: str) -> None:
        state = json.loads(blob)
        self.registry.load_state_dict(state["registry"])
        self.spans.load_state_dict(state["spans"])
        self.audit.load_state_dict(state["audit"])
        self.capacity_samples = list(state.get("capacity_samples", []))
        self.replicas = {
            int(k): v for k, v in state.get("replicas", {}).items()
        }
