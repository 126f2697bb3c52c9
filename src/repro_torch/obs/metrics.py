"""Typed metrics registry: the declared, unit-carrying replacement for the
stringly-typed ``ScheduleTrace.meta`` / ``FleetReport.meta`` grab-bags.

Every metric is declared once (name, kind, unit, help) before it is
recorded; re-declaring with identical attributes is an idempotent no-op,
re-declaring with *different* attributes raises — two subsystems cannot
silently publish incompatible series under one name. Three kinds:

  * ``counter``   — monotone accumulation (``inc``); fleet-wide counters
    sum across replicas by construction because every replica ``inc``s the
    same registry entry.
  * ``gauge``     — last-write-wins level (``set``).
  * ``histogram`` — raw observations (``observe``), summarized to
    count/sum/percentiles on demand.

``scalars()`` exports exactly the numeric view a ``summary()`` dict wants
(counters and gauges as floats, histograms as ``<name>_count``/
``<name>_sum``). Structured event records — fault logs, fenced logs,
per-event journals — go through the ``logs`` side-channel instead
(``set_log``/``append_log``): they are *typed as what they are* (lists of
dicts), never smuggled through a ``Dict[str, float]`` as JSON strings, and
``scalars()`` never includes them.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

KINDS = ("counter", "gauge", "histogram")


class MetricDeclarationError(ValueError):
    """Raised when a metric is re-declared with conflicting attributes."""


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One declared metric: its identity and documentation."""

    name: str
    kind: str                              # "counter" | "gauge" | "histogram"
    unit: str = ""                         # "s", "tokens", "pages", "" (count)
    help: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise MetricDeclarationError(
                f"metric {self.name!r}: unknown kind {self.kind!r}; "
                f"have {KINDS}"
            )


class MetricsRegistry:
    """Declared counters/gauges/histograms plus the typed log side-channel."""

    def __init__(self) -> None:
        self.specs: Dict[str, MetricSpec] = {}
        self._values: Dict[str, float] = {}           # counters + gauges
        self._samples: Dict[str, List[float]] = {}    # histograms
        # structured event records, typed as lists of dicts — the explicit
        # side-channel that used to be JSON strings inside meta dicts
        self.logs: Dict[str, List[dict]] = {}

    # ---------------------------------------------------------------- #
    # Declaration                                                      #
    # ---------------------------------------------------------------- #
    def declare(
        self, name: str, kind: str, unit: str = "", help: str = ""
    ) -> MetricSpec:
        spec = MetricSpec(name=name, kind=kind, unit=unit, help=help)
        have = self.specs.get(name)
        if have is not None:
            if have != spec:
                raise MetricDeclarationError(
                    f"metric {name!r} re-declared with conflicting "
                    f"attributes: {have} vs {spec}"
                )
            return have
        self.specs[name] = spec
        if kind == "histogram":
            self._samples[name] = []
        else:
            self._values[name] = 0.0
        return spec

    def _spec(self, name: str, expect: tuple) -> MetricSpec:
        spec = self.specs.get(name)
        if spec is None:
            raise KeyError(f"metric {name!r} was never declared")
        if spec.kind not in expect:
            raise MetricDeclarationError(
                f"metric {name!r} is a {spec.kind}, not one of {expect}"
            )
        return spec

    # ---------------------------------------------------------------- #
    # Recording                                                        #
    # ---------------------------------------------------------------- #
    def inc(self, name: str, value: float = 1.0) -> None:
        self._spec(name, ("counter",))
        if value < 0:
            raise ValueError(f"counter {name!r} cannot decrease (by {value})")
        self._values[name] += float(value)

    def set(self, name: str, value: float) -> None:
        self._spec(name, ("gauge",))
        self._values[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        self._spec(name, ("histogram",))
        self._samples[name].append(float(value))

    def set_log(self, channel: str, entries: List[dict]) -> None:
        self.logs[channel] = [dict(e) for e in entries]

    def append_log(self, channel: str, entry: dict) -> None:
        self.logs.setdefault(channel, []).append(dict(entry))

    # ---------------------------------------------------------------- #
    # Reading                                                          #
    # ---------------------------------------------------------------- #
    def value(self, name: str) -> float:
        self._spec(name, ("counter", "gauge"))
        return self._values[name]

    def samples(self, name: str) -> List[float]:
        self._spec(name, ("histogram",))
        return list(self._samples[name])

    def percentile(self, name: str, q: float) -> float:
        vals = sorted(self.samples(name))
        if not vals:
            return 0.0
        idx = min(len(vals) - 1, int(q / 100.0 * len(vals)))
        return vals[idx]

    def scalars(self) -> Dict[str, float]:
        """Every metric as plain floats — counters and gauges verbatim,
        histograms as ``_count``/``_sum``. Never includes ``logs``."""
        out = dict(self._values)
        for name, vals in self._samples.items():
            out[f"{name}_count"] = float(len(vals))
            out[f"{name}_sum"] = float(sum(vals))
        return out

    def describe(self) -> List[Dict[str, str]]:
        """The registry's self-documentation (name/kind/unit/help rows)."""
        return [dataclasses.asdict(s) for s in self.specs.values()]

    # ---------------------------------------------------------------- #
    # Checkpointing (JSON string: survives tree_map(np.asarray))        #
    # ---------------------------------------------------------------- #
    def state_dict(self) -> str:
        return json.dumps({
            "specs": [dataclasses.asdict(s) for s in self.specs.values()],
            "values": self._values,
            "samples": self._samples,
            "logs": self.logs,
        })

    def load_state_dict(self, blob: str) -> None:
        state = json.loads(blob)
        self.specs = {
            s["name"]: MetricSpec(**s) for s in state.get("specs", [])
        }
        self._values = {k: float(v) for k, v in state.get("values", {}).items()}
        self._samples = {
            k: [float(x) for x in v]
            for k, v in state.get("samples", {}).items()
        }
        self.logs = {k: list(v) for k, v in state.get("logs", {}).items()}
