"""The program's own host spans over a run's window, for the readers of the
engine's phases (``metrics/{sched,feed,commit}_share.backlog.py``).

The engine records one ``engine.step`` a ``serve_step``, with its phases, on
``time.perf_counter`` (``Engine.host``, ``repro_torch.obs.host``). The
harness hands a reader no engine, so the engine's recorder is found among
the process's live objects: the one that stepped last, which is the engine
of the window just driven (run_cell reads the metrics while it lives). A
step's ``clock`` is the engine's session clock at entry, which the harness
moves to the window's time just before the step (``advance_clock``), so the
window's start on the spans' clock is the median of ``start - clock`` over
the window's steps. A second recorder that stepped inside the window (two
engines in one cell) raises: these readers read one engine. A program
without host spans gives None.
"""
from __future__ import annotations

import gc
import statistics
from typing import Dict, Optional, Sequence

SCHED = ("engine.schedule", "engine.policy", "engine.plan")
FEED = ("engine.load", "engine.sync")
COMMIT = ("engine.commit",)


def _last_start(rec) -> float:
    return rec.since(rec.count - 1)[0].start


def window_steps(end: float):
    """(the window's steps, the window's start on their clock): the steps
    the last recorder to step began at session clocks in [0, end). Raises
    where its ring has dropped steps, or where another live recorder
    stepped inside the window."""
    try:
        from repro_torch.obs.host import HostSpans
    except ImportError:
        return [], None
    live = [o for o in gc.get_objects() if type(o) is HostSpans and o.count]
    if not live:
        return [], None
    rec = max(live, key=_last_start)
    steps = [s for s in rec.since(0) if 0 <= s.clock < end and s.end is not None]
    if not steps:
        return [], None
    origin = statistics.median(s.start - s.clock for s in steps)
    if any(_last_start(o) >= origin for o in live if o is not rec):
        raise RuntimeError("more than one engine stepped in the window; "
                           "the host spans' readers read one")
    return steps, origin


def phase_seconds(end: float) -> Optional[Dict[str, float]]:
    """Seconds of each engine phase inside the window ``[0, end]``."""
    steps, origin = window_steps(end)
    if origin is None:
        return None
    hi = origin + end
    out: Dict[str, float] = {}
    for s in steps:
        for p in s.phases:
            a, b = max(p.start, origin), min(p.end, hi)
            if b > a:
                out[p.name] = out.get(p.name, 0.0) + b - a
    return out


def share(end: float, names: Sequence[str]) -> Optional[float]:
    """The phases ``names`` together, in % of the window ``[0, end]``."""
    secs = phase_seconds(end)
    if secs is None:
        return None
    return 100 * sum(secs.get(n, 0.0) for n in names) / end
