"""The device trace of a traced run: ``torch.profiler`` over a fixed steady
sub-window of the measured window, started and stopped at step boundaries.

From the trace: device time by kernel name, the seconds in which any kernel
ran (``busy_s``) against the sub-window's length (``window_s``), and the idle
gaps between kernels named by what the host was doing (the innermost host
event covering a gap's middle: a harness phase, ``portbench.serve_step``'s
scheduling, a runtime call).
"""
from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

MARK = "portbench.subwindow"


@dataclass
class Trace:
    first_step: int
    last_step: int                     # steps [first_step, last_step) ran traced
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[int, float]]          # name -> (calls, seconds)
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def seconds_matching(self, pattern) -> Tuple[int, float]:
        calls = secs = 0
        for name, (n, s) in self.kernels.items():
            if pattern.search(name):
                calls += n
                secs += s
        return calls, secs


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def analyse(events, first_step: int, last_step: int) -> Optional[Trace]:
    """A ``Trace`` from the profiler's events, or None where the trace holds
    no device kernel or no sub-window mark."""
    mark = None
    kern: List[Tuple[str, float, float]] = []
    host: List[Tuple[float, float, str]] = []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if getattr(e.device_type, "name", "") == "CUDA":
            # the device side of a host annotation spans kernels; it is none
            if getattr(e, "is_user_annotation", False) or e.name.startswith("portbench."):
                continue
            if "emcpy" not in e.name and "emset" not in e.name:
                kern.append((e.name, a, b))
        elif e.name == MARK:
            mark = (a, b)
        else:
            host.append((a, b, e.name))
    if mark is None or not kern:
        return None
    lo, hi = mark
    clipped = [(max(a, lo), min(b, hi)) for _, a, b in kern if b > lo and a < hi]
    busy = _union([iv for iv in clipped if iv[1] > iv[0]])
    by_name: Dict[str, Tuple[int, float]] = {}
    for name, a, b in kern:
        if b <= lo or a >= hi:
            continue
        n, s = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, s + (min(b, hi) - max(a, lo)) * 1e-6)
    # idle gaps, each named by the innermost host event over its middle
    host.sort()
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = {}
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid)
        best = None
        for h in reversed(host[max(0, i - 4000):i]):
            if h[1] >= mid and (best is None or h[1] - h[0] < best[1] - best[0]):
                best = h
        name = best[2] if best else "(no host event)"
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    return Trace(
        first_step=first_step, last_step=last_step, window_s=(hi - lo) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6, kernels=by_name,
        gaps=sorted(gaps.items(), key=lambda kv: -kv[1]),
    )


class SubWindow:
    """Profiles the steps that start in ``[start_s, start_s + seconds)`` of
    the window. ``tick(now, step)`` at each step boundary; the trace is read
    only after the window has closed (``finish``)."""

    def __init__(self, start_s: float, seconds: float, sync):
        self.start_s, self.seconds, self.sync = start_s, seconds, sync
        self._prof = None
        self._mark = None
        self._t0 = 0.0
        self._first = 0
        self._done: Optional[Tuple] = None   # (profiler, first step, last step)

    def warm(self) -> None:
        """One empty session in set-up, so that the profiler's own start-up
        (CUPTI's) stays out of the window."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            self.sync()

    def _begin(self, step: int) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        self.sync()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._mark = record_function(MARK)
        self._mark.__enter__()
        self._first = step
        self._t0 = time.perf_counter()

    def _end(self, step: int) -> None:
        self.sync()
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self._done = (self._prof, self._first, step)
        self._prof = None

    def tick(self, now: float, step: int) -> None:
        if self._prof is not None:
            if time.perf_counter() - self._t0 >= self.seconds:
                self._end(step)
        elif self._done is None and now >= self.start_s:
            self._begin(step)

    def finish(self) -> Optional[Trace]:
        """The sub-window's trace (None where it never opened or holds no
        device kernel)."""
        if self._done is None:
            return None
        prof, first, last = self._done
        return analyse(prof.events(), first, last)

    def close(self, step: int) -> None:
        """End a sub-window still open when the window closes."""
        if self._prof is not None:
            self._end(step)
