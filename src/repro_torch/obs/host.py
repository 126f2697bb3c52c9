"""Wall-clock spans of the engine's host work, one step at a time.

Each call to ``Engine.serve_step`` is one ``engine.step`` span, whose
children are the phases the step passed through, in order:

    engine.schedule  proposing the batch, the overload filter, admission,
                     the candidate and the snapshot
    engine.policy    the iteration policy's ``decide``
    engine.plan      chunk planning, commits, page capacity, the horizon
    engine.load      the dispatch's host inputs and their copy in
    engine.sync      the device synchronise before the replay
    engine.launch    the replay call (views refreshed, the graph launched)
    engine.wait      until the stage's output is on the host
    engine.commit    everything after that until ``serve_step`` returns

Phases are contiguous: each begins where the one before it ended, so a
step's phases tile its span. A retried attempt starts again at
``engine.schedule``. The clock is ``time.perf_counter``; where the engine
times a stage or a decision it hands its own readings over, so that launch
plus wait is the stage's duration and the policy span is its
``decision_times_ms`` entry.

While a ``torch.profiler`` session records (checked once a step), every phase
also opens a profiler range of the same name (a user-scope ``RecordFunction``,
as ``torch.profiler.record_function`` opens, entered without its dispatcher
call), putting the phases on the device trace's timeline; each opens just
before the one it follows closes, so that the ranges leave no gap inside the
step, and the step itself opens none (a caller's range around ``serve_step``
marks it). With no session no range is entered. While CUPTI records on an
H100, ``record_function``'s ranges cost a StarCoder2-7B decode step ~2.3 ms
of host time, these ~0.4 ms.
"""
from __future__ import annotations

import collections
import time
from typing import Deque, List, NamedTuple, Optional, Tuple

import torch
from torch._C._profiler import _RecordFunctionFast

PHASES = ("engine.schedule", "engine.policy", "engine.plan", "engine.load",
          "engine.sync", "engine.launch", "engine.wait", "engine.commit")


class Span(NamedTuple):
    """One phase of a step."""

    name: str
    start: float
    end: float


class StepSpan:
    """One ``serve_step``: its span, what stage it ran, and its phases."""

    __slots__ = ("id", "start", "clock", "end", "kind", "shape", "marks")

    def __init__(self, id: int, start: float, clock: float):
        self.id = id
        self.start = start
        self.clock = clock                        # the engine's session clock at entry
        self.end: Optional[float] = None
        self.kind: Optional[str] = None           # the dispatch's kind; None: no stage ran
        self.shape: Tuple[int, ...] = ()          # the dispatch key's shape (horizon, rows)
        self.marks: List[Tuple[str, float]] = []  # (phase, its start), in order

    @property
    def phases(self) -> List[Span]:
        """The step's phases: each ends where the next begins, the last
        where the step ends."""
        ends = [t for _, t in self.marks[1:]] + [self.end]
        return [Span(name, a, b) for (name, a), b in zip(self.marks, ends)]


class HostSpans:
    """The engine's step spans: the last ``capacity`` steps in a ring, with a
    running count of every step begun."""

    def __init__(self, capacity: int = 8192):
        self._ring: Deque[StepSpan] = collections.deque(maxlen=capacity)
        self.count = 0
        self._step: Optional[StepSpan] = None
        self._range = None    # the open phase's profiler range, while one records

    # ---------------------------------------------------------------- #
    # Recording (the engine)                                           #
    # ---------------------------------------------------------------- #
    def begin(self, clock: float) -> None:
        """Open a step and its ``engine.schedule`` phase."""
        if torch.autograd._profiler_enabled():
            self._range = _range(PHASES[0])
        t = time.perf_counter()
        step = self._step = StepSpan(self.count, t, clock)
        self.count += 1
        self._ring.append(step)
        step.marks.append((PHASES[0], t))

    def enter(self, name: str, t: Optional[float] = None) -> None:
        """Close the open phase at ``t`` (now by default) and open ``name``
        there. Outside a step (a stage run on its own) nothing is recorded."""
        if self._step is None:
            return
        if t is None:
            t = time.perf_counter()
        self._step.marks.append((name, t))
        if self._range is not None:
            # the next range opens before the last closes: no host time
            # between two phases falls outside both on the trace
            last, self._range = self._range, _range(name)
            last.__exit__(None, None, None)

    def tag(self, kind: str, shape: Tuple[int, ...]) -> None:
        """Name the stage the open step ran."""
        step = self._step
        if step is not None:
            step.kind, step.shape = kind, tuple(shape)

    def end(self) -> None:
        """Close the open phase and the step."""
        self._step.end = time.perf_counter()
        self._step = None
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None

    # ---------------------------------------------------------------- #
    # Reading                                                          #
    # ---------------------------------------------------------------- #
    def since(self, mark: int) -> List[StepSpan]:
        """The steps begun since ``mark``, a value ``count`` had, oldest
        first. Raises if the ring has dropped any of them."""
        n = self.count - mark
        if n > len(self._ring):
            raise RuntimeError(
                f"host spans wrapped: {n} steps since the mark, the ring keeps {len(self._ring)}")
        return list(self._ring)[len(self._ring) - n:]


def _range(name: str):
    r = _RecordFunctionFast(name)
    r.__enter__()
    return r
