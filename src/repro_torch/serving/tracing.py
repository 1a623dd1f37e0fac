"""Spans the serving engine records where its work happens.

A `Span` is a named interval of host time on ``time.monotonic()``, the
clock of ``Request``'s stamps on the wall clock, with the id of the
request it served (``None`` for the engine's own), the span it ran inside
and a few counts.  A `Tracer` keeps the newest ``capacity`` finished
spans in memory and counts the ones it dropped; `Tracer.spans` answers
``None`` for a window whose spans it may have dropped, so a reader never
reads a truncated window.

While a ``torch.profiler`` session is on, each span also enters
``torch.profiler.record_function(name)``, which puts it on the
profiler's clock beside the device's records.  With no session on, a
span costs a flag check and two clock reads.

On the virtual clock (``LiveEngine(bandwidth=...)``) spans are still
host time: they say where the host spent its time, not when the modeled
network delivered.

`TRACER` is the process's tracer, the one an engine records into unless
it is given its own; a tracer belongs to one thread.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import time
from typing import Dict, Iterator, List, Optional

import torch

CAPACITY = 65_536


@dataclasses.dataclass
class Span:
    name: str
    rid: Optional[int]
    parent: Optional["Span"]  # the open span this one ran inside
    t0: float
    t1: Optional[float] = None  # set when the span closes, if not before
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Tracer:
    """A bounded buffer of finished spans."""

    def __init__(self, capacity: int = CAPACITY):
        self.done: collections.deque = collections.deque(maxlen=capacity)
        self.dropped = 0
        # the latest end of a dropped span: a window that reaches back to
        # it may have lost spans
        self._dropped_until = -math.inf
        self._open: List[Span] = []

    @contextlib.contextmanager
    def span(self, name: str, rid: Optional[int] = None,
             **counts: float) -> Iterator[Span]:
        """Record the body as a span, inside the innermost open span of
        this tracer.  The body may add counts or set ``t1`` itself."""
        rf = None
        if torch.autograd._profiler_enabled():  # the profiler's own flag
            rf = torch.profiler.record_function(name)
            rf.__enter__()
        s = Span(name, rid, self._open[-1] if self._open else None,
                 time.monotonic(),  # repro-lint: allow(no-wall-clock)
                 counts=counts)
        self._open.append(s)
        try:
            yield s
        finally:
            if s.t1 is None:
                s.t1 = time.monotonic()  # repro-lint: allow(no-wall-clock)
            self._open.pop()
            if rf is not None:
                rf.__exit__(None, None, None)
            if len(self.done) == self.done.maxlen:
                self.dropped += 1
                self._dropped_until = max(self._dropped_until,
                                          self.done[0].t1)
            self.done.append(s)

    def spans(self, name: str, since: float = -math.inf,
              until: float = math.inf) -> Optional[List[Span]]:
        """The finished spans called ``name`` that end in [since, until],
        in the order they finished; ``None`` if a span that ended there
        was dropped."""
        if self.dropped and self._dropped_until >= since:
            return None
        return [s for s in self.done
                if s.name == name and since <= s.t1 <= until]


TRACER = Tracer()
