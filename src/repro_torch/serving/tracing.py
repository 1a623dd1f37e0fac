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

Model code below the engine finds the tracer through `current()`: the
tracer whose span is open innermost on this thread (the engine's
``decode step`` or prefill span), or ``None`` outside any span, as in a
donor prefill.  A count that lives on the device (the experts a ``moe``
span's tokens chose) is deferred: `Tracer.defer` keeps the one-element tensor, and the
engine's `Tracer.read_back` of a step's output tokens copies every
deferred count to the host in the same transfer, so a count adds no
synchronisation of its own.

On the virtual clock (``LiveEngine(bandwidth=...)``) spans are still
host time: they say where the host spent its time, not when the modeled
network delivered.

`TRACER` is the process's tracer, the one an engine records into unless
it is given its own; a tracer belongs to one thread.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import math
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch

CAPACITY = 65_536

#: the tracer whose span is open innermost on this thread
_CURRENT: contextvars.ContextVar = contextvars.ContextVar("tracer",
                                                         default=None)


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
        self._deferred: List[Tuple[Span, str, torch.Tensor]] = []

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
        token = _CURRENT.set(self)
        try:
            yield s
        finally:
            _CURRENT.reset(token)
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

    def defer(self, span: Span, key: str, value: torch.Tensor) -> None:
        """Set ``span.counts[key]`` from the one-element integer tensor
        ``value`` at the next `read_back`."""
        self._deferred.append((span, key, value))

    def read_back(self, t: torch.Tensor) -> List[int]:
        """``t.tolist()`` of an integer tensor, with every deferred count
        read in the same device-to-host copy and set on its span."""
        if not self._deferred:
            return t.reshape(-1).tolist()
        n = t.numel()
        vals = torch.cat([t.reshape(-1).to(torch.int64)]
                         + [v.reshape(1) for _, _, v in self._deferred]
                         ).tolist()
        for (span, key, _), v in zip(self._deferred, vals[n:]):
            span.counts[key] = v
        self._deferred.clear()
        return vals[:n]

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


def current() -> Optional[Tracer]:
    """The tracer whose span is open innermost on this thread, if any."""
    return _CURRENT.get()
