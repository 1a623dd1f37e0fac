"""The program's own spans (``repro_torch.serving.tracing``), as the
``program_span`` metrics read them: the process's tracer over the run's
window, joined to the run's requests by ``rid``.  Each function returns
an empty list where the program records no such span (a port without the
tracer) or the tracer dropped part of what it asks for, so the reader
returns ``None``."""
from __future__ import annotations

from typing import Callable, List

from kvbench import stats


def tracer():
    """The process's tracer, ``None`` in a port without one."""
    try:
        from repro_torch.serving import tracing
    except ImportError:
        return None
    return tracing.TRACER


def per_fetch(run, name: str, value: Callable) -> List[float]:
    """For every fetch done in the window, the sum of ``value(span)`` over
    its ``name`` spans: those of its request between its start and its
    end."""
    tr = tracer()
    fetches = [r.req for r in run.records if r.req.fetch_started is not None
               and stats.in_window(r.req.fetch_done, run.window)]
    if tr is None or not fetches:
        return []
    spans = tr.spans(name, min(q.fetch_started for q in fetches),
                     max(q.fetch_done for q in fetches))
    out = []
    for q in fetches:
        mine = [value(s) for s in spans or () if s.rid == q.rid
                and q.fetch_started <= s.t0 and s.t1 <= q.fetch_done]
        if not mine:
            return []
        out.append(sum(mine))
    return out


def plain_prefills(run) -> list:
    """The ``plain prefill`` spans of the run's plain requests that end in
    the window."""
    tr = tracer()
    if tr is None:
        return []
    rids = {r.req.rid for r in run.records if not r.reuse}
    return [s for s in tr.spans("plain prefill", *run.window) or ()
            if s.rid in rids]


def prefill_waits(run) -> List[float]:
    """For every plain request admitted in the window, its admission to
    the start of its ``plain prefill`` span: the wait behind the other
    prefills and fetches of its step."""
    tr = tracer()
    admitted = [r.req for r in run.records if not r.reuse
                and stats.in_window(r.req.t_admitted, run.window)]
    if tr is None or not admitted:
        return []
    spans = tr.spans("plain prefill", min(q.t_admitted for q in admitted))
    out = []
    for q in admitted:
        mine = [s.t0 for s in spans or () if s.rid == q.rid
                and s.t0 >= q.t_admitted]
        if not mine:
            return []
        out.append(mine[0] - q.t_admitted)
    return out


def inside(run, name: str) -> list:
    """The ``name`` spans that start and end in the window."""
    tr = tracer()
    if tr is None:
        return []
    return [s for s in tr.spans(name, *run.window) or ()
            if s.t0 >= run.window[0]]
