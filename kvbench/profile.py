"""The traced run: spans the harness records around the engine's layers,
one ``torch.profiler`` session over a steady slice of the window, and
what the metric readers and the ``breakdown`` take from it.

Spans are ``record_function`` ranges, so they share the trace's clock
with the device's records: "step" around each ``LiveEngine.step()``,
"generator wait" while the schedule has nothing due, and inside a step
"fetch" (``LiveEngine._run_fetch_wall``: host decode and restore),
"suffix prefill" / "plain prefill" (``LiveEngine._prefill``) and
"decode step" (``paged_model.decode_paged``).  The inner three wrap the
engine's methods in the traced run only; one the program no longer has
is left out, and its time reads as "step".

The slice is the window's end: it opens between two steps and closes
when the window does, so the kernels of every step inside it finish
inside it (each step reads its tokens back).
"""
from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

INNER = ("fetch", "suffix prefill", "plain prefill", "decode step")
OUTER = ("step", "generator wait")


class Spans:
    """Record-function spans around the engine's layers (traced runs)."""

    def __init__(self, eng):
        from repro_torch.serving import paged_model
        self._restore = []
        self.span = torch.profiler.record_function
        if hasattr(eng, "_run_fetch_wall"):
            self._wrap(eng, "_run_fetch_wall", lambda *a, **k: "fetch")
        if hasattr(eng, "_prefill"):
            self._wrap(eng, "_prefill", lambda req, *a, **k: (
                "suffix prefill" if req.needs_fetch else "plain prefill"))
        if hasattr(paged_model, "decode_paged"):
            self._wrap(paged_model, "decode_paged",
                       lambda *a, **k: "decode step")

    def _wrap(self, owner, attr: str, label) -> None:
        fn = getattr(owner, attr)
        span = self.span

        def wrapped(*a, **k):
            with span(label(*a, **k)):
                return fn(*a, **k)
        had = attr in vars(owner)
        setattr(owner, attr, wrapped)
        self._restore.append((owner, attr, fn if had else None))

    def close(self) -> None:
        for owner, attr, fn in reversed(self._restore):
            if fn is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, fn)
        self._restore.clear()


class Slicer:
    """One profiler session from the first step boundary after ``start``
    (host clock) to ``finish()``, at the window's close."""

    def __init__(self, start: float, device: torch.device):
        self.start, self.device = start, device
        self.prof = None
        self.rf = None
        self.t0 = self.t1 = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def boundary(self, now: float) -> None:
        if self.prof is None and now >= self.start:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._sync()
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self.rf = torch.profiler.record_function("kvbench.slice")
            self.rf.__enter__()
            self.t0 = time.monotonic()

    def finish(self) -> None:
        if self.prof is not None and self.t1 is None:
            self._sync()
            self.t1 = time.monotonic()
            self.rf.__exit__(None, None, None)
            self.prof.stop()

    def summary(self, steps) -> Optional["Slice"]:
        if self.prof is None:
            return None
        return Slice(self.prof.profiler.kineto_results.events(),
                     (self.t0, self.t1),
                     [s for s in steps if s.t0 >= self.t0 and s.t1 <= self.t1])


def _interval(e) -> Tuple[int, int]:
    return e.start_ns(), e.end_ns()


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Slice:
    """The profiled slice: device records, host spans, the steps inside
    it, and its host wall time."""

    def __init__(self, events, host: Tuple[float, float], steps):
        on_device = torch.autograd.DeviceType.CUDA
        self.host = host
        self.steps = steps
        self.wall_s = host[1] - host[0]
        marks = [e for e in events if e.name() == "kvbench.slice"
                 and e.device_type() != on_device]
        self.bounds = _interval(marks[0]) if marks else None
        dev = [e for e in events if e.device_type() == on_device
               and not e.is_user_annotation()]
        if self.bounds is not None:
            lo, hi = self.bounds
            dev = [e for e in dev if e.end_ns() > lo and e.start_ns() < hi]
        self.device = [(e.name(), *_interval(e)) for e in dev]
        self.spans = [(e.name(), *_interval(e)) for e in events
                      if e.device_type() != on_device
                      and e.name() in INNER + OUTER]
        launches = {e.correlation_id() for e in events
                    if e.device_type() != on_device
                    and "LaunchKernel" in e.name()}
        recorded = {e.correlation_id() for e in dev} & launches
        print(f"[kvbench] trace: {len(launches)} kernel launches on the "
              f"host, {len(recorded)} with a device record; "
              f"{len(self.device)} device records in the slice",
              file=sys.stderr, flush=True)
        self.complete = bool(launches) and len(recorded) == len(launches)

    @property
    def window_s(self) -> float:
        if self.bounds is None:
            return self.wall_s
        return (self.bounds[1] - self.bounds[0]) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        if self.bounds is None:
            return []
        lo, hi = self.bounds
        return union([(max(a, lo), min(b, hi)) for _, a, b in self.device])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def kernel_time(self, *names: str) -> Tuple[float, int]:
        """(seconds, records) of the device records whose name holds any
        of ``names``."""
        hit = [(b - a) for n, a, b in self.device
               if any(s in n for s in names)]
        return sum(hit) / 1e9, len(hit)

    def _label(self, a: int, b: int) -> str:
        """What the host was doing over [a, b]: the inner span that
        covers most of it, else the outer one, else the harness."""
        for group in (INNER, OUTER):
            best, most = None, 0
            for name, s, e in self.spans:
                if name in group:
                    cover = min(b, e) - max(a, s)
                    if cover > most:
                        best, most = name, cover
            if best is not None:
                return best
        return "harness"

    def gaps(self, longest: int = 10) -> List[Tuple[str, float]]:
        """The ``longest`` idle gaps of the slice, each labelled by what
        the host was doing."""
        if self.bounds is None:
            return []
        lo, hi = self.bounds
        found, at = [], lo
        for a, b in self.busy_intervals() + [(hi, hi)]:
            if a > at:
                found.append((at, a))
            at = max(at, b)
        found.sort(key=lambda g: g[0] - g[1])
        return [(self._label(a, b), (b - a) / 1e9)
                for a, b in found[:longest]]

    def breakdown(self) -> Dict[str, list]:
        ops: Dict[str, float] = {}
        for n, a, b in self.device:
            ops[n] = ops.get(n, 0.0) + (b - a) / 1e9
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:120], s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in self.gaps()]}
