"""Arithmetic the metric readers (``metrics/<name>.py``) share.  A reader
returns ``None`` when its run holds nothing to read, and the harness then
leaves the metric out of the result."""
from __future__ import annotations

from typing import Optional

from kvbench import flops, stats


def window_steps(run):
    lo, hi = run.window
    return [s for s in run.steps if s.t0 >= lo and s.t1 <= hi]


def model_mfu(run) -> Optional[float]:
    """Model operations of every prefill and decode token in the traced
    slice over its wall time at the fp32 peak, in %."""
    sl = run.trace
    if sl is None or not sl.steps:
        return None
    m = run.model
    work = sum(flops.prefill_flops(m, a, n) for s in sl.steps
               for a, n in s.prefills)
    work += sum(flops.decode_flops(m, c) for s in sl.steps
                for c in s.decodes)
    if work == 0:
        return None
    return 100.0 * work / (sl.wall_s * flops.FP32_FLOPS_PER_S)


def roofline(run, once, names, calls_and_bound) -> Optional[float]:
    """Sum of the bound times of an op's calls over the device time of
    its kernels' records (``names``) in the slice, in %; ``None`` unless
    the trace holds a record of ``once``, the kernel each call launches
    once, for every call the steps made (the profiler can lose records,
    and a partial sum would read too high)."""
    sl = run.trace
    if sl is None:
        return None
    calls, bound = calls_and_bound(run, sl.steps)
    _, records = sl.kernel_time(once)
    dev_s, _ = sl.kernel_time(*names)
    if calls == 0 or records != calls or dev_s <= 0:
        return None
    return 100.0 * bound / dev_s


def idle_share(run) -> Optional[float]:
    sl = run.trace
    if sl is None or sl.busy_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)


def p(values, q: float, scale: float = 1.0) -> Optional[float]:
    v = stats.percentile(values, q)
    return None if v is None else v * scale
