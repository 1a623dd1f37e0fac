"""What the metrics are taken over, on the harness's own records.

The percentile rule: linear interpolation between the closest ranks
(numpy's default, ``np.percentile(values, q)``), over every value the
window holds; no value, no percentile (``None``).
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    vals = np.asarray(list(values), np.float64)
    if vals.size == 0:
        return None
    return float(np.percentile(vals, q))


def in_window(t: Optional[float], window) -> bool:
    return t is not None and window[0] <= t <= window[1]


def ttfts(records: Iterable, window, reuse: Optional[bool] = None
          ) -> List[float]:
    """Time to first token from each request's due time, for every
    request whose first token falls in the window (``reuse`` picks reuse
    or plain requests; ``None`` both)."""
    out = []
    for r in records:
        if reuse is not None and r.reuse != reuse:
            continue
        if in_window(r.req.t_first_token, window):
            out.append(r.req.t_first_token - r.due)
    return out


def gaps(records: Iterable, window) -> List[float]:
    """Every gap between consecutive output tokens of every request with
    both tokens in the window."""
    out = []
    for r in records:
        t = r.req.token_times
        out.extend(b - a for a, b in zip(t, t[1:])
                   if window[0] <= a and b <= window[1])
    return out


def queue_waits(records: Iterable, window, reuse: Optional[bool] = None
                ) -> List[float]:
    """Due time to admission, for every request admitted in the window."""
    return [r.req.t_admitted - r.due for r in records
            if (reuse is None or r.reuse == reuse)
            and in_window(r.req.t_admitted, window)]


def fetch_times(records: Iterable, window) -> List[float]:
    """Fetch start to fetch done, for every fetch done in the window."""
    return [r.req.fetch_done - r.req.fetch_started for r in records
            if r.req.fetch_started is not None
            and in_window(r.req.fetch_done, window)]
