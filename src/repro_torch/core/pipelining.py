"""Layer-wise fetching-inference pipeline admission (paper Appx. A.3).

A fetching request may enter the running queue before all its layers'
KV has been restored iff, for every unbuffered layer k,

    sum_{j<=k} T_decode(j)  <=  sum_{j<=k-1} T_comp(j)

i.e. layer k's KV is ready just before the engine finishes computing layer
k-1 — no execution stall. Chunked prefill makes T_comp predictable.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def non_blocking_ok(decode_times: Sequence[float],
                    comp_times: Sequence[float],
                    buffered_layers: int) -> bool:
    """True if early admission causes no pipeline stall."""
    d = np.asarray(decode_times, np.float64)
    c = np.asarray(comp_times, np.float64)
    L = d.size
    assert c.size == L
    if buffered_layers >= L:
        return True
    dec_cum = np.cumsum(d)
    comp_cum = np.concatenate([[0.0], np.cumsum(c)[:-1]])  # sum_{j<=k-1}
    ks = np.arange(buffered_layers, L)  # 0-based k
    return bool((dec_cum[ks] <= comp_cum[ks]).all())


def max_admission_buffer(decode_times: Sequence[float],
                         comp_times: Sequence[float]) -> int:
    """Smallest L_buf satisfying the non-blocking condition."""
    L = len(decode_times)
    for lb in range(L + 1):
        if non_blocking_ok(decode_times, comp_times, lb):
            return lb
    return L
