"""Serving metrics: TTFT / TPOT aggregation over finished requests."""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np

from repro_torch.core.scheduler import Request


def summarize(requests: Iterable[Request]) -> Dict[str, float]:
    reqs = [r for r in requests if r.t_first_token is not None]
    ttfts = np.array([r.ttft for r in reqs], np.float64)
    tpots = np.array([r.tpot for r in reqs if r.tpot is not None],
                     np.float64)
    out: Dict[str, float] = {"n": float(len(reqs))}
    if ttfts.size:
        out.update(ttft_mean=float(ttfts.mean()),
                   ttft_p50=float(np.percentile(ttfts, 50)),
                   ttft_p99=float(np.percentile(ttfts, 99)),
                   ttft_max=float(ttfts.max()))
    if tpots.size:
        out.update(tpot_mean=float(tpots.mean()),
                   tpot_p99=float(np.percentile(tpots, 99)))
    return out


def split_summary(requests: Iterable[Request]) -> Dict[str, Dict[str, float]]:
    reqs = list(requests)
    return {
        "all": summarize(reqs),
        "fetching": summarize([r for r in reqs if r.needs_fetch]),
        "non_reuse": summarize([r for r in reqs if not r.needs_fetch]),
    }
