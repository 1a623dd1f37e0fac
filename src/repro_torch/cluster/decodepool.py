"""Decode pool: N decoder instances with profiled latency lookup tables
(NVDEC chips on GPUs; host-CPU rANS workers in the TPU adaptation)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.adaptive import DecodeTable


@dataclasses.dataclass
class DecodeStats:
    jobs: int = 0
    busy_time: float = 0.0
    first_start: float = float("inf")
    last_end: float = 0.0

    def utilization(self, n_decoders: int) -> float:
        span = max(self.last_end - min(self.first_start, self.last_end),
                   1e-9)
        return self.busy_time / (span * n_decoders)


class DecodePool:
    def __init__(self, table: DecodeTable,
                 n_decoders: Optional[int] = None):
        self.table = table
        self.n = n_decoders or table.n_decoders
        self.busy_until = [0.0] * self.n
        self.active_resolution: Optional[str] = None
        self.stats = DecodeStats()

    def load_at(self, t: float) -> int:
        return sum(1 for b in self.busy_until if b > t)

    def decode(self, resolution: str, t_ready: float,
               size_scale: float = 1.0) -> Tuple[float, float]:
        """Schedule one chunk decode; returns (t_start, t_done).

        size_scale scales the table latency for chunks smaller/larger than
        the profile's reference chunk.
        """
        i = int(np.argmin(self.busy_until))
        t_start = max(t_ready, self.busy_until[i])
        conc = self.load_at(t_start) + 1
        lat = self.table.decode_latency(resolution, conc) * size_scale
        if (self.active_resolution is not None
                and resolution != self.active_resolution):
            lat += self.table.penalty[resolution]
        self.active_resolution = resolution
        t_done = t_start + lat
        self.busy_until[i] = t_done
        st = self.stats
        st.jobs += 1
        st.busy_time += lat
        st.first_start = min(st.first_start, t_start)
        st.last_end = max(st.last_end, t_done)
        return t_start, t_done
