"""Adaptive-resolution KV fetching (paper §3.3.2 + Alg. 1 + Appx A.2).

Per chunk: predict bandwidth from history, then pick the resolution whose
*total pipelined time* — ``max(transmission, decode) + switch_penalty``
— is smallest, using profiled (resolution x decoder-pool-concurrency)
latency lookup tables.  In the pipelined fetch the transmit of chunk
``i+1`` overlaps the decode of chunk ``i``, so the steady-state cost of
a resolution is the slower of its two stages (Appx A.3), not their
difference: minimizing the |transmit - decode| *bubble* (the selector's
earlier objective) favors balanced stages even when both are slow,
while the ABR objective (ISSUE 7) favors whichever resolution actually
delivers-and-decodes fastest end to end — minimum total pipelined time,
not maximum compression.

The paper's H20 / L20 / A100 NVDEC tables are reproduced verbatim; a
"host-cpu" table calibrated against this repo's own rANS+restore decode
path is included for the TPU-adapted deployment (DESIGN.md §2).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.layout import RESOLUTION_ORDER

GBPS = 1e9 / 8  # bytes per second per Gbps


@dataclasses.dataclass(frozen=True)
class DecodeTable:
    """Decode latency (s) by (resolution, pool concurrency), + penalty."""
    name: str
    n_decoders: int
    latency: Dict[str, Tuple[float, ...]]  # res -> latency[concurrency-1]
    penalty: Dict[str, float]
    chunk_size_mb: Dict[str, float]

    def decode_latency(self, res: str, concurrency: int) -> float:
        lat = self.latency[res]
        return lat[min(max(concurrency, 1), len(lat)) - 1]


# --- paper Appendix A.2, Tables 1-3 (verbatim) -----------------------------

H20_TABLE = DecodeTable(
    name="h20", n_decoders=7,
    latency={
        "240p": (0.21, 0.22, 0.29, 0.32, 0.46, 0.52, 0.62),
        "480p": (0.20, 0.22, 0.30, 0.31, 0.42, 0.43, 0.51),
        "640p": (0.20, 0.21, 0.29, 0.30, 0.37, 0.41, 0.45),
        "1080p": (0.19, 0.19, 0.26, 0.30, 0.35, 0.40, 0.43),
    },
    penalty={"240p": 0.08, "480p": 0.06, "640p": 0.03, "1080p": 0.0},
    chunk_size_mb={"240p": 180, "480p": 205, "640p": 235, "1080p": 256},
)

L20_TABLE = DecodeTable(
    name="l20", n_decoders=3,
    latency={
        "240p": (0.18, 0.18, 0.19),
        "480p": (0.175, 0.178, 0.183),
        "640p": (0.17, 0.175, 0.175),
        "1080p": (0.16, 0.16, 0.161),
    },
    penalty={"240p": 0.06, "480p": 0.06, "640p": 0.04, "1080p": 0.0},
    chunk_size_mb={"240p": 180, "480p": 205, "640p": 235, "1080p": 256},
)

A100_TABLE = DecodeTable(
    name="a100", n_decoders=5,
    latency={
        "240p": (0.25, 0.252, 0.252, 0.26, 0.29),
        "480p": (0.24, 0.241, 0.25, 0.26, 0.27),
        "640p": (0.231, 0.235, 0.24, 0.25, 0.27),
        "1080p": (0.20, 0.21, 0.22, 0.24, 0.25),
    },
    penalty={"240p": 0.04, "480p": 0.04, "640p": 0.03, "1080p": 0.0},
    chunk_size_mb={"240p": 180, "480p": 205, "640p": 235, "1080p": 256},
)

# TPU-adapted deployment: entropy decode runs on the host CPUs fronting each
# chip (measured: rANS ~20 MB/s/worker in this repo, 8 workers/host).
HOST_CPU_TABLE = DecodeTable(
    name="host-cpu", n_decoders=8,
    latency={
        "240p": (0.9, 0.92, 0.95, 1.0, 1.1, 1.2, 1.35, 1.5),
        "480p": (1.0, 1.02, 1.06, 1.12, 1.25, 1.35, 1.5, 1.7),
        "640p": (1.15, 1.18, 1.22, 1.3, 1.4, 1.55, 1.7, 1.9),
        "1080p": (1.3, 1.33, 1.38, 1.45, 1.6, 1.75, 1.9, 2.1),
    },
    penalty={"240p": 0.05, "480p": 0.04, "640p": 0.02, "1080p": 0.0},
    chunk_size_mb={"240p": 180, "480p": 205, "640p": 235, "1080p": 256},
)

TABLES = {t.name: t for t in (H20_TABLE, L20_TABLE, A100_TABLE,
                              HOST_CPU_TABLE)}


# ---------------------------------------------------------------------------
# Bandwidth estimation
# ---------------------------------------------------------------------------

class BandwidthEstimator:
    """EWMA over observed per-chunk throughput (paper: last chunk)."""

    def __init__(self, init_bps: float, alpha: float = 1.0):
        self.est = init_bps
        self.alpha = alpha  # 1.0 == paper's last-chunk estimator

    def observe(self, nbytes: int, seconds: float) -> None:
        if seconds <= 0:
            return
        sample = nbytes / seconds
        self.est = self.alpha * sample + (1 - self.alpha) * self.est


# ---------------------------------------------------------------------------
# Alg. 1 — ABR selection: minimum total pipelined time
# ---------------------------------------------------------------------------

def pipelined_time(bandwidth_bps: float,
                   pool_load: int,
                   table: DecodeTable,
                   resolution: str,
                   sizes_bytes: Optional[Dict[str, int]] = None,
                   active_resolution: Optional[str] = None) -> float:
    """Projected per-chunk pipelined delivery time of ``resolution``:
    ``max(tau_trans, tau_dec) + tau_pen`` (Appx A.3 steady state — the
    transmit of chunk i+1 overlaps the decode of chunk i, the decoder
    reconfiguration penalty is serial).  This is the quantity
    ``select_resolution`` minimizes; exposed separately so property
    tests can brute-force the argmin against the same formula.

    The decode term is the pool's steady-state *drain interval*, not
    one chunk's serial latency: a pipelined fetch keeps every decoder
    it can get busy, so with ``avail`` of the pool's ``n_decoders``
    free (``pool_load`` are taken by other work) the pool retires one
    of this flow's chunks every ``latency(conc) / avail`` seconds,
    profiled at the saturated concurrency ``conc``.  A busy pool both
    shrinks ``avail`` and pushes the latency up its concurrency
    column, so contention still steers the choice toward the rungs
    whose profiles degrade gracefully."""
    ref_size = table.chunk_size_mb[resolution] * 1e6
    size = (sizes_bytes[resolution]
            if sizes_bytes and resolution in sizes_bytes else ref_size)
    tau_trans = size / max(bandwidth_bps, 1.0)
    n = max(table.n_decoders, 1)
    avail = max(n - pool_load, 1)
    conc = min(pool_load + avail, n)
    # decode latency scales with the actual chunk size relative to the
    # profile's reference chunk (same scaling the decode pool applies)
    tau_dec = (table.decode_latency(resolution, conc)
               * max(size / ref_size, 0.05) / avail)
    tau_pen = (table.penalty[resolution]
               if active_resolution is not None
               and resolution != active_resolution else 0.0)
    return max(tau_trans, tau_dec) + tau_pen


def select_resolution(bandwidth_bps: float,
                      pool_load: int,
                      table: DecodeTable,
                      sizes_bytes: Optional[Dict[str, int]] = None,
                      active_resolution: Optional[str] = None,
                      resolutions: Sequence[str] = RESOLUTION_ORDER,
                      ) -> Tuple[str, float]:
    """Returns (r_opt, pipelined_seconds): the resolution minimizing the
    total pipelined per-chunk time (``pipelined_time``) and that time.
    Ties keep the earliest candidate in ``resolutions`` order, so the
    choice is deterministic.  ``sizes_bytes`` overrides the table sizes
    with the chunk's actual encoded sizes when known; ``active_resolution``
    charges the decoder-switch penalty to every *other* resolution, which
    makes the selection sticky: a switch must win by more than the
    reconfiguration it costs."""
    best, best_time = None, float("inf")
    for r in resolutions:
        if r not in table.latency:
            continue
        t = pipelined_time(bandwidth_bps, pool_load, table, r,
                           sizes_bytes=sizes_bytes,
                           active_resolution=active_resolution)
        if t < best_time:
            best, best_time = r, t
    assert best is not None
    return best, best_time
