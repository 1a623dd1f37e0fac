#!/usr/bin/env python3
"""What a span of the serving engine (``repro_torch.serving.tracing``)
costs: ``Tracer.span`` around an empty body, with no profiler session
on, inside a ``torch.profiler`` session of the host and, if there is
one, the CUDA card (where each span also enters ``record_function``),
and with no session again.  Prints one JSON line of nanoseconds a span.

    python3 tools/span_cost.py

Imports nothing of JAX.
"""
from __future__ import annotations

import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.serving import tracing  # noqa: E402


def per_span_ns(n: int) -> float:
    tr = tracing.Tracer()
    t0 = time.perf_counter()
    for _ in range(n):
        with tr.span("x"):
            pass
    return (time.perf_counter() - t0) / n * 1e9


def main() -> int:
    out = {"off_ns": per_span_ns(200_000)}
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        out["device"] = torch.cuda.get_device_name(0)
    with torch.profiler.profile(activities=acts):
        out["on_ns"] = per_span_ns(20_000)
    out["off_again_ns"] = per_span_ns(200_000)
    out["profiler_activities"] = [str(a) for a in acts]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
