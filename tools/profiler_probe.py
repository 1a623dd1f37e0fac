#!/usr/bin/env python3
"""When does ``torch.profiler`` lose the device records of a kernel?

    python3 tools/profiler_probe.py
    TEARDOWN_CUPTI=0 python3 tools/profiler_probe.py   # keep CUPTI up

One process profiles a series of short sessions, each around one
``ssd_scan`` call at the Mamba2 prefill shape (two kernels launched
through ``ctypes``) or one small PyTorch kernel, and prints for each the
launches the profiler saw on the host and the kernel records it got back
from the device.  Between sessions it captures a CUDA graph, makes small
launches for 60 s, idles for 60 s, and allocates and frees 12 GB; one
session is padded by a quarter second of host sleep on each side.  This
is why ``chip_smoke.py`` counts kernels per op call in a child process
whose only session that is.  Needs one CUDA card; imports nothing of
JAX.
"""
from __future__ import annotations

import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402

T0 = time.perf_counter()


def log(*a) -> None:
    print(f"[{time.perf_counter() - T0:7.1f} s]", *a, flush=True)


def session(fn, label: str, pad_s: float = 0.0) -> None:
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(pad_s)
        fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    events = prof.profiler.kineto_results.events()
    on_device = torch.autograd.DeviceType.CUDA
    records = [e.name()[:30] for e in events if e.device_type() == on_device]
    launches = sum(e.device_type() != on_device and "Launch" in e.name()
                   for e in events)
    log(f"{label}: {launches} launches on the host, {len(records)} kernel "
        f"records from the device {records}")


def main() -> int:
    if not torch.cuda.is_available():
        print("profiler_probe.py: no CUDA device", flush=True)
        return 1
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    args = (torch.randn(1, 2048, 80, 64, device=dev, generator=g),
            -torch.nn.functional.softplus(
                torch.randn(1, 2048, 80, device=dev, generator=g)),
            torch.randn(1, 2048, 1, 128, device=dev, generator=g),
            torch.randn(1, 2048, 1, 128, device=dev, generator=g))

    def scan():
        ssd_ops.ssd_scan(*args, chunk=64)
    x = torch.zeros(16, device=dev)

    def tiny():
        x.add_(1.0)
    scan()
    torch.cuda.synchronize()
    session(scan, "first session, ssd_scan")
    session(tiny, "then one PyTorch kernel")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        scan()
    graph.replay()
    torch.cuda.synchronize()
    del graph
    session(scan, "after a CUDA graph capture, ssd_scan")
    t, n = time.perf_counter(), 0
    while time.perf_counter() - t < 60:
        for _ in range(1000):
            x.mul_(0.5)
        n += 1000
        torch.cuda.synchronize()
    log(f"60 s of small launches without the profiler: {n} launches")
    session(scan, "ssd_scan")
    session(scan, "ssd_scan again")
    session(tiny, "one PyTorch kernel")
    session(scan, "ssd_scan, window padded", pad_s=0.25)
    time.sleep(60)
    log("60 s idle")
    session(scan, "ssd_scan")
    session(tiny, "one PyTorch kernel")
    session(scan, "ssd_scan again")
    big = [torch.empty(1 << 30, dtype=torch.uint8, device=dev)
           for _ in range(12)]
    del big
    torch.cuda.empty_cache()
    session(scan, "after 12 GB allocated and freed, ssd_scan")
    return 0


if __name__ == "__main__":
    sys.exit(main())
