#!/usr/bin/env python3
"""Time the port's redesigned kernels against another checkout's, on one
card, in alternating turns.

    python3 tools/kernel_ab.py --other DIR   # DIR: another checkout

Each turn is a fresh process that imports ``repro_torch`` from one
checkout, builds its ``paged_attention``, ``ssd_scan``, ``kv_restore``
and ``token_delta`` sources and times one op call (device time of a
CUDA-graph replay, as ``chip_smoke.py`` times it) at the shapes of
``chip_smoke.py``: ``paged_attention`` at lwm-7b's and yi-34b's heads
over three 543-token contexts, ``ssd_scan`` at mamba2-2.7b's prefill
and, in a checkout that has ``ssd_scan_bwd``, its backward at the
training shape (b 1, s 2048, dy and dstate from the generator), also
split by CUDA kernel in the turn's one profiler session,
``kv_restore`` on one layer of one 8-token frame of lwm-7b and, in a
checkout that has ``kv_restore_layers``, on one 3-layer 16-token chunk;
the token-delta decode of a 40 x 128 x 416 stack (group 0's 240p plane)
and of a 64 x 1080 x 1920 stack, as the one-frame op chained over the
frames in one graph and, in a checkout that has
``token_delta_decode_frames``, as one call.  The turns run other,
this, this, other; each prints one JSON line, and the script ends with
the card's name and power limit.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]


def turn(root: str) -> dict:
    sys.path.insert(0, str(pathlib.Path(root) / "src"))
    import torch
    from repro_torch.kernels.kv_restore import ops as kv_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.token_delta import ops as td_ops

    dev = torch.device("cuda", 0)

    def graph_us(fn, iters=50, reps=5):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            for _ in range(iters):
                fn()
        out = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end) * 1e3 / iters)
        return statistics.median(out)

    def kernel_us(fn, iters=5):
        """Device µs per call of each CUDA kernel that fn launches, from
        the process's one profiler session."""
        fn()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            t = e.device_time_total
            if t > 0 and e.key != "cudaLaunchKernel":
                name = e.key.replace("(anonymous namespace)::", "")
                name = name.removeprefix("void ").split("<")[0]
                name = name.split("(")[0].split("::")[-1]
                out[name] = out.get(name, 0.0) + t / iters
        return out

    g = torch.Generator(device=dev).manual_seed(0)
    res = {"root": root}
    lens, ps = [543, 543, 543], 16
    for name, H, K in (("lwm-7b", 32, 32), ("yi-34b", 56, 8)):
        B, hd = len(lens), 128
        bps = max(-(-n // ps) for n in lens) + 2
        q = torch.randn(B, H, hd, device=dev, generator=g)
        kp = torch.randn(B * bps, ps, K, hd, device=dev, generator=g)
        vp = torch.randn(B * bps, ps, K, hd, device=dev, generator=g)
        bt = torch.randperm(B * bps, device=dev, generator=g).reshape(
            B, bps).to(torch.int32)
        cl = torch.tensor(lens, dtype=torch.int32, device=dev)
        res[f"paged_attention {name} us"] = graph_us(
            lambda: pa_ops.paged_attention(q, kp, vp, bt, cl))
    b, s, nh, hd, G, S = 1, 2048, 80, 64, 1, 128
    args = (torch.randn(b, s, nh, hd, device=dev, generator=g),
            -torch.nn.functional.softplus(
                torch.randn(b, s, nh, device=dev, generator=g)),
            torch.randn(b, s, G, S, device=dev, generator=g),
            torch.randn(b, s, G, S, device=dev, generator=g))
    res["ssd_scan mamba2-2.7b us"] = graph_us(
        lambda: ssd_ops.ssd_scan(*args, chunk=64), iters=10)
    if hasattr(ssd_ops, "ssd_scan_bwd"):
        dy = torch.randn(b, s, nh, hd, device=dev, generator=g)
        dstate = torch.randn(b, nh, hd, S, device=dev, generator=g)
        res["ssd_scan_bwd mamba2-2.7b us"] = graph_us(
            lambda: ssd_ops.ssd_scan_bwd(*args, dy, dstate, chunk=64),
            iters=10)
        res["ssd_scan_bwd kernels us"] = kernel_us(
            lambda: ssd_ops.ssd_scan_bwd(*args, dy, dstate, chunk=64))
    H, D, R = 32, 128, 2048
    pages = torch.randn(32, R, H, D, device=dev, generator=g)
    q = torch.randint(0, 256, (3, 16, H, D), device=dev, generator=g,
                      dtype=torch.uint8)
    sc = torch.rand(3, H, device=dev, generator=g) + 0.05
    slots = torch.randperm(R, device=dev, generator=g)[:16].to(torch.int32)
    res["kv_restore lwm-7b frame us"] = graph_us(
        lambda: kv_ops.kv_restore(pages[0], q[0, :8], sc[0], slots[:8]))
    if hasattr(kv_ops, "kv_restore_layers"):
        res["kv_restore_layers lwm-7b chunk us"] = graph_us(
            lambda: kv_ops.kv_restore_layers(pages, (0, 1, 2), q, sc, slots))
    for shape in ((40, 128, 416), (64, 1080, 1920)):
        z = torch.randint(0, 256, shape, device=dev, generator=g,
                          dtype=torch.uint8)
        zero = torch.zeros_like(z[0])
        tag = "x".join(map(str, shape))

        def chained():
            prev = zero
            for f in range(shape[0]):
                prev = td_ops.token_delta_decode_frame(prev, z[f])
        res[f"token_delta_decode_frame chained {tag} us"] = graph_us(
            chained, iters=10)
        if hasattr(td_ops, "token_delta_decode_frames"):
            res[f"token_delta_decode_frames {tag} us"] = graph_us(
                lambda: td_ops.token_delta_decode_frames(zero, z))
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="another checkout to time against")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.turn:
        print(json.dumps(turn(a.turn)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab.py: no CUDA device", flush=True)
        return 1
    rc = 0
    for root in (a.other, str(HERE), str(HERE), a.other):
        rc |= subprocess.call([sys.executable, __file__, "--turn", root])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return rc


if __name__ == "__main__":
    sys.exit(main())
