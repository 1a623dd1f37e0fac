#!/usr/bin/env python3
"""The rate sweep of an open-loop cell, on the card:

    python3 kvbench/sweep.py --workload yi-9b.chat_plain \\
        --rates 1,1.5,2,2.5 --seconds 40 --seed 7

One set-up (weights), then for each rate a fresh engine fed the cell's
mix at that rate: the ramp, then ``--seconds`` measured.  A rate is
sustained when the queue does not grow: at most 2 requests wait for
admission when the window closes, and the median wait from due time to
admission over the window's second half stays under 1 s.  The cell's
rate is 4/5 of the highest rate sustained (written into its mix file by
hand).  Prints a line per rate and a JSON summary last.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
MAX_BACKLOG = 2
MAX_LATE_WAIT_S = 1.0


def measure(bench, rate: float, seconds: float) -> dict:
    from kvbench import harness, stats
    mix = bench.files.mix
    eng = bench.engine()
    bench.warm_up(eng)
    pool = math.ceil(rate * (mix["ramp_s"] + seconds) * 1.3) + 8
    drv = harness.LoadLoop(bench, eng, bench.specs(rate_per_s=rate,
                                                 pool=pool))
    t0 = time.monotonic()
    t_open = t0 + mix["ramp_s"]
    t_close = t_open + seconds
    drv.run_until(t0, t_close)
    w = (t_open, t_close)
    half = (t_open + seconds / 2, t_close)
    recs = drv.records
    backlog = sum(r.req.t_admitted is None for r in recs)
    late = stats.percentile(stats.queue_waits(recs, half), 50)
    row = {
        "rate_per_s": rate,
        "arrived_per_s": sum(t_open <= r.due <= t_close for r in recs)
        / seconds,
        "finished_per_s": sum(r.req.t_finished is not None
                              and t_open <= r.req.t_finished <= t_close
                              for r in recs) / seconds,
        "backlog_at_close": backlog,
        "queue_s_p50_second_half": late,
        "ttft_p95_s": stats.percentile(stats.ttfts(recs, w), 95),
        "itl_p95_ms": (stats.percentile(stats.gaps(recs, w), 95) or 0) * 1e3,
    }
    row["sustained"] = bool(backlog <= MAX_BACKLOG and late is not None
                            and late < MAX_LATE_WAIT_S)
    del drv, eng
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from kvbench import harness
    if not torch.cuda.is_available():
        print("sweep.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench_json = harness.load_json(ROOT / "BENCHMARK.json")
    files = harness.cell_files(bench_json, args.workload, False)
    if files.mix["loop"] != "open":
        print("sweep.py: an open-loop cell only", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = harness.Bench(files, args.seed, device)
    rows = []
    for rate in [float(r) for r in args.rates.split(",")]:
        row = measure(bench, rate, args.seconds)
        rows.append(row)
        print("[sweep] " + " ".join(f"{k}={v}" for k, v in row.items()),
              flush=True)
        torch.cuda.empty_cache()
    ok = [r["rate_per_s"] for r in rows if r["sustained"]]
    print(json.dumps({"workload": args.workload, "rows": rows,
                      "highest_sustained": max(ok) if ok else None,
                      "device": torch.cuda.get_device_name(device)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
