#!/usr/bin/env python3
"""Readings that set a cell's correctness limit, on the card:

    python3 kvbench/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds 15

For each seed, one run of the cell with a short window at the cell's own
load, judged twice by the harness's own ``check.judge`` against the
cell's limits file, over the same sample: the program's served tokens
(the lower reading, ``correct`` expected true) and the control in their
place, the tokens that the float32 reference with TF32 on puts first at
each position of the same prompts and tokens (the upper reading,
``correct`` expected false).  One process for all seeds; prints one line
per seed and a JSON summary last.
"""
from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def control_tokens(out) -> dict:
    """The TF32 reference's first choice at each position of each sampled
    request's prompt and served tokens."""
    from kvbench import check
    chk = out.bench.files.mix["check"]
    picked = check.sample(out.run.records, out.served, out.bench.seed,
                          chk["min_tokens"], chk["max_requests"])
    ctl = check.Reference(out.bench, tf32=True)
    return {r.req.rid: ctl.logits(r.spec, out.served[r.req.rid])
            .argmax(-1).tolist() for r in picked}


def both(files, seed: int, seconds: float, device) -> dict:
    """The program's verdict and the control's, over one run."""
    from kvbench import check, harness
    out = harness.serve(files, seed, seconds, False, device,
                        time.monotonic())
    program = check.judge(out.bench, out.run, out.served, files.limits,
                          seed)
    control = check.judge(out.bench, out.run, out.served, files.limits,
                          seed, chosen=control_tokens(out))
    return {"program": program, "control": control}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from kvbench import harness
    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    files = harness.cell_files(bench, args.workload, False)
    files.metrics = []
    device = torch.device("cuda", 0)
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.monotonic()
        v = both(files, seed, args.seconds, device)
        rows.append({"seed": seed, **{side: {"correct": v[side]["correct"],
                                             **v[side]["readings"]}
                                      for side in v}})
        print(f"[control] {args.workload} seed {seed}: "
              + "; ".join(f"{side} correct {v[side]['correct']} "
                          + " ".join(f"{k} {x!r}" for k, x in
                                     sorted(v[side]["readings"].items()))
                          for side in v)
              + f"; {time.monotonic() - t0:.1f} s", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "rows": rows,
                      "device": torch.cuda.get_device_name(device)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
