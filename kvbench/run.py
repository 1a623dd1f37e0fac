#!/usr/bin/env python3
"""The benchmark's one command:

    python3 kvbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Serves the cell of ``BENCHMARK.json`` on one card through the port's
``LiveEngine`` and prints, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``compared`` (each number the
check compared, with its limit; also the last lines of standard error).
Exits non-zero with no result without a card, or if JAX or the JAX
package was loaded.
"""
from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

# one process with few threads: the engine's host work (the numpy codec,
# the scheduler, the launches) runs on one thread, and idle worker pools
# would only contend with it for the host's cores
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from kvbench import harness
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    files = harness.cell_files(bench, args.workload, bool(args.trace))
    chips = int(files.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"kvbench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # the configuration's float32 products, TF32 off, as the port runs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    result = harness.run_cell(files, args.seed, args.seconds,
                              bool(args.trace), device, T_PROCESS)
    found = harness.forbidden_modules()
    if found:
        print(f"kvbench: the run loaded {found}; the benchmark measures "
              f"the port alone", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared: {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
