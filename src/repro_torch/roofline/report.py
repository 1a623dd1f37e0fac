"""Render the roofline table from dryrun_results_torch/*.json, the port's
dry-run records (``launch/dryrun.py``): the counterpart of
``repro/roofline/report.py``, the same table.

    PYTHONPATH=src python -m repro_torch.roofline.report [--mesh single]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List

from repro_torch.configs.base import ASSIGNED_ARCHS, INPUT_SHAPES

DEFAULT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "dryrun_results_torch")


def load(results_dir: str = DEFAULT_DIR) -> List[dict]:
    out = []
    for p in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(p) as f:
            out.append(json.load(f))
    return out


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x * 1e6:.0f}us"
    if x < 1:
        return f"{x * 1e3:.1f}ms"
    return f"{x:.2f}s"


def table(records: List[dict], mesh: str = "single") -> str:
    rows = ["| arch | shape | step | compute | memory | collective | "
            "dominant | useful/HLO | bytes/dev | status |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    order = {a: i for i, a in enumerate(ASSIGNED_ARCHS)}
    shape_order = {s: i for i, s in enumerate(INPUT_SHAPES)}
    recs = [r for r in records if r["mesh"] == mesh]
    recs.sort(key=lambda r: (order.get(r["arch"], 99),
                             shape_order.get(r["shape"], 9)))
    for r in recs:
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | — "
                        f"| — | — | SKIP: {r.get('reason', r.get('error', ''))[:40]} |")
            continue
        rf = r["roofline"]
        mem = r.get("memory", {})
        dev_bytes = (mem.get("argument_size_in_bytes", 0)
                     + mem.get("temp_size_in_bytes", 0)
                     - mem.get("alias_size_in_bytes", 0))
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['description'].split()[0]} "
            f"| {fmt_s(rf['compute_s'])} | {fmt_s(rf['memory_s'])} "
            f"| {fmt_s(rf['collective_s'])} "
            f"| {rf['dominant'].replace('_s', '')} "
            f"| {rf['useful_flops_ratio']:.2f} "
            f"| {dev_bytes / 1e9:.1f}GB | ok |")
    return "\n".join(rows)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--dir", default=DEFAULT_DIR)
    args = ap.parse_args()
    print(table(load(args.dir), args.mesh))


if __name__ == "__main__":
    main()
