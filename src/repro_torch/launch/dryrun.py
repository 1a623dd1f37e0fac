"""Multi-pod dry run of the port: trace every (architecture x input shape)
on the production meshes and record FLOPs, bytes, memory and collective
bytes per device, with their roofline.

The counterpart of ``repro/launch/dryrun.py``.  Where the JAX package
lowers and compiles on 512 placeholder devices, the port opens a fake
process group of 256 or 512 ranks (``launch/mesh.py::fake_group``),
builds the production ``DeviceMesh`` over it, lays the step's inputs out
as DTensors of fake local shards (``launch/specs.py``) and runs the step
once under ``FakeTensorMode``: no memory is allocated and nothing runs on
the card.  A ``roofline.trace.TraceRecorder`` sees the ops on this rank's
local shards and the collectives of DTensor's redistributions, so every
number is per device:

* ``flops``, ``bytes_accessed``: the recorder's counts (its docstring);
* ``memory`` (bytes on one device): ``argument_size_in_bytes`` the local
  shards of the step's inputs, ``output_size_in_bytes`` those of its
  outputs, ``alias_size_in_bytes`` the outputs that are inputs updated
  in place (the train step's state), ``temp_size_in_bytes`` the peak of
  the live local bytes that the step allocated during the trace (the
  peak of all live local bytes minus the arguments);
* ``collectives``: bytes and counts per family;
* ``trace_s``: seconds to build the inputs and trace the step (in place
  of ``lower_s``/``compile_s``); ``wall_s`` the whole combination;
* ``custom_op_calls``: the calls of the port's custom ops in the trace
  (``repro_torch::ssd_scan_fwd`` once per Mamba2 layer and micro-batch);
* ``device_memory`` (card runs): the card's allocated bytes before and
  after the trace, which stay equal.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]
Results land in dryrun_results_torch/<arch>.<shape>.<mesh>.json; the card
is the device type unless ``--device`` names another.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.specs import build_dryrun, decode_overlay
from repro_torch.roofline.analysis import (
    bytes_split_from_trace, collective_bytes_from_trace, roofline_report,
)
from repro_torch.roofline.trace import (
    local_bytes, local_shard, recording, tensors_in,
)
from repro_torch.sharding import rules

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "dryrun_results_torch")


def _alias_bytes(out, args) -> int:
    """Local bytes of the outputs that are inputs updated in place (whose
    local shard shares an input's storage)."""
    keys = {local_shard(t).untyped_storage()._cdata
            for t in tensors_in(args)}
    return sum(local_bytes(t) for t in tensors_in(out)
               if local_shard(t).untyped_storage()._cdata in keys)


def _allocated(device: torch.device) -> int:
    return (torch.cuda.memory_allocated(device) if device.type == "cuda"
            else 0)


def run_one(arch: str, shape_name: str, mesh_kind: str,
            out_dir: str = RESULTS_DIR, verbose: bool = True,
            device: DeviceLike = None) -> dict:
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    ok, why = cfg.shape_supported(shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "status": None}
    if not ok:
        rec.update(status="skipped", reason=why)
        _save(rec, out_dir)
        return rec
    device = resolve_device(device)
    multi_pod = mesh_kind == "multipod"
    with mesh_lib.fake_group(512 if multi_pod else 256):
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                             device=device)
        overlay = decode_overlay(cfg, shape, mesh)
        # lower/compile wall timings are the dry-run's *measurement output*
        # (reported in the result record), not replayed state
        t0 = time.time()  # repro-lint: allow(no-wall-clock)
        try:
            with rules.activate(mesh, overlay=overlay):
                recipe = build_dryrun(cfg, shape, mesh)
                before = _allocated(device)
                with recording(recipe.fake_mode) as tr, \
                        implicit_replication():
                    out = recipe.fn(*recipe.args)
                    mem_rec = {
                        "temp_size_in_bytes": int(tr.peak_bytes),
                        "argument_size_in_bytes": local_bytes(recipe.args),
                        "output_size_in_bytes": local_bytes(out),
                        "alias_size_in_bytes": _alias_bytes(out,
                                                            recipe.args),
                    }
                    del out
                t_trace = time.time() - t0  # repro-lint: allow(no-wall-clock)
                after = _allocated(device)
            coll = collective_bytes_from_trace(tr)
            cost = {"flops": tr.flops, "bytes accessed": tr.bytes_accessed}
            n_dev = mesh.size()
            rec.update(
                status="ok",
                description=recipe.description,
                n_devices=int(n_dev),
                trace_s=round(t_trace, 2),
                flops=float(tr.flops),
                bytes_accessed=float(tr.bytes_accessed),
                memory=mem_rec,
                collectives=coll,
                roofline=roofline_report(cfg, shape, cost, coll, n_dev,
                                         scan_trips=1,
                                         bytes_split=bytes_split_from_trace(
                                             tr)),
                scan_trips=recipe.scan_trips,
                custom_op_calls={k: v for k, v in sorted(tr.calls.items())
                                 if k.startswith("repro_torch::")},
            )
            if device.type == "cuda":
                rec["device_memory"] = {"allocated_before": before,
                                        "allocated_after": after}
        except Exception as e:  # noqa: BLE001
            rec.update(status="error", error=f"{type(e).__name__}: {e}",
                       trace=traceback.format_exc()[-2000:])
        # repro-lint: allow(no-wall-clock) -- reported wall_s measurement
        rec["wall_s"] = round(time.time() - t0, 2)
    _save(rec, out_dir)
    if verbose:
        state = rec["status"]
        extra = (f" trace={rec.get('trace_s')}s "
                 f"flops={rec.get('flops', 0):.3e}"
                 if state == "ok" else rec.get("reason",
                                               rec.get("error", "")))
        print(f"[{state:>7}] {arch} x {shape_name} x {mesh_kind} {extra}",
              flush=True)
    return rec


def _save(rec: dict, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"{rec['arch']}.{rec['shape']}.{rec['mesh']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--device", default=None,
                    help="device type of the mesh and the fake shards "
                         "(default: the CUDA card)")
    args = ap.parse_args(argv)

    meshes = (["single", "multipod"] if args.mesh == "both"
              else [args.mesh])
    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = (list(INPUT_SHAPES) if (args.all or not args.shape)
              else [args.shape])
    n_ok = n_skip = n_err = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                rec = run_one(arch, shape, mesh_kind, args.out,
                              device=args.device)
                n_ok += rec["status"] == "ok"
                n_skip += rec["status"] == "skipped"
                n_err += rec["status"] == "error"
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
