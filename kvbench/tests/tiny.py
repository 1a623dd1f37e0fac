"""Tiny cells for the CPU tests: a configuration, a mix, limits and a
``BENCHMARK.json`` entry written as files into a directory, laid out as
``kvbench/`` lays out its own."""
from __future__ import annotations

import json
import pathlib
import shutil

from kvbench import harness

DENSE = {"arch_type": "dense", "num_layers": 2, "d_model": 64,
         "num_heads": 4, "num_kv_heads": 2, "head_dim": 16, "d_ff": 96,
         "vocab_size": 256, "mlp_kind": "swiglu", "norm_eps": 1e-6,
         "rope_theta": 10000.0, "tie_embeddings": False}
MOE = {"arch_type": "moe", "num_layers": 3, "d_model": 64, "num_heads": 4,
       "num_kv_heads": 4, "head_dim": 16, "d_ff": 32, "dense_d_ff": 128,
       "vocab_size": 256, "mlp_kind": "swiglu", "num_experts": 8,
       "num_shared_experts": 1, "experts_per_token": 2,
       "first_layer_dense": True, "moe_capacity_factor": 1.25,
       "norm_eps": 1e-6, "rope_theta": 10000.0, "tie_embeddings": False}
REFERENCE = {"dense": "dense_gqa", "moe": "deepseek_moe"}

REUSE = {"loop": "closed", "clients": 2,
         "documents": {"count": 2, "tokens": 40},
         "question_tokens": [4, 16], "output_tokens": [3, 8], "pool": 400,
         "ramp_s": 0.2, "trace_slice_s": 0.5,
         "check": {"min_tokens": 12, "max_requests": 3}}
CHAT = {"loop": "open", "rate_per_s": 30.0, "prompt_tokens": [8, 40],
        "output_tokens": [3, 10], "pool": 40, "ramp_s": 0.2,
        "trace_slice_s": 0.5,
        "check": {"min_tokens": 20, "max_requests": 4}}

METRICS = ["ttft_reuse_p50_s", "ttft_plain_p90_s", "itl_p95_ms", "setup_s"]


def config(model: dict, name: str) -> dict:
    return {"name": name, "source": "test", "reference":
            REFERENCE[model["arch_type"]], "model": dict(model),
            "engine": {"max_running": 4, "page_size": 4,
                       "resolution": "240p"},
            "weights": {"embed_std": 0.02, "norm_std": 0.1}}


def write(base: pathlib.Path, model: dict, mix: dict, limit: float = 1e-3,
          metrics=METRICS, cell: str = "tiny.cell") -> dict:
    """Write one tiny cell's files under ``base`` (the metric readers
    copied from kvbench) and return its ``BENCHMARK.json``."""
    for sub in ("configs", "traffic", "limits"):
        (base / sub).mkdir(parents=True, exist_ok=True)
    if not (base / "metrics").exists():
        shutil.copytree(harness.HERE / "metrics", base / "metrics")
    (base / "configs" / "tiny.json").write_text(json.dumps(
        config(model, "tiny")))
    (base / "traffic" / "mix.json").write_text(json.dumps(mix))
    (base / "limits" / f"{cell}.json").write_text(json.dumps(
        {"served_gap": {"limit": limit}}))
    return {"configs": [{"name": "tiny", "file": str(base / "configs" /
                                                     "tiny.json")}],
            "workloads": [{"name": cell, "config": "tiny", "traffic": "mix",
                           "chips": 1}],
            "end_to_end": [{"name": n, "unit": "x"} for n in metrics],
            "per_layer": []}


def run(base: pathlib.Path, bench: dict, seed: int = 1, seconds=1.0,
        cell: str = "tiny.cell", trace: bool = False):
    import time

    import torch
    files = harness.cell_files(bench, cell, trace, root=pathlib.Path("/"),
                               base=base)
    return harness.run_cell(files, seed, seconds, trace,
                            torch.device("cpu"), time.monotonic())
