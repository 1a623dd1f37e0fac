"""Roofline analysis of the port's dry run (``launch/dryrun.py``).

Three terms per (arch x shape x mesh):
  compute    = FLOPs / (chips x peak_FLOP/s)
  memory     = bytes / (chips x HBM_bw)
  collective = collective_bytes / (chips x link_bw)

The counterpart of ``repro/roofline/analysis.py``.  The JAX package reads
XLA's cost analysis and the partitioned HLO text; the port reads what a
``roofline.trace.TraceRecorder`` counted while one step was traced on
fake local shards (``collective_bytes_from_trace``,
``bytes_split_from_trace``), per device as the HLO's shapes are.  The
port traces every layer and micro-batch unrolled, so nothing is inside a
loop: the ``in_loop`` shares are 0 and the dry run passes
``scan_trips=1``.  ``analytic_flops``, ``model_flops`` and
``roofline_report`` are the JAX package's arithmetic, word for word.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.roofline.trace import COLL_FAMILIES, TraceRecorder

# NVIDIA H100 SXM5 80GB datasheet peaks (the card: NVIDIA H100 80GB HBM3,
# power limit 700 W)
PEAK_FLOPS = 989e12  # dense BF16 on the tensor cores
HBM_BW = 3.35e12  # HBM3
# one 400 Gb/s NDR InfiniBand port per GPU, as in a DGX H100: the
# (16, 16) mesh spans 32 nodes of 8 cards, so its model axis crosses nodes
LINK_BW = 50e9
DEVICE = "NVIDIA H100 80GB HBM3"
POWER_LIMIT_W = 700


def collective_bytes_from_trace(rec: TraceRecorder) -> Dict[str, float]:
    """Per-family collective bytes of one traced step on one device (the
    local result of each collective), in the dict that the JAX package's
    ``collective_bytes_from_hlo`` returns.  The trace is unrolled, so
    every byte is ``outside`` a loop."""
    out: Dict[str, float] = {op: float(rec.collectives[op])
                             for op in COLL_FAMILIES}
    out["total"] = sum(out[o] for o in COLL_FAMILIES)
    out["in_loop"] = 0.0
    out["outside"] = out["total"]
    out["counts"] = dict(rec.collective_counts)  # type: ignore[assignment]
    return out


def bytes_split_from_trace(rec: TraceRecorder) -> Dict[str, float]:
    """Approximate HBM traffic of one traced step on one device, as the
    JAX package's ``hlo_bytes_split`` approximates it: the result bytes
    of every real op (not a view or alias) x2 for read + write, all
    outside a loop."""
    return {"bytes_in_loop": 0.0, "bytes_outside": 2.0 * rec.result_bytes}


def analytic_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """Architecture-aware per-step FLOPs floor (all devices).

    param matmuls + attention (window-aware: the block-skip SWA path makes
    O(s*W) the true cost) + SSD state-expansion. Train counts fwd+bwd+
    remat-recompute (8x fwd-param units); inference counts 2x.
    """
    train = shape.kind == "train"
    b, s = shape.global_batch, shape.seq_len
    tokens = b * (s if shape.kind != "decode" else 1)
    mult = 8.0 if train else 2.0  # 2(fwd)+4(bwd)+2(remat) vs 2(fwd)
    total = mult * cfg.param_count(active_only=True) * tokens
    io_mult = mult / 2.0
    for kind in cfg.layer_kinds():
        if kind == "attn":
            window = cfg.sliding_window or cfg.local_window
            if shape.kind == "decode":
                ctx = min(s, window) if window else s
                per_tok = 4.0 * ctx * cfg.num_heads * cfg.head_dim
            else:
                ctx_avg = min(window, s) if window else s / 2.0
                per_tok = 4.0 * ctx_avg * cfg.num_heads * cfg.head_dim
            total += io_mult * per_tok * tokens
        elif kind == "ssm":
            q = 64 if shape.kind != "decode" else 1
            nh, hd, S = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state
            G = cfg.ssm_ngroups
            per_tok = (2.0 * q * nh * hd + 2.0 * q * G * S
                       + 6.0 * nh * hd * S / max(q, 1))
            total += io_mult * per_tok * tokens
    return total


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE) for train; 2*N*D for inference."""
    n = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def roofline_report(cfg: ModelConfig, shape: InputShape,
                    cost: Optional[dict], coll: Dict[str, float],
                    n_devices: int, scan_trips: int = 1,
                    bytes_split: Optional[Dict[str, float]] = None) -> dict:
    """Roofline terms per device.

    XLA's cost_analysis counts while-loop (scan) bodies ONCE (verified
    empirically), so raw HLO numbers are multiplied by ``scan_trips``
    (= layer-scan cycles x grad-accum microbatches). The small non-scanned
    remainder (embedding, logits, optimizer) gets over-multiplied by the
    same factor — an acceptable upper-bound bias documented in
    EXPERIMENTS.md, cross-checked against analytic MODEL_FLOPS.
    The port's trace is unrolled and its dry run passes ``scan_trips=1``.
    """
    raw_flops = float(cost.get("flops", 0.0)) if cost else 0.0
    raw_bytes = float(cost.get("bytes accessed", 0.0)) if cost else 0.0
    flops = raw_flops * scan_trips
    if bytes_split is not None:
        nbytes = (bytes_split["bytes_in_loop"] * scan_trips
                  + bytes_split["bytes_outside"])
    else:
        nbytes = raw_bytes * scan_trips
    if "in_loop" in coll:
        coll_total = (coll["in_loop"] * scan_trips + coll["outside"])
    else:
        coll_total = coll.get("total", 0.0) * scan_trips
    # analytic compute floor: HLO flops undercount NESTED loop bodies
    # (e.g. the blocked-attention inner KV scan), so the compute term is
    # the max of the corrected-HLO and architecture-analytic estimates
    af = analytic_flops(cfg, shape) / n_devices
    t_compute = max(flops, af) / PEAK_FLOPS
    t_memory = nbytes / HBM_BW
    t_coll = coll_total / LINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    return {
        **terms,
        "dominant": dominant,
        "analytic_flops_per_device": af,
        "scan_trips": scan_trips,
        "model_flops_total": mf,
        "model_flops_per_device": mf / n_devices,
        "useful_flops_ratio": (mf / n_devices) / flops if flops else 0.0,
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": nbytes,
        "hlo_flops_raw": raw_flops,
        "collective_bytes": coll_total,
    }
