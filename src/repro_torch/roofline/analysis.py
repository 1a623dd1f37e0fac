"""Analytic model FLOPs: the port's copy of ``model_flops`` from
``repro/roofline/analysis.py``, over the port's ``ModelConfig`` and
``InputShape``.  The rest of that module reads what ``jax.jit`` lowers
(XLA cost analysis, HLO text, TPU peak rates) and has no counterpart
here."""
from __future__ import annotations

from repro_torch.configs.base import InputShape, ModelConfig


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
