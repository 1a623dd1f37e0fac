"""Model head.  The layer stack of the dense path lives in
``repro_torch/serving/paged_model.py``; the full model zoo (layer plan,
dense-cache prefill/decode) arrives with the model-zoo slice."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import rms_norm


def lm_logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x [b, s, d] -> logits [b, s, V] (tied or untied head)."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.einsum("bsd,dv->bsv", x, w)
