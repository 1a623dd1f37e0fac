"""Feed-forward blocks: SwiGLU, squared-ReLU (Nemotron), GELU (HuBERT)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import squared_relu


def mlp_param_axes(kind: str) -> dict:
    if kind == "swiglu":
        return {"wi": ("embed", None, "mlp"), "wo": ("mlp", "embed")}
    return {"wi": ("embed", "mlp"), "wo": ("mlp", "embed")}


def apply_mlp(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    """x [b, s, d]; swiglu ``wi`` is [d, 2, ff], the others [d, ff]."""
    if kind == "swiglu":
        h = torch.einsum("bsd,dcf->bscf", x, p["wi"])
        h = F.silu(h[..., 0, :]) * h[..., 1, :]
    else:
        h = torch.einsum("bsd,df->bsf", x, p["wi"])
        # jax.nn.gelu defaults to the tanh approximation
        h = squared_relu(h) if kind == "squared_relu" else F.gelu(
            h, approximate="tanh")
    return torch.einsum("bsf,fd->bsd", h, p["wo"])
