"""Feed-forward blocks: SwiGLU, squared-ReLU (Nemotron), GELU (HuBERT).

Under a sharding rule context on DTensors the two products run as local
regions (``sharding.rules.einsum``): the hidden dim shards over "mlp" and
the second product leaves partial sums over it."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import squared_relu
from repro_torch.sharding import rules
from repro_torch.sharding.rules import shard_hint

X_AXES = ("batch", "seq", None)


def mlp_param_axes(kind: str) -> dict:
    if kind == "swiglu":
        return {"wi": ("embed", None, "mlp"), "wo": ("mlp", "embed")}
    return {"wi": ("embed", "mlp"), "wo": ("mlp", "embed")}


def apply_mlp(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    """x [b, s, d]; swiglu ``wi`` is [d, 2, ff], the others [d, ff]."""
    if kind == "swiglu":
        h = rules.einsum("bsd,dcf->bscf", x, p["wi"], X_AXES,
                         (None, None, "mlp"), ("batch", "seq", None, "mlp"))
        h = shard_hint(h, ("batch", "seq", None, "mlp"))
        h = F.silu(h[..., 0, :]) * h[..., 1, :]
    else:
        h = rules.einsum("bsd,df->bsf", x, p["wi"], X_AXES, (None, "mlp"),
                         ("batch", "seq", "mlp"))
        h = shard_hint(h, ("batch", "seq", "mlp"))
        # jax.nn.gelu defaults to the tanh approximation
        h = squared_relu(h) if kind == "squared_relu" else F.gelu(
            h, approximate="tanh")
    return rules.einsum("bsf,fd->bsd", h, p["wo"], ("batch", "seq", "mlp"),
                        ("mlp", None), X_AXES)
