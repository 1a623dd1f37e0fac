"""Feed-forward blocks: SwiGLU, squared-ReLU (Nemotron), GELU (HuBERT).

Under a sharding rule context on DTensors the two products run as local
regions (``sharding.rules.einsum``): the hidden dim shards over "mlp" and
the second product leaves partial sums over it.  With no mesh they go
through the dense routing function (``kernels.dense_3xtf32.ops.einsum``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.dense_3xtf32 import ops as dense
from repro_torch.models.common import squared_relu
from repro_torch.sharding import rules
from repro_torch.sharding.rules import shard_hint

X_AXES = ("batch", "seq", None)


def mlp_param_axes(kind: str) -> dict:
    if kind == "swiglu":
        return {"wi": ("embed", None, "mlp"), "wo": ("mlp", "embed")}
    return {"wi": ("embed", "mlp"), "wo": ("mlp", "embed")}


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor, *axes):
    """``rules.einsum(eq, a, b, *axes)``, routed when no mesh is active."""
    if rules.active_mesh() is None:
        return dense.einsum(eq, a, b)
    return rules.einsum(eq, a, b, *axes)


def apply_mlp(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    """x [b, s, d]; swiglu ``wi`` is [d, 2, ff], the others [d, ff]."""
    if kind == "swiglu":
        h = _einsum("bsd,dcf->bscf", x, p["wi"], X_AXES,
                    (None, None, "mlp"), ("batch", "seq", None, "mlp"))
        h = shard_hint(h, ("batch", "seq", None, "mlp"))
        h = F.silu(h[..., 0, :]) * h[..., 1, :]
    else:
        h = _einsum("bsd,df->bsf", x, p["wi"], X_AXES, (None, "mlp"),
                    ("batch", "seq", "mlp"))
        h = shard_hint(h, ("batch", "seq", "mlp"))
        # jax.nn.gelu defaults to the tanh approximation
        h = squared_relu(h) if kind == "squared_relu" else F.gelu(
            h, approximate="tanh")
    return _einsum("bsf,fd->bsd", h, p["wo"], ("batch", "seq", "mlp"),
                   ("mlp", None), X_AXES)
