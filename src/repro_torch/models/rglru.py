"""Griffin / RecurrentGemma recurrent block with RG-LRU [arXiv:2402.19427].

Counterpart of ``repro/models/rglru.py``; the init lives in
``repro_torch/params.py``.

Block:  x -> (W_x -> causal conv1d -> RG-LRU) * gelu(W_g x) -> W_o
RG-LRU: r_t = sigmoid(W_a u_t);  i_t = sigmoid(W_i u_t)
        log a_t = -c * softplus(Lambda) * r_t          (c = 8)
        h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The full-sequence path runs the recurrence as a log-depth doubling scan
(the JAX package uses ``jax.lax.associative_scan``: the same products,
combined in another order, so the two agree within fp32 rounding);
decode is a single recurrence step.  No TPU kernel backs this block.
Under a sharding rule context on DTensors the products run as local
regions (``sharding.rules.einsum``) with the width sharded over
"rglru_width"; the conv and the scan are elementwise along it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import softplus
from repro_torch.sharding import rules
from repro_torch.sharding.rules import shard_hint

X_AXES = ("batch", "seq", None)
U_AXES = ("batch", "seq", "rglru_width")
W_AXES = (None, "rglru_width")  # an input projection, FSDP dim gathered

_C = 8.0


def init_rglru_cache(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.float32,
                     device: DeviceLike = None) -> dict:
    device = resolve_device(device)
    w = cfg.rglru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, 3, w), dtype=dtype, device=device)}


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along axis 1; returns all h_t.

    A doubling (Hillis-Steele) scan over the pairs (a, b) with the
    associative combine (a_l, b_l) . (a_r, b_r) = (a_l a_r, b_l a_r + b_r):
    ceil(log2 s) rounds of elementwise ops, not s sequential steps."""
    if h0 is not None:
        # fold h0 into the first step
        b = b.clone()
        b[:, 0] += a[:, 0] * h0
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def _gates(p: dict, u: torch.Tensor):
    r = torch.sigmoid(rules.einsum("bsw,wk->bsk", u, p["w_a"], X_AXES,
                                   W_AXES, U_AXES).to(torch.float32))
    i = torch.sigmoid(rules.einsum("bsw,wk->bsk", u, p["w_i"], X_AXES,
                                   W_AXES, U_AXES).to(torch.float32))
    log_a = -_C * softplus(p["lam"]) * r
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (
        i * u.to(torch.float32))
    return a, gated_in


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def apply_rglru_full(p: dict, x: torch.Tensor, cfg: ModelConfig,
                     with_cache: bool
                     ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x [b, s, d]; the recurrence over the whole sequence."""
    u = rules.einsum("bsd,dw->bsw", x, p["w_x"], X_AXES, W_AXES, U_AXES)
    u = shard_hint(u, ("batch", "seq", "rglru_width"))
    # causal depthwise conv, width 4
    w = p["conv"].shape[0]
    prev = u.new_zeros((u.shape[0], w - 1, u.shape[-1]))
    full = torch.cat([prev, u], dim=1)
    u = sum(full[:, i:i + x.shape[1]] * p["conv"][i] for i in range(w))
    a, gated_in = _gates(p, u)
    h = linear_scan(a, gated_in)  # [b, s, w] fp32
    gate = _gelu(rules.einsum("bsd,dw->bsw", x, p["w_gate"], X_AXES, W_AXES,
                              U_AXES))
    out = rules.einsum("bsw,wd->bsd", h.to(x.dtype) * gate, p["w_out"],
                       U_AXES, ("rglru_width", None), X_AXES)
    if with_cache:
        return out, {"h": h[:, -1], "conv": full[:, -(w - 1):]}
    return out, None


def apply_rglru_decode(p: dict, x: torch.Tensor, cfg: ModelConfig,
                       cache: dict) -> Tuple[torch.Tensor, dict]:
    """x [b, 1, d] single-step recurrence."""
    u = rules.einsum("bsd,dw->bsw", x, p["w_x"], X_AXES, W_AXES,
                     U_AXES)  # [b, 1, w]
    hist = torch.cat([cache["conv"], u], dim=1)  # [b, 4, w]
    u = rules.einsum("bwk,wk->bk", hist, p["conv"], U_AXES, W_AXES,
                     ("batch", "rglru_width"))[:, None]  # [b, 1, w]
    a, gated_in = _gates(p, u)  # [b, 1, w]
    h = a[:, 0] * cache["h"] + gated_in[:, 0]  # [b, w]
    gate = _gelu(rules.einsum("bsd,dw->bsw", x, p["w_gate"], X_AXES, W_AXES,
                              U_AXES))[:, 0]
    out = rules.einsum("bw,wd->bd", h.to(x.dtype) * gate, p["w_out"],
                       ("batch", "rglru_width"), ("rglru_width", None),
                       ("batch", None))
    return out[:, None], {"h": h, "conv": hist[:, 1:]}
