"""Mixture-of-Experts layer: top-k routing with fixed expert capacity
(gather dispatch, no one-hot dispatch tensors), optional shared experts
(DeepSeekMoE), switch-style load-balance aux loss; and the dropless layer
of the serving path (`apply_moe_dropless`).

`apply_moe` is the counterpart of ``repro/models/moe.py``, with its
semantics held exactly under the JAX package's routing
(``configs.jax_routing``).  Tokens are processed in groups (the batch
dim).  Per group:
  1. router logits (fp32) -> softmax -> top-k experts, weights
     renormalised over the k where ``cfg.norm_topk_prob`` (the JAX
     package's only routing; DeepSeekMoE's published config leaves them);
  2. position-in-expert by a token-major cumsum over the flattened
     (token, choice) list; with capacity ``cap = max(1, int(s k cf / E))``
     the choices beyond it are dropped, and their weight mass is not
     added back;
  3. an [E, cap] table of token ids gathers the token vectors to
     [E, cap, d], the experts run as one batched product, and each
     (token, choice) gathers its expert's output back from a table
     whose extra zero row stands for a dropped choice.

No TPU kernel backs this layer in the JAX package, so its products are
plain ``torch.matmul``.  The init lives in ``repro_torch/params.py``.

`apply_moe_dropless` (a config with ``moe_dropless``, on the serving path)
computes every choice: no capacity, so how tokens are grouped does not
change the result.  Its routed experts are one grouped op
(``kernels/moe_experts``): on the card a counting sort of the choices by
expert and two product launches over the chosen experts' rows only.

Under a sharding rule context on DTensors (the dry run) the routing and
dispatch gather, the experts and the combine each run as a local region
(``sharding.rules.local_region``): routing is local to a group (the
batch dim), the experts shard over "experts" (else their hidden dim over
"mlp", leaving partial sums), and ``shard_hint`` lays the dispatched
and returned tokens out at the JAX package's sites.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.dense_3xtf32 import ops as dense
from repro_torch.kernels.moe_experts.ops import moe_experts
from repro_torch.models.common import squared_relu
from repro_torch.models.mlp import apply_mlp, mlp_param_axes
from repro_torch.sharding.rules import local_region, shard_hint

X_AXES = ("batch", "seq", None)
XE_AXES = ("batch", "experts", "expert_cap", None)


def moe_param_axes(cfg: ModelConfig) -> dict:
    swiglu = cfg.mlp_kind == "swiglu"
    axes = {
        "router": ("embed", "experts"),
        "wi": (("experts", "embed", None, "mlp") if swiglu
               else ("experts", "embed", "mlp")),
        "wo": ("experts", "mlp", "embed"),
    }
    if cfg.num_shared_experts:
        axes["shared"] = mlp_param_axes(cfg.mlp_kind)
    return axes


def route(p: dict, x: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [b, s, d] -> (probs [b, s, E] fp32, topw [b, s, k] the top-k
    probabilities, renormalised to sum to 1 where ``cfg.norm_topk_prob``,
    tope [b, s, k] expert ids).  ``jax.lax.top_k`` puts the lower index
    first among equal values; a stable descending sort does the same,
    which ``torch.topk`` does not promise."""
    logits = dense.einsum("bsd,de->bse", x, p["router"].to(x.dtype)
                          ).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    topw, tope = srt[..., :k], idx[..., :k]
    if cfg.norm_topk_prob:
        topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)
    return probs, topw, tope


def _expert_ffn(p: dict, xe: torch.Tensor, kind: str) -> torch.Tensor:
    """xe [G, E, C, d] -> [G, E, C, d], one batched product per weight
    over the experts.  SwiGLU's ``wi`` [E, d, 2, ff] is read as the view
    [E, d, 2 ff]: copying it would cost more than the product itself."""
    G, E, C, d = xe.shape
    xs = xe.transpose(0, 1).reshape(E, G * C, d)
    wi = p["wi"]
    if kind == "swiglu":
        ff = wi.shape[-1]
        h = torch.matmul(xs, wi.view(E, d, 2 * ff)).view(E, G * C, 2, ff)
        # [E, G*C, ...]: the group dim leads the merged dim
        h = shard_hint(h, ("experts", "batch", None, "mlp"))
        h = F.silu(h[..., 0, :]) * h[..., 1, :]
    else:
        h = torch.matmul(xs, wi)
        h = shard_hint(h, ("experts", "batch", "mlp"))
        h = squared_relu(h) if kind == "squared_relu" else F.gelu(
            h, approximate="tanh")
    out = torch.matmul(h, p["wo"])  # [E, G*C, d]
    return out.view(E, G, C, d).transpose(0, 1)


def _route_tables(tope: torch.Tensor, topw: torch.Tensor, s: int, E: int,
                  cap: int, dtype: torch.dtype
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group routing tables, for every group at once (the JAX
    function is vmapped over the groups).

    tope/topw [b, s, k] -> (table [b, E, cap] token ids (s = pad),
                            wtab [b, E, cap] combine weights)."""
    b, _, k = tope.shape
    dev = tope.device
    flat_e = tope.reshape(b, s * k)  # token-major
    tok_ids = torch.arange(s, device=dev).repeat_interleave(k).expand(b, -1)
    onehot = F.one_hot(flat_e, E)
    pos = torch.cumsum(onehot, dim=1) - onehot  # position-in-expert
    myk = pos.gather(2, flat_e[..., None])[..., 0]
    ok = myk < cap
    safe_e = torch.where(ok, flat_e, 0)
    safe_p = torch.where(ok, myk, cap)  # cap column = dropped sentinel
    bidx = torch.arange(b, device=dev)[:, None]
    table = torch.full((b, E, cap + 1), s, dtype=torch.long, device=dev)
    table[bidx, safe_e, safe_p] = torch.where(ok, tok_ids, s)
    wtab = torch.zeros((b, E, cap + 1), dtype=dtype, device=dev)
    wtab[bidx, safe_e, safe_p] = torch.where(
        ok, topw.reshape(b, s * k), 0.0).to(dtype)
    return table[..., :cap], wtab[..., :cap]


def apply_moe(p: dict, x: torch.Tensor, cfg: ModelConfig,
              capacity_factor: float = 0.0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [b, s, d] -> (out [b, s, d], aux_loss scalar)."""
    E = cfg.num_experts
    cf = capacity_factor or cfg.moe_capacity_factor
    cap = max(1, int(x.shape[1] * cfg.experts_per_token * cf / E))
    xe, slot, w, balance = local_region(
        _dispatch_local, ({"router": p["router"]}, x, cfg, cap),
        ({"router": (None, None)}, X_AXES),
        [("batch", None, None, None), ("batch", None), ("batch", "seq", None),
         ("batch",)])
    aux = E * torch.mean(balance)
    xe = shard_hint(xe, XE_AXES)
    swiglu = cfg.mlp_kind == "swiglu"
    ye = local_region(
        _expert_ffn, ({"wi": p["wi"], "wo": p["wo"]}, xe, cfg.mlp_kind),
        ({"wi": ("experts", None, None, "mlp") if swiglu
          else ("experts", None, "mlp"), "wo": ("experts", "mlp", None)},
         XE_AXES), XE_AXES, partial=("mlp",))
    ye = shard_hint(ye, XE_AXES)
    out = local_region(_combine_local, (ye, slot, w),
                       (("batch", None, None, None), ("batch", None),
                        ("batch", "seq", None)), X_AXES)
    out = shard_hint(out, ("batch", "seq", None))
    if "shared" in p:
        out = out + apply_mlp(p["shared"], x, cfg.mlp_kind)
    return out, aux


def apply_moe_dropless(p: dict, x: torch.Tensor, cfg: ModelConfig,
                       tracer=None) -> torch.Tensor:
    """x [..., d] -> [..., d]: every token routed alone (softmax, top k,
    the lower index first among equal scores, weights renormalised only
    where ``cfg.norm_topk_prob``), every choice computed, plus the shared
    experts.  With a ``tracer`` (``serving.tracing.Tracer``) the call is a
    ``moe`` span counting ``tokens``, ``choices`` and, at the tracer's next
    readback, ``experts`` (the distinct experts chosen)."""
    if cfg.mlp_kind != "swiglu":
        raise NotImplementedError(f"dropless experts of kind "
                                  f"{cfg.mlp_kind!r}: only swiglu")
    xf = x.reshape(-1, x.shape[-1])
    n, k = xf.shape[0], cfg.experts_per_token
    span = (tracer.span("moe", tokens=n, choices=n * k) if tracer is not None
            else contextlib.nullcontext())
    with span as s:
        _, topw, tope = route(p, xf[None], cfg)
        out, used = moe_experts(xf, tope[0].contiguous(),
                                topw[0].contiguous(), p["wi"], p["wo"])
        if s is not None:
            tracer.defer(s, "experts", used)
        out = out.view(x.shape)
        if "shared" in p:
            out = out + apply_mlp(p["shared"], x.reshape(1, n, -1),
                                  cfg.mlp_kind).view(x.shape)
    return out


def _dispatch_local(p: dict, x: torch.Tensor, cfg: ModelConfig, cap: int):
    """Routing and the dispatch gather of a block of groups: (xe [b, E,
    cap, d], slot [b, s k], combine weights [b, s, k], each group's
    load-balance term [b])."""
    b, s, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    probs, topw, tope = route(p, x, cfg)

    # aux load-balance loss (switch-style)
    dispatch_frac = F.one_hot(tope, E).to(torch.float32).mean(dim=(1, 2))
    prob_frac = probs.mean(dim=1)  # [b, E]
    balance = torch.sum(dispatch_frac * prob_frac, dim=-1)

    tables, _ = _route_tables(tope, topw, s, E, cap, x.dtype)
    # per-(token, choice) slot in the dispatched tensor, for the combine
    # gather below; dropped choices point at the zero sentinel slot E*cap
    flat_e = tope.reshape(b, s * k)
    onehot = F.one_hot(flat_e, E)
    pos = torch.cumsum(onehot, dim=1) - onehot
    myk = pos.gather(2, flat_e[..., None])[..., 0]
    slot = torch.where(myk < cap, flat_e * cap + myk, E * cap)  # [b, s*k]

    bidx = torch.arange(b, device=x.device)[:, None]
    xpad = torch.cat([x, x.new_zeros(b, 1, d)], dim=1)
    xe = xpad[bidx, tables.reshape(b, E * cap)].view(b, E, cap, d)
    w = torch.where(myk < cap, topw.reshape(b, s * k), 0.0).view(b, s, k)
    return xe, slot, w, balance


def _combine_local(ye: torch.Tensor, slot: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """out[t] = sum_k w_tk * ye[slot(t, k)], a batched gather."""
    b, E, cap, d = ye.shape
    s, k = w.shape[1], w.shape[2]
    bidx = torch.arange(b, device=ye.device)[:, None]
    ye_flat = torch.cat([ye.reshape(b, E * cap, d), ye.new_zeros(b, 1, d)],
                        dim=1)  # sentinel zero row
    picked = ye_flat[bidx, slot].view(b, s, k, d)
    return torch.einsum("bskd,bsk->bsd", picked, w.to(picked.dtype))
