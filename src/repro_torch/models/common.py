"""Shared model components: RMSNorm, activations, RoPE and the loss.

Counterpart of ``repro/models/common.py``; the inits live in
``repro_torch/params.py``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.sharding.rules import local_region


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with the ``(1 + w)`` scale (weights are stored centred on 0)."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * (1.0 + w.to(torch.float32))
            ).to(dt)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` for every x (torch's own
    softplus returns x itself above its threshold of 20)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def squared_relu(x: torch.Tensor) -> torch.Tensor:
    r = torch.relu(x)
    return r * r


def rope_freqs(head_dim: int, theta: float,
               device: torch.device) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Llama-style half rotation. x [..., seq, heads, head_dim];
    positions [..., seq]."""
    if theta <= 0:
        return x
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # [hd/2]
    ang = positions[..., :, None].to(torch.float32) * freqs  # [..., s, hd/2]
    cos = torch.cos(ang)[..., :, None, :]  # [..., s, 1, hd/2]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy. logits [..., V] fp32-cast; labels int;
    with ``mask``, the mean over the masked positions (at least one).
    Under a sharding rule context on DTensors ([b, s, V] logits) the
    per-token losses are a local region over the batch, with the vocab
    gathered."""
    axes = ("batch", "seq")[:labels.dim()]
    nll = local_region(_token_nll, (logits, labels), (axes + (None,), axes),
                       axes)
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


def _token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return logz - gold
