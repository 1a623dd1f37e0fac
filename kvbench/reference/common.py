"""The decoder skeleton the references share, in plain float32 PyTorch:
RMSNorm with the ``(1 + w)`` scale, rotary embeddings by half rotation,
grouped-query causal attention, a SwiGLU block, and the stored prefix's
int8 round trip.  No kernel, cache or batching: one sequence at a time.

The stored prefix is symmetric int8 per (layer, kv head): the scale is
the absolute maximum over the prefix's tokens and the head's dimensions
over 127, values rounded half to even and clipped to [-127, 127].  The
reference computes it from its own prefix forward pass.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

KV = Tuple[torch.Tensor, torch.Tensor]


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 products with TF32 off (the configuration's precision), or
    on (the control one step below it)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + w)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [s, heads, hd] at positions pos [s]."""
    half = x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half)
    ang = pos.to(torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], -1)


def attention(q, k, v, q_pos, k_pos) -> torch.Tensor:
    """q [s, H, hd]; k, v [S, K, hd]; causal by position."""
    H, K = q.shape[1], k.shape[1]
    k = k.repeat_interleave(H // K, dim=1)
    v = v.repeat_interleave(H // K, dim=1)
    scores = torch.einsum("shd,thd->hst", q, k) / math.sqrt(q.shape[-1])
    mask = k_pos[None, :] > q_pos[:, None]
    scores = scores.masked_fill(mask[None], float("-inf"))
    return torch.einsum("hst,thd->shd", torch.softmax(scores, -1), v)


def swiglu(wi: torch.Tensor, wo: torch.Tensor, x: torch.Tensor
           ) -> torch.Tensor:
    """wi [d, 2, ff] (gate, up), wo [ff, d]."""
    return (F.silu(x @ wi[:, 0]) * (x @ wi[:, 1])) @ wo


def int8_round_trip(kv: torch.Tensor) -> torch.Tensor:
    """kv [T, K, hd] of one layer -> the values the store holds."""
    scale = kv.abs().amax(dim=(0, 2)).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(kv / scale[None, :, None]), -127, 127)
    return q * scale[None, :, None]


MLP = Callable[[dict, torch.Tensor, dict, int, Sequence[int]], torch.Tensor]


def forward(w: dict, m: dict, mlp: MLP, tokens: torch.Tensor, start: int,
            prefix: Optional[List[KV]], groups: Sequence[int],
            first: int) -> Tuple[torch.Tensor, List[KV]]:
    """``tokens`` [s] at positions ``start`` .. ``start + s - 1``, after
    ``prefix`` (per layer K, V [start, K, hd], or None when start is 0).
    ``groups`` splits the s tokens into the runs an MoE layer routes
    together.  Returns the logits of positions ``first`` .. s - 1 of
    ``tokens`` [s - first, V] and each layer's K, V of the tokens."""
    dev = tokens.device
    pos = torch.arange(start, start + len(tokens), device=dev)
    k_pos = torch.arange(0, start + len(tokens), device=dev)
    x = w["embed"][tokens]
    kvs: List[KV] = []
    for i, lp in enumerate(w["layers"]):
        a = lp["attn"]
        h = rms_norm(x, lp["ln1"], m["norm_eps"])
        q = rope(torch.einsum("sd,dhk->shk", h, a["wq"]), pos,
                 m["rope_theta"])
        k = rope(torch.einsum("sd,dhk->shk", h, a["wk"]), pos,
                 m["rope_theta"])
        v = torch.einsum("sd,dhk->shk", h, a["wv"])
        kvs.append((k, v))
        if prefix is not None:
            k = torch.cat([prefix[i][0], k])
            v = torch.cat([prefix[i][1], v])
        o = attention(q, k, v, pos, k_pos)
        x = x + torch.einsum("shk,hkd->sd", o, a["wo"])
        x = x + mlp(lp, rms_norm(x, lp["ln2"], m["norm_eps"]), m, i, groups)
    x = rms_norm(x[first:], w["final_norm"], m["norm_eps"])
    head = w["embed"].T if m.get("tie_embeddings", False) else w["lm_head"]
    return x @ head, kvs


def stored_prefix(w: dict, m: dict, mlp: MLP,
                  tokens: torch.Tensor) -> List[KV]:
    """The prefix as the store holds it: the reference's own K, V of the
    document, through the int8 round trip, layer by layer."""
    _, kvs = forward(w, m, mlp, tokens, 0, None, [len(tokens)],
                     len(tokens) - 1)
    return [(int8_round_trip(k), int8_round_trip(v)) for k, v in kvs]
