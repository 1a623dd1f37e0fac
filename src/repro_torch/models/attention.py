"""Full-sequence attention for prefill: MHA/GQA/MQA, causal or
bidirectional, optional sliding window, with blocked (flash-style,
online-softmax) variants for long sequences.

Counterpart of ``repro/models/attention.py::attend`` and its three
branches.  There is no Pallas kernel behind ``attend`` in the JAX package
(XLA fuses it), so plain torch ops are the port.

Shapes: q [b, s, H, hd]; k, v [b, S, K, hd] (K = num_kv_heads);
q_pos [b, s]; k_pos [b, S].
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
               window: int) -> torch.Tensor:
    """[..., q, k] additive bias. window == 0 -> unwindowed."""
    dif = q_pos[..., :, None] - k_pos[..., None, :]
    ok = torch.ones(dif.shape, dtype=torch.bool, device=dif.device)
    if causal:
        ok &= dif >= 0
    if window > 0:
        ok &= dif < window
    zero = torch.zeros((), dtype=torch.float32, device=dif.device)
    return torch.where(ok, zero, NEG_INF)


def _attend_naive(q, k, v, q_pos, k_pos, *, causal, window):
    b, s, H, hd = q.shape
    K = k.shape[2]
    g = H // K
    qg = q.reshape(b, s, K, g, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k).to(torch.float32)
    logits = logits / math.sqrt(hd)
    logits = logits + _mask_bias(q_pos, k_pos, causal=causal,
                                 window=window)[:, None, None]
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(b, s, H, hd)


def _pad_seq(x: torch.Tensor, n: int, value: float = 0.0) -> torch.Tensor:
    """Pad dim 1 (the sequence axis) with ``n`` trailing entries."""
    if n == 0:
        return x
    pad = x.new_full((x.shape[0], n) + tuple(x.shape[2:]), value)
    return torch.cat([x, pad], dim=1)


def _online_softmax_step(m, l, acc, qblk, kblk, vblk, bias, scale):
    """One kv block of the flash-style recurrence; m/l [b, K, g, Bq],
    acc [b, K, g, Bq, hd]."""
    logits = torch.einsum("bqkgd,bskd->bkgqs", qblk, kblk
                          ).to(torch.float32) * scale
    logits = logits + bias[:, None, None]
    m_new = torch.maximum(m, logits.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[..., None])
    l = l * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum(
        "bkgqs,bskd->bkgqd", p.to(vblk.dtype), vblk)
    return m_new, l, acc


def _blocks(q, k, v, q_pos, k_pos, block_q, block_k):
    """Pad to whole blocks; returns per-block views and the counts."""
    b, s, H, hd = q.shape
    K = k.shape[2]
    g = H // K
    sk = k.shape[1]
    nq = -(-s // block_q)
    nk = -(-sk // block_k)
    qp = _pad_seq(q, nq * block_q - s).reshape(b, nq, block_q, K, g, hd)
    qpos = _pad_seq(q_pos, nq * block_q - s, -1).reshape(b, nq, block_q)
    kp = _pad_seq(k, nk * block_k - sk).reshape(b, nk, block_k, K, hd)
    vp = _pad_seq(v, nk * block_k - sk).reshape(b, nk, block_k, K, hd)
    kpos = _pad_seq(k_pos, nk * block_k - sk, 2**30).reshape(b, nk, block_k)
    return qp, qpos, kp, vp, kpos, nq, nk


def _attend_blocked(q, k, v, q_pos, k_pos, *, causal, window,
                    block_q: int = 512, block_k: int = 1024):
    """Flash-style online-softmax attention, O(block) memory.  Padded q
    rows produce garbage that is sliced away."""
    b, s, H, hd = q.shape
    K = k.shape[2]
    g = H // K
    qp, qpos, kp, vp, kpos, nq, nk = _blocks(q, k, v, q_pos, k_pos,
                                             block_q, block_k)
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for qi in range(nq):
        m = q.new_full((b, K, g, block_q), NEG_INF, dtype=torch.float32)
        l = q.new_zeros((b, K, g, block_q), dtype=torch.float32)
        acc = q.new_zeros((b, K, g, block_q, hd), dtype=torch.float32)
        for kj in range(nk):
            bias = _mask_bias(qpos[:, qi], kpos[:, kj], causal=causal,
                              window=window)
            m, l, acc = _online_softmax_step(m, l, acc, qp[:, qi],
                                             kp[:, kj], vp[:, kj], bias,
                                             scale)
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))  # [b, Bq, K, g, hd]
    out = torch.stack(outs, dim=1).reshape(b, nq * block_q, H, hd)
    return out[:, :s].to(q.dtype)


def _attend_blocked_windowed(q, k, v, q_pos, k_pos, *, window: int,
                             block_q: int = 512, block_k: int = 1024):
    """Sliding-window attention with block skipping: each q block visits
    only the ~(window + block_q) / block_k kv blocks that can intersect
    its window.  Requires aligned q/k positions (prefill)."""
    b, s, H, hd = q.shape
    K = k.shape[2]
    g = H // K
    qp, qpos, kp, vp, kpos, nq, nk = _blocks(q, k, v, q_pos, k_pos,
                                             block_q, block_k)
    n_inner = (window + block_q) // block_k + 2
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for qi in range(nq):
        m = q.new_full((b, K, g, block_q), NEG_INF, dtype=torch.float32)
        l = q.new_zeros((b, K, g, block_q), dtype=torch.float32)
        acc = q.new_zeros((b, K, g, block_q, hd), dtype=torch.float32)
        for j in range(n_inner):
            blk = (qi * block_q - window) // block_k + j
            blk_c = min(max(blk, 0), nk - 1)
            bias = _mask_bias(qpos[:, qi], kpos[:, blk_c], causal=True,
                              window=window)
            if not 0 <= blk <= nk - 1:
                bias = torch.full_like(bias, NEG_INF)
            m, l, acc = _online_softmax_step(m, l, acc, qp[:, qi],
                                             kp[:, blk_c], vp[:, blk_c],
                                             bias, scale)
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))
    out = torch.stack(outs, dim=1).reshape(b, nq * block_q, H, hd)
    return out[:, :s].to(q.dtype)


def attend(q, k, v, q_pos, k_pos, *, causal: bool, window: int,
           blocked_threshold: int = 2048):
    big = q.shape[1] * k.shape[1] > blocked_threshold ** 2
    if big and causal and window > 0 and q.shape[1] == k.shape[1]:
        return _attend_blocked_windowed(q, k, v, q_pos, k_pos,
                                        window=window)
    if big:
        return _attend_blocked(q, k, v, q_pos, k_pos, causal=causal,
                               window=window)
    return _attend_naive(q, k, v, q_pos, k_pos, causal=causal, window=window)
