"""Attention: MHA/GQA/MQA, causal / bidirectional / sliding-window masks,
full-sequence (train/prefill) and single-token (decode) paths, with
blocked (flash-style, online-softmax) variants for long sequences.

Counterpart of ``repro/models/attention.py``.  There is no Pallas kernel
behind these functions in the JAX package (XLA fuses them), so plain
torch ops are the port; the paged decode of the serving engine goes
through the paged-attention kernel instead
(``repro_torch/serving/paged_model.py``).

Shapes
------
x            [b, s, d_model]
q            [b, s, H, hd]
k, v         [b, s, K, hd]      (K = num_kv_heads)
cache k/v    [b, S, K, hd]      (S = capacity; ring buffer when windowed)
q_pos [b, s]; k_pos [b, S].

The cache functions return new tensors and leave the cache they were
given as it was, as the JAX functions do.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import apply_rope

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


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CacheSpec:
    capacity: int  # slots (== seq for full attn, window for SWA/local)
    windowed: bool


def cache_spec(cfg: ModelConfig, seq_len: int, *, local: bool) -> CacheSpec:
    window = cfg.local_window if local else cfg.sliding_window
    if window and window < seq_len:
        return CacheSpec(window, True)
    return CacheSpec(seq_len, False)


def init_kv_cache(cfg: ModelConfig, batch: int, spec: CacheSpec,
                  dtype: torch.dtype = torch.float32,
                  device: DeviceLike = None) -> dict:
    device = resolve_device(device)
    shape = (batch, spec.capacity, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def write_slot(cache_t: torch.Tensor, tok: torch.Tensor,
               slot: int) -> torch.Tensor:
    """``cache_t`` [..., S, K, hd] (S on dim -3) with the one-token
    ``tok`` [..., 1, K, hd] at ``slot``, out of place.  A slot past the
    end writes the last one, as ``jax.lax.dynamic_update_slice`` clamps
    its start."""
    slot = min(slot, cache_t.shape[-3] - 1)
    idx = torch.tensor([slot], device=cache_t.device)
    return cache_t.index_copy(cache_t.dim() - 3, idx, tok.to(cache_t.dtype))


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _project_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_full(p: dict, x: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor, *, window: int,
                   causal: bool) -> torch.Tensor:
    """Train / no-cache forward over a full sequence."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = attend(q, k, v, positions, positions, causal=causal, window=window)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def attention_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig,
                      positions: torch.Tensor, cache: dict,
                      spec: CacheSpec, *, causal: bool = True
                      ) -> Tuple[torch.Tensor, dict]:
    """Full-seq forward that also fills the KV cache (ring when windowed)."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    window = spec.capacity if spec.windowed else 0
    out = attend(q, k, v, positions, positions, causal=causal, window=window)
    s = x.shape[1]
    new_k, new_v = cache["k"].clone(), cache["v"].clone()
    if spec.windowed and s > spec.capacity:
        # only the trailing window lands in the ring buffer, in slots
        # pos % capacity
        slots = positions[:, -spec.capacity:].long() % spec.capacity
        bidx = torch.arange(k.shape[0], device=k.device)[:, None]
        new_k[bidx, slots] = k[:, -spec.capacity:].to(new_k.dtype)
        new_v[bidx, slots] = v[:, -spec.capacity:].to(new_v.dtype)
    else:
        new_k[:, :s] = k.to(new_k.dtype)
        new_v[:, :s] = v.to(new_v.dtype)
    return (torch.einsum("bshk,hkd->bsd", out, p["wo"]),
            {"k": new_k, "v": new_v})


def _valid_slots(spec: CacheSpec, pos: int, last: int,
                 device) -> torch.Tensor:
    """Slot i holds a token iff i <= last (before the ring wraps, later
    slots are empty), or always once the ring is full (windowed, pos >=
    capacity): ring slots hold positions in (pos - capacity, pos], all
    attendable under the window."""
    if spec.windowed and pos >= spec.capacity:
        return torch.ones(spec.capacity, dtype=torch.bool, device=device)
    return torch.arange(spec.capacity, device=device) <= last


def attention_decode_token(p: dict, x: torch.Tensor, cfg: ModelConfig,
                           pos: int, cache: dict, spec: CacheSpec
                           ) -> Tuple[torch.Tensor, dict]:
    """Decode WITHOUT rewriting the cache: attends over the (stale) cache
    plus the new token's K/V computed on the fly, and returns the token
    K/V (``k_tok``/``v_tok`` [b, 1, K, hd]) for the caller to write, as
    the JAX package does for the layers of its scanned cycles."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    K, hd = cfg.num_kv_heads, cfg.head_dim
    g = cfg.num_heads // K
    qg = q.reshape(b, K, g, hd)
    ck, cv = cache["k"], cache["v"]
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bkgd,bskd->bkgs", qg, ck).to(torch.float32)
    logits = logits * scale
    slot = (pos % spec.capacity) if spec.windowed else pos
    # the new token replaces this slot
    valid = _valid_slots(spec, pos, pos - 1, ck.device) \
        & (torch.arange(spec.capacity, device=ck.device) != slot)
    logits = torch.where(valid[None, None, None, :], logits, NEG_INF)
    logits_new = torch.einsum("bkgd,bskd->bkgs", qg, k.to(ck.dtype)
                              ).to(torch.float32) * scale
    m = torch.maximum(logits.amax(-1, keepdim=True),
                      logits_new.amax(-1, keepdim=True))
    p_cache = torch.exp(logits - m)
    p_new = torch.exp(logits_new - m)
    denom = p_cache.sum(-1, keepdim=True) + p_new.sum(-1, keepdim=True)
    w_cache = (p_cache / denom).to(cv.dtype)
    w_new = (p_new / denom).to(cv.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", w_cache, cv)
    out = out + w_new * v.reshape(b, K, 1, hd).to(cv.dtype)
    out = out.reshape(b, 1, cfg.num_heads, hd)
    return (torch.einsum("bshk,hkd->bsd", out, p["wo"]),
            {"k_tok": k.to(ck.dtype), "v_tok": v.to(cv.dtype)})


def attention_decode(p: dict, x: torch.Tensor, cfg: ModelConfig, pos: int,
                     cache: dict, spec: CacheSpec
                     ) -> Tuple[torch.Tensor, dict]:
    """Single-token decode. x [b, 1, d]; pos (same for the batch)."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    slot = (pos % spec.capacity) if spec.windowed else pos
    ck = write_slot(cache["k"], k, slot)
    cv = write_slot(cache["v"], v, slot)
    K, hd = cfg.num_kv_heads, cfg.head_dim
    g = cfg.num_heads // K
    qg = q.reshape(b, K, g, hd)
    logits = torch.einsum("bkgd,bskd->bkgs", qg, ck).to(torch.float32)
    logits = logits / math.sqrt(hd)
    valid = _valid_slots(spec, pos, pos, ck.device)
    logits = torch.where(valid[None, None, None, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(cv.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", w, cv).reshape(
        b, 1, cfg.num_heads, hd)
    return (torch.einsum("bshk,hkd->bsd", out, p["wo"]),
            {"k": ck, "v": cv})
