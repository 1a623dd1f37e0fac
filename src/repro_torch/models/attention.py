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

Under a sharding rule context on DTensors (the dry run), each step runs
as a local region (``sharding.rules.local_region``) laid out by the
logical axes below, and ``shard_hint`` lays the results out at the JAX
package's ten sites; otherwise both are plain calls.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.dense_3xtf32 import ops as dense
from repro_torch.models.common import apply_rope
from repro_torch.sharding import rules
from repro_torch.sharding.rules import local_region, shard_hint

NEG_INF = -1e30

X_AXES = ("batch", "seq", None)
POS_AXES = ("batch", "seq")
Q_AXES = ("batch", "seq", "heads", "head_dim")
KV_AXES = ("batch", "seq", "kv_heads", "head_dim")
CACHE_AXES = {"k": ("batch", "cache_seq", "kv_heads", "head_dim"),
              "v": ("batch", "cache_seq", "kv_heads", "head_dim")}
# the projections' weights inside a region: the FSDP dim gathered
_W_AXES = {"wq": (None, "heads", None), "wk": (None, "kv_heads", None),
           "wv": (None, "kv_heads", None), "bq": ("heads", None),
           "bk": ("kv_heads", None), "bv": ("kv_heads", None)}


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
    """One kv block of the flash-style recurrence for every q block at
    once: qblk [b, n, Bq, K, g, hd]; kblk/vblk [b, Bk, K, hd] (one kv
    block for all) or [b, n, Bk, K, hd] (one per q block); bias [b, n,
    Bq, Bk]; m/l [b, n, K, g, Bq], acc [b, n, K, g, Bq, hd]."""
    per_q = "n" if kblk.dim() == 5 else ""
    logits = torch.einsum(f"bnqkgd,b{per_q}skd->bnkgqs", qblk, kblk
                          ).to(torch.float32) * scale
    logits = logits + bias[:, :, None, None]
    m_new = torch.maximum(m, logits.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[..., None])
    l = l * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum(
        f"bnkgqs,b{per_q}skd->bnkgqd", p.to(vblk.dtype), vblk)
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


def _finish(m, l, acc, s: int, dtype) -> torch.Tensor:
    """acc / l of every q block, as [b, s, H, hd]."""
    b, nq, K, g, Bq, hd = acc.shape
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(b, nq * Bq, K * g, hd)
    return out[:, :s].to(dtype)


def _start(q, K: int, nq: int, block_q: int):
    b, _, H, hd = q.shape
    g = H // K
    f32 = dict(dtype=torch.float32)
    return (q.new_full((b, nq, K, g, block_q), NEG_INF, **f32),
            q.new_zeros((b, nq, K, g, block_q), **f32),
            q.new_zeros((b, nq, K, g, block_q, hd), **f32))


def _attend_blocked(q, k, v, q_pos, k_pos, *, causal, window,
                    block_q: int = 512, block_k: int = 1024):
    """Flash-style online-softmax attention, O(block) memory per q block,
    every q block at once (one step per kv block).  Padded q rows produce
    garbage that is sliced away."""
    hd = q.shape[-1]
    qp, qpos, kp, vp, kpos, nq, nk = _blocks(q, k, v, q_pos, k_pos,
                                             block_q, block_k)
    scale = 1.0 / math.sqrt(hd)
    m, l, acc = _start(q, k.shape[2], nq, block_q)
    for kj in range(nk):
        bias = _mask_bias(qpos, kpos[:, kj, None], causal=causal,
                          window=window)
        m, l, acc = _online_softmax_step(m, l, acc, qp, kp[:, kj],
                                         vp[:, kj], bias, scale)
    return _finish(m, l, acc, q.shape[1], q.dtype)


def _attend_blocked_windowed(q, k, v, q_pos, k_pos, *, window: int,
                             block_q: int = 512, block_k: int = 1024):
    """Sliding-window attention with block skipping: each q block visits
    only the ~(window + block_q) / block_k kv blocks that can intersect
    its window (every q block at once: step j gathers each q block's j-th
    kv block).  Requires aligned q/k positions (prefill)."""
    hd = q.shape[-1]
    qp, qpos, kp, vp, kpos, nq, nk = _blocks(q, k, v, q_pos, k_pos,
                                             block_q, block_k)
    n_inner = (window + block_q) // block_k + 2
    scale = 1.0 / math.sqrt(hd)
    m, l, acc = _start(q, k.shape[2], nq, block_q)
    first = (torch.arange(nq, device=q.device) * block_q - window) \
        // block_k
    for j in range(n_inner):
        blk = first + j
        blk_c = torch.clamp(blk, 0, nk - 1)
        bias = _mask_bias(qpos, kpos[:, blk_c], causal=True, window=window)
        outside = (blk < 0) | (blk > nk - 1)
        bias = torch.where(outside[None, :, None, None], NEG_INF, bias)
        m, l, acc = _online_softmax_step(m, l, acc, qp, kp[:, blk_c],
                                         vp[:, blk_c], bias, scale)
    return _finish(m, l, acc, q.shape[1], q.dtype)


def _kv_for_local_heads(q, k, v):
    """The kv heads that this rank's query heads read, when a region
    holds a slice of the query heads and every kv head (GQA with fewer
    kv heads than the model axis); k and v themselves otherwise."""
    H_l, K_l = q.shape[2], k.shape[2]
    H = rules.global_size("heads", H_l)
    if K_l != rules.global_size("kv_heads", K_l) or H_l == H:
        return k, v
    g = H // K_l
    h0 = rules.local_offset("heads")
    k0, k1 = h0 // g, (h0 + H_l - 1) // g + 1
    return k[:, :, k0:k1], v[:, :, k0:k1]


def attend(q, k, v, q_pos, k_pos, *, causal: bool, window: int,
           blocked_threshold: int = 2048):
    return local_region(_attend_local, (q, k, v, q_pos, k_pos, causal,
                                        window, blocked_threshold),
                        (Q_AXES, KV_AXES, KV_AXES, POS_AXES, POS_AXES),
                        Q_AXES)


def _attend_local(q, k, v, q_pos, k_pos, causal: bool, window: int,
                  blocked_threshold: int):
    k, v = _kv_for_local_heads(q, k, v)
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
    """``cache_t`` [b, S, K, hd] with the one-token ``tok`` [b, 1, K, hd]
    at ``slot``, out of place.  A slot past the end writes the last one,
    as ``jax.lax.dynamic_update_slice`` clamps its start."""
    slot = min(slot, cache_t.shape[-3] - 1)
    return local_region(_write_slot_local, (cache_t, tok, slot),
                        (CACHE_AXES["k"], KV_AXES), CACHE_AXES["k"])


def _write_slot_local(cache_t: torch.Tensor, tok: torch.Tensor,
                      slot: int) -> torch.Tensor:
    slot -= rules.local_offset("cache_seq")
    if not 0 <= slot < cache_t.shape[-3]:
        return cache_t.clone()  # another rank's shard holds the slot
    idx = torch.tensor([slot], device=cache_t.device)
    return cache_t.index_copy(cache_t.dim() - 3, idx, tok.to(cache_t.dtype))


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _project_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    w = {n: p[n] for n in _W_AXES if n in p}
    q, k, v = local_region(_project_qkv_local, (w, x, cfg, positions),
                           (_W_AXES, X_AXES, None, POS_AXES),
                           [Q_AXES, KV_AXES, KV_AXES])
    q = shard_hint(q, ("batch", "seq", "heads", "head_dim"))
    k = shard_hint(k, ("batch", "seq", "kv_heads", "head_dim"))
    v = shard_hint(v, ("batch", "seq", "kv_heads", "head_dim"))
    return q, k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    return rules.einsum("bshk,hkd->bsd", out, wo, Q_AXES,
                        ("heads", "head_dim", None), X_AXES)


def _project_qkv_local(p: dict, x: torch.Tensor, cfg: ModelConfig,
                       positions: torch.Tensor):
    q, k, v = dense.einsums("bsd,dhk->bshk", x, (p["wq"], p["wk"], p["wv"]))
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
    return _out_proj(out, p["wo"])


def attention_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig,
                      positions: torch.Tensor, cache: dict,
                      spec: CacheSpec, *, causal: bool = True
                      ) -> Tuple[torch.Tensor, dict]:
    """Full-seq forward that also fills the KV cache (ring when windowed)."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    window = spec.capacity if spec.windowed else 0
    out = attend(q, k, v, positions, positions, causal=causal, window=window)
    new_k, new_v = local_region(
        _fill_cache_local, (cache["k"], cache["v"], k, v, positions, spec),
        (CACHE_AXES["k"], CACHE_AXES["v"], KV_AXES, KV_AXES, POS_AXES),
        [CACHE_AXES["k"], CACHE_AXES["v"]])
    new_k = shard_hint(new_k, CACHE_AXES["k"])
    new_v = shard_hint(new_v, CACHE_AXES["v"])
    return _out_proj(out, p["wo"]), {"k": new_k, "v": new_v}


def _fill_cache_local(ck, cv, k, v, positions, spec: CacheSpec):
    s = k.shape[1]
    new_k, new_v = ck.clone(), cv.clone()
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
    return new_k, new_v


def _valid_slots(spec: CacheSpec, pos: int, last: int,
                 idx: torch.Tensor) -> torch.Tensor:
    """Slot i (of the slot indices ``idx``) holds a token iff i <= last
    (before the ring wraps, later slots are empty), or always once the
    ring is full (windowed, pos >= capacity): ring slots hold positions
    in (pos - capacity, pos], all attendable under the window."""
    if spec.windowed and pos >= spec.capacity:
        return torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
    return idx <= last


# a decode region holds every query head of its kv heads, and the cache's
# slots of its cache_seq shard
_DQ_AXES = ("batch", "seq", None, "head_dim")
_DOUT_AXES = ("batch", "kv_heads", None, "head_dim")


def _decode_attend(q, k, v, ck, cv, cfg: ModelConfig, pos: int,
                   spec: CacheSpec, token: bool) -> torch.Tensor:
    """The decode attention [b, 1, H, hd] of the queries q [b, 1, H, hd]
    over the cache (``token``: the stale cache without the token's slot,
    plus the token's own k/v; otherwise the cache that holds it)."""
    b = q.shape[0]
    out = local_region(_decode_attend_local,
                       (q, k, v, ck, cv, cfg, pos, spec, token),
                       (_DQ_AXES, KV_AXES, KV_AXES, CACHE_AXES["k"],
                        CACHE_AXES["v"]), _DOUT_AXES,
                       partial=("cache_seq",))
    out = shard_hint(out, ("batch", None, None, None))
    return out.reshape(b, 1, cfg.num_heads, cfg.head_dim)


def _decode_attend_local(q, k, v, ck, cv, cfg: ModelConfig, pos: int,
                         spec: CacheSpec, token: bool) -> torch.Tensor:
    """[b, K_l, g, hd]: this rank's kv heads, summed over its cache slots
    only (the softmax's max and denominator are reduced over every
    cache_seq shard; the token's own term is added on the first)."""
    b, hd = q.shape[0], cfg.head_dim
    K = ck.shape[2]
    g = cfg.num_heads // cfg.num_kv_heads
    k0 = rules.local_offset("kv_heads")
    qg = q[:, 0, k0 * g:(k0 + K) * g].reshape(b, K, g, hd)
    S_l = ck.shape[1]
    s0 = rules.local_offset("cache_seq")
    split = rules.global_size("cache_seq", S_l) != S_l
    idx = s0 + torch.arange(S_l, device=ck.device)
    if token:
        scale = 1.0 / math.sqrt(hd)
        logits = torch.einsum("bkgd,bskd->bkgs", qg, ck).to(torch.float32)
        logits = logits * scale
        slot = (pos % spec.capacity) if spec.windowed else pos
        # the new token replaces this slot
        valid = _valid_slots(spec, pos, pos - 1, idx) & (idx != slot)
        logits = torch.where(valid[None, None, None, :], logits, NEG_INF)
        # pin the seq-sharded contraction: weights stay sharded like the
        # cache seq dim and the PV dot reduces to a tiny [b, K, g, hd]
        # all-reduce
        logits = shard_hint(logits, ("batch", "kv_heads", None,
                                     "cache_seq"))
        logits_new = torch.einsum("bkgd,bskd->bkgs", qg, k.to(ck.dtype)
                                  ).to(torch.float32) * scale
        m = torch.maximum(
            rules.local_all_reduce(logits.amax(-1, keepdim=True),
                                   "cache_seq", "max"),
            logits_new.amax(-1, keepdim=True))
        p_cache = torch.exp(logits - m)
        p_new = torch.exp(logits_new - m)
        denom = rules.local_all_reduce(p_cache.sum(-1, keepdim=True),
                                       "cache_seq") \
            + p_new.sum(-1, keepdim=True)
        w_cache = (p_cache / denom).to(cv.dtype)
        w_cache = shard_hint(w_cache, ("batch", "kv_heads", None,
                                       "cache_seq"))
        w_new = (p_new / denom).to(cv.dtype)
        out = torch.einsum("bkgs,bskd->bkgd", w_cache, cv)
        if s0 == 0:
            out = out + w_new * v.reshape(b, K, 1, hd).to(cv.dtype)
        return out
    logits = torch.einsum("bkgd,bskd->bkgs", qg, ck).to(torch.float32)
    logits = logits / math.sqrt(hd)
    valid = _valid_slots(spec, pos, pos, idx)
    logits = torch.where(valid[None, None, None, :], logits, NEG_INF)
    if split:
        m = rules.local_all_reduce(logits.amax(-1, keepdim=True),
                                   "cache_seq", "max")
        e = torch.exp(logits - m)
        w = e / rules.local_all_reduce(e.sum(-1, keepdim=True), "cache_seq")
    else:
        w = torch.softmax(logits, dim=-1)
    return torch.einsum("bkgs,bskd->bkgd", w.to(cv.dtype), cv)


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
    ck, cv = cache["k"], cache["v"]
    out = _decode_attend(q, k, v, ck, cv, cfg, pos, spec, token=True)
    return (_out_proj(out, p["wo"]),
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
    ck = shard_hint(ck, CACHE_AXES["k"])
    cv = shard_hint(cv, CACHE_AXES["v"])
    out = _decode_attend(q, k, v, ck, cv, cfg, pos, spec, token=False)
    return _out_proj(out, p["wo"]), {"k": ck, "v": cv}
