"""Paged-cache model paths for the live serving engine (decoders whose
layers are all attention: the paper's dense GQA class, LWM/Yi/Llama
families, and the MoE decoders), each the one layer body ``_forward``
with its own attention: ``prefill_collect_kv`` over a prompt, handing
back per-layer K/V for the engine to scatter into pages;
``prefill_over_pages`` over a sequence's tokens from a position on and
the rows its pages hold (a reuse request's suffix); ``decode_paged``, one
token per sequence at its own position (continuous batching), through
the paged-attention kernel.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.dense_3xtf32 import ops as dense
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import _project_qkv, attend
from repro_torch.models.common import rms_norm
from repro_torch.models.transformer import lm_logits
from repro_torch.paged.cache import PagedKVCache
from repro_torch.params import layer_params
from repro_torch.serving import tracing


def _mlp_out(lp, h2, cfg: ModelConfig):
    """The layer's MLP.  A dropless MoE layer (``cfg.moe_dropless``)
    computes every choice of every token of ``h2`` [b, s, d], in a ``moe``
    span of the tracer whose span is open (the engine's step).  Otherwise
    an MoE layer routes each sequence as one capacity group: a decode
    step's [b, 1, d] is b groups of one token, as in the JAX package (whose
    ``decode_step`` routes the batch as one group)."""
    if "moe" in lp:
        if cfg.moe_dropless:
            return moe_mod.apply_moe_dropless(lp["moe"], h2, cfg,
                                              tracing.current())
        out, _ = moe_mod.apply_moe(lp["moe"], h2, cfg)
        return out
    return mlp_mod.apply_mlp(lp["mlp"], h2, cfg.mlp_kind)


def _forward(params, cfg: ModelConfig, tokens: torch.Tensor,
             positions: torch.Tensor, attention,
             before_layer=None) -> torch.Tensor:
    """tokens [b, s] at positions [b, s] -> last-pos logits [b, V].  Each
    layer: ``before_layer(layer)`` if given, ln1, q/k/v, the path's
    ``attention(layer, q, k, v)`` -> [b, s, H, hd], wo, ln2, MLP or MoE."""
    x = params["embed"][tokens]
    for i in range(cfg.num_layers):
        if before_layer is not None:
            before_layer(i)
        lp = layer_params(params, cfg, i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = _project_qkv(lp["attn"], h, cfg, positions)
        out = attention(i, q, k, v)
        x = x + dense.einsum("bshk,hkd->bsd", out, lp["attn"]["wo"])
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + _mlp_out(lp, h2, cfg)
    return lm_logits(params, cfg, x[:, -1:, :])[:, 0]


def prefill_collect_kv(params, cfg: ModelConfig, tokens: torch.Tensor
                       ) -> Tuple[torch.Tensor,
                                  List[Tuple[torch.Tensor, torch.Tensor]]]:
    """tokens [b, s] -> (last-pos logits [b, V], [(k, v)] per layer):
    full causal attention over the prompt (dense arch assumption)."""
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    kvs = []

    def attention(i, q, k, v):
        kvs.append((k, v))
        return attend(q, k, v, positions, positions, causal=True,
                      window=cfg.sliding_window)
    return _forward(params, cfg, tokens, positions, attention), kvs


def prefill_over_pages(params, cfg: ModelConfig, tokens: torch.Tensor,
                       n_pre: int, cache: PagedKVCache, seq_id: int,
                       before_layer=None) -> torch.Tensor:
    """tokens [1, s], sequence ``seq_id``'s from position ``n_pre`` on ->
    last-pos logits [1, V]: each layer writes the tokens' K/V into the
    sequence's pages and attends causally over its first n_pre + s rows."""
    s = tokens.shape[1]
    kpos = torch.arange(n_pre + s, dtype=torch.int32,
                        device=tokens.device)[None]
    positions = kpos[:, n_pre:]
    rows = cache.slots_tensor(cache.slots_for(seq_id, np.arange(n_pre))).long()

    def attention(i, q, k, v):
        cache.write_prefill(i, seq_id, k[0], v[0], start_pos=n_pre)
        pk = cache.layer_rows(cache.k_pages, i)[rows][None]
        pv = cache.layer_rows(cache.v_pages, i)[rows][None]
        return attend(q, torch.cat([pk.to(k.dtype), k], dim=1),
                      torch.cat([pv.to(v.dtype), v], dim=1), positions,
                      kpos, causal=True, window=cfg.sliding_window)
    return _forward(params, cfg, tokens, positions, attention, before_layer)


def donor_prefix_kv(params, cfg: ModelConfig,
                    tokens) -> Tuple[np.ndarray, np.ndarray]:
    """Run the donor prefill and stack per-layer K/V into the
    [T, L, K, hd] numpy arrays `KVStore.register_prefix` expects."""
    dev = params["embed"].device
    tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                             device=dev)
    _, kvs = prefill_collect_kv(params, cfg, tokens[None])
    kv_k = torch.stack([k[0] for k, _ in kvs], dim=1)
    kv_v = torch.stack([v[0] for _, v in kvs], dim=1)
    return kv_k.cpu().numpy(), kv_v.cpu().numpy()


def decode_paged(params, cfg: ModelConfig, tokens: torch.Tensor,
                 positions: torch.Tensor, cache: PagedKVCache,
                 seq_ids: List[int]) -> torch.Tensor:
    """One decode step: tokens [b] int at positions [b] int (each
    sequence's new token, at its own position) -> logits [b, V]."""
    dev = cache.device
    host_pos = positions.tolist()
    tokens = tokens.to(dev, torch.long)
    positions = positions.to(dev, torch.int32)
    bt = torch.as_tensor(cache.block_table_array(seq_ids), device=dev)
    context_lens = positions + 1
    # the new tokens' page rows, uploaded once and written for the whole
    # batch per layer (the JAX path writes sequence by sequence)
    slots = cache.slots_tensor(np.concatenate(
        [cache.slots_for(sid, [p]) for sid, p in zip(seq_ids, host_pos)]))

    def attention(i, q, k, v):
        cache.write_rows(i, slots, k[:, 0], v[:, 0])
        return paged_attention(q[:, 0].contiguous(), cache.k_pages[i],
                               cache.v_pages[i], bt, context_lens)[:, None]
    return _forward(params, cfg, tokens[:, None], positions[:, None],
                    attention)
