"""Paged-cache model paths for the live serving engine (decoders whose
layers are all attention: the paper's dense GQA class, LWM/Yi/Llama
families, and the MoE decoders).

``prefill_collect_kv`` runs the prompt and hands back per-layer K/V so the
engine can scatter them into pages; ``decode_paged`` runs one token per
sequence with per-sequence positions (continuous batching) through the
paged-attention kernel.
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


def prefill_collect_kv(params, cfg: ModelConfig, tokens: torch.Tensor
                       ) -> Tuple[torch.Tensor,
                                  List[Tuple[torch.Tensor, torch.Tensor]]]:
    """tokens [b, s] -> (last-pos logits [b, V], [(k, v)] per layer).

    Full causal attention over the prompt (dense arch assumption).
    """
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    x = params["embed"][tokens]
    kvs = []
    for i in range(cfg.num_layers):
        lp = layer_params(params, cfg, i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = _project_qkv(lp["attn"], h, cfg, positions)
        kvs.append((k, v))
        out = attend(q, k, v, positions, positions, causal=True,
                     window=cfg.sliding_window)
        x = x + dense.einsum("bshk,hkd->bsd", out, lp["attn"]["wo"])
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + _mlp_out(lp, h2, cfg)
    return lm_logits(params, cfg, x[:, -1:, :])[:, 0], kvs


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
    """One decode step for a batch of sequences at distinct positions.

    tokens [b] int; positions [b] int (index of the new token).
    Writes the new token's K/V into the pages, then attends over the
    paged cache with the paged-attention kernel. Returns logits [b, V].
    """
    dev = cache.device
    host_pos = positions.tolist()
    tokens = tokens.to(dev, torch.long)
    positions = positions.to(dev, torch.int32)
    x = params["embed"][tokens][:, None, :]  # [b, 1, d]
    pos2 = positions[:, None]
    bt = torch.as_tensor(cache.block_table_array(seq_ids), device=dev)
    context_lens = positions + 1
    # the new tokens' page rows, uploaded once and written for the whole
    # batch per layer (the JAX path writes sequence by sequence)
    slots = cache.slots_tensor(np.concatenate(
        [cache.slots_for(sid, np.asarray([p]))
         for sid, p in zip(seq_ids, host_pos)]))
    for i in range(cfg.num_layers):
        lp = layer_params(params, cfg, i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = _project_qkv(lp["attn"], h, cfg, pos2)
        cache.write_rows(i, slots, k[:, 0], v[:, 0])
        out = paged_attention(q[:, 0].contiguous(), cache.k_pages[i],
                              cache.v_pages[i], bt, context_lens)
        x = x + torch.einsum("bhk,hkd->bd", out, lp["attn"]["wo"])[:, None]
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + _mlp_out(lp, h2, cfg)
    return lm_logits(params, cfg, x)[:, 0]
