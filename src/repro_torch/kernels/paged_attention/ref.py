"""Plain PyTorch version of paged GQA decode attention, in the JAX
oracle's arithmetic: gather the pages, fp32 logits scaled by 1/sqrt(hd),
positions >= context_lens masked with -1e30, softmax, weighted sum."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_tables: torch.Tensor,
                        context_lens: torch.Tensor) -> torch.Tensor:
    """q [B, H, hd]; k/v_pages [P, ps, K, hd]; block_tables [B, bps];
    context_lens [B] -> out [B, H, hd] in q's dtype."""
    B, H, hd = q.shape
    P, ps, K, _ = k_pages.shape
    bps = block_tables.shape[1]
    g = H // K
    bt = block_tables.long()
    # gather each sequence's pages -> [B, bps*ps, K, hd]
    k = k_pages[bt].reshape(B, bps * ps, K, hd)
    v = v_pages[bt].reshape(B, bps * ps, K, hd)
    qg = q.reshape(B, K, g, hd)
    logits = torch.einsum("bkgd,bskd->bkgs", qg.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(hd)
    pos = torch.arange(bps * ps, device=q.device)[None]
    valid = (pos < context_lens[:, None].long())[:, None, None]
    logits = torch.where(valid, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    w = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", w, v.to(torch.float32))
    return out.reshape(B, H, hd).to(q.dtype)
