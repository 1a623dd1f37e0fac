"""Plain PyTorch version of paged GQA decode attention, in the JAX
oracle's arithmetic: gather the pages, fp32 logits scaled by 1/sqrt(hd),
positions >= context_lens masked with -1e30, softmax, weighted sum.

``split_range`` is the kernel's split of the page axis, and
``paged_attention_split_ref`` its split-and-merge arithmetic, kept for the
tests; no path calls the latter."""
from __future__ import annotations

import math
from typing import Tuple

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


def split_range(n_pages: int, n_split: int, s: int) -> Tuple[int, int]:
    """Logical pages [start, end) that split ``s`` of ``n_split`` takes of
    a sequence with ``n_pages`` valid pages, as the kernel computes them:
    contiguous runs of ceil(n_pages / n_split), empty past the end."""
    per = -(-n_pages // n_split)
    start = min(s * per, n_pages)
    return start, min(start + per, n_pages)


def paged_attention_split_ref(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor,
                              block_tables: torch.Tensor,
                              context_lens: torch.Tensor,
                              n_split: int) -> torch.Tensor:
    """The kernel's split-and-merge arithmetic in plain PyTorch: each
    split's partial (m, l, acc) over its pages, an empty split (m = -inf,
    l = 0) weighing exactly 0 in the merge by exp(m_i - m).  For the
    tests; the card runs ``paged_attention.cu``."""
    B, H, hd = q.shape
    P, ps, K, _ = k_pages.shape
    g = H // K
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty(B, H, hd, dtype=torch.float32)
    for b in range(B):
        ctx = int(context_lens[b])
        n_pages = -(-ctx // ps)
        qb = q[b].to(torch.float32).reshape(K, g, hd)
        parts = []
        for s in range(n_split):
            p0, p1 = split_range(n_pages, n_split, s)
            rows = [int(block_tables[b, t // ps]) * ps + t % ps
                    for t in range(p0 * ps, min(p1 * ps, ctx))]
            if not rows:
                parts.append((torch.full((K, g), -torch.inf),
                              torch.zeros(K, g), torch.zeros(K, g, hd)))
                continue
            idx = torch.tensor(rows)
            k = k_pages.reshape(P * ps, K, hd)[idx].to(torch.float32)
            v = v_pages.reshape(P * ps, K, hd)[idx].to(torch.float32)
            logits = torch.einsum("kgd,tkd->kgt", qb, k) * scale
            m = logits.amax(-1)
            e = torch.exp(logits - m[..., None])
            parts.append((m, e.sum(-1), torch.einsum("kgt,tkd->kgd", e, v)))
        m = torch.stack([p[0] for p in parts]).amax(0)
        l_tot = torch.zeros(K, g)
        acc = torch.zeros(K, g, hd)
        for m_i, l_i, acc_i in parts:
            w = torch.where(m_i == -torch.inf, torch.zeros_like(m_i),
                            torch.exp(m_i - m))
            l_tot = l_tot + w * l_i
            acc = acc + w[..., None] * acc_i
        out[b] = (acc / l_tot.clamp_min(1e-30)[..., None]).reshape(H, hd)
    return out.to(q.dtype)
