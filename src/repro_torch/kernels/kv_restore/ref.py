"""Plain PyTorch version of the fused KV restoration op.

restore = dequantize(uint8 tokens) -> scatter into paged KV memory rows,
in the same fp32 arithmetic as the kernel: ``(q - 128) * scale``, then a
cast to the page dtype.  A token whose slot is negative is dropped and its
row left untouched (the JAX oracle instead rewrites row 0 with its old
value, which races with a real token in slot 0 on a parallel device).
"""
from __future__ import annotations

import torch

QOFF = 128.0


def kv_restore_ref(pages: torch.Tensor, q_tokens: torch.Tensor,
                   scales: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """pages [R, H, D] float, updated in place and returned;
    q_tokens [n, H, D] uint8; scales [H] fp32; slots [n] int (row index
    into pages, < R; negative drops the token)."""
    deq = (q_tokens.to(torch.float32) - QOFF) * scales[None, :, None]
    keep = slots >= 0
    pages[slots[keep].long()] = deq[keep].to(pages.dtype)
    return pages
