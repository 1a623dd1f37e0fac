"""Plain PyTorch version of the fused KV restoration op.

restore = dequantize(uint8 tokens) -> scatter into paged KV memory rows,
in the same fp32 arithmetic as the kernel: ``(q - 128) * scale``, then a
cast to the page dtype.  A token whose slot is negative is dropped and its
row left untouched (the JAX oracle instead rewrites row 0 with its old
value, which races with a real token in slot 0 on a parallel device).
"""
from __future__ import annotations

from typing import Sequence

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


def kv_restore_layers_ref(pages: torch.Tensor, layers: Sequence[int],
                          q_tokens: torch.Tensor, scales: torch.Tensor,
                          slots: torch.Tensor) -> torch.Tensor:
    """``kv_restore_ref`` layer by layer on views of ``pages`` [L, R, H, D]:
    q_tokens [G, n, H, D] and scales [G, H] go to the layers ``layers``
    (G ids), with the slots [n] shared by all of them."""
    for g, layer in enumerate(layers):
        kv_restore_ref(pages[int(layer)], q_tokens[g], scales[g], slots)
    return pages
