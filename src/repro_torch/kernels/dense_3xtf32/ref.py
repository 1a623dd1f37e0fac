"""Plain PyTorch versions of the dense 3xTF32 product.

``dense_ref`` is the op's function, ``x @ w`` for each weight in fp32; the
CPU takes it.  ``dense_3xtf32_emulated`` repeats the kernel's split
(``dense_3xtf32.cu``): a weight's high part is the weight rounded to
nearest TF32 (``tf32_round``, what the kernel's Veltkamp split gives), its
low part the remainder as the tensor cores read it, cut to TF32
(``ssd_scan``'s ``tf32_truncate``); x's high part is its truncation, which
the tensor cores read from x itself, its low part the remainder rounded.
x_lo w_hi + x_hi w_lo + x_hi w_hi are summed in fp32, x_lo w_lo dropped.
The tests hold it against an fp64 product.  ``ssd_scan``'s emulation
(``mm_3xtf32``) truncates every part; rounding one part of each operand
halves the split's error and takes away its bias, which a 4,096-deep
product needs to stay as close to fp64 as cuBLAS's fp32 product is.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.kernels.ssd_scan.ref import tf32_truncate


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32 (the sign, the exponent and the top 10
    mantissa bits), to nearest with ties to even."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0xFFF + ((bits >> 13) & 1)) & -0x2000).view(
        torch.float32)


def mm_3xtf32_split(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w from the TF32 parts, as the kernel forms it."""
    xh = tf32_truncate(x)
    xl = tf32_round(x - xh)
    wh = tf32_round(w)
    wl = tf32_truncate(w - wh)
    return xl @ wh + xh @ wl + xh @ wh


def dense_ref(x: torch.Tensor, ws: Sequence[torch.Tensor]
              ) -> Tuple[torch.Tensor, ...]:
    """x [M, K]; ws weights [K, N_i] -> (x @ w_i for each)."""
    return tuple(x @ w for w in ws)


def dense_3xtf32_emulated(x: torch.Tensor, ws: Sequence[torch.Tensor]
                          ) -> Tuple[torch.Tensor, ...]:
    """``dense_ref`` as the kernel's tensor cores form it (3xTF32)."""
    return tuple(mm_3xtf32_split(x, w) for w in ws)
