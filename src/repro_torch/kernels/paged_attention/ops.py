"""Public paged GQA decode attention op: the plain version on CPU tensors,
the CUDA kernels (``paged_attention.cu``) on CUDA tensors.

On the card the page axis is split across blocks (flash-decoding):
``plan_splits`` picks the number of splits, ``ref.split_range`` gives
each split its pages, and with more than one split a second kernel
merges the partials, so one call launches one or two kernels.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

#: op calls that went through the CUDA kernels so far; a run resets it to
#: 0 and reads it back to show which of its calls used them
launches = 0

#: blocks the split aims for on every SM, and the fewest pages of the
#: longest sequence a split should get
BLOCKS_PER_SM = 2
MIN_PAGES_PER_SPLIT = 2
#: query heads one block serves (``kHeadTile`` in the kernel)
HEAD_TILE = 8
#: the kernel's largest head_dim
MAX_HEAD_DIM = 256

_fn = None


def plan_splits(B: int, H: int, K: int, bps: int, n_sm: int = 132) -> int:
    """Splits of the page axis for a launch over ``B`` sequences, ``K``
    KV heads (``H`` query heads) and block tables ``bps`` pages wide (the
    longest context the host knows without reading the lengths back):
    enough blocks for ``BLOCKS_PER_SM`` on each of ``n_sm`` SMs, but no
    split of the longest sequence shorter than ``MIN_PAGES_PER_SPLIT``."""
    blocks = B * K * math.ceil(H // K / HEAD_TILE)
    want = math.ceil(BLOCKS_PER_SM * n_sm / max(blocks, 1))
    most = math.ceil(bps / MIN_PAGES_PER_SPLIT)
    return max(1, min(want, most))


_sm_count = build.sm_count


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("paged_attention").paged_attention_f32
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k_pages, v_pages, block_tables, context_lens) -> None:
    dev = q.device
    named = (("k_pages", k_pages), ("v_pages", v_pages),
             ("block_tables", block_tables), ("context_lens", context_lens))
    for name, t in (("q", q),) + named:
        if t.device != dev:
            raise ValueError(f"paged_attention: {name} is on {t.device}, "
                             f"q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    if q.dtype != torch.float32 or k_pages.dtype != torch.float32 \
            or v_pages.dtype != torch.float32:
        raise TypeError("paged_attention: the kernel takes float32 q and "
                        f"pages, got {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise TypeError("paged_attention: block_tables and context_lens "
                        "must be int32")
    if q.dim() != 3 or k_pages.dim() != 4 \
            or v_pages.shape != k_pages.shape \
            or k_pages.shape[3] != q.shape[2] \
            or q.shape[1] % k_pages.shape[2] != 0 \
            or block_tables.dim() != 2 \
            or block_tables.shape[0] != q.shape[0] \
            or context_lens.shape != (q.shape[0],):
        raise ValueError(
            f"paged_attention: shapes q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, block_tables "
            f"{tuple(block_tables.shape)}, context_lens "
            f"{tuple(context_lens.shape)} do not match [B, H, hd], "
            f"[P, ps, K, hd] with K | H, [B, bps], [B]")
    if q.shape[2] % 8 != 0:
        raise ValueError("paged_attention: head_dim must be a multiple of 8")
    if q.shape[2] > MAX_HEAD_DIM:
        raise ValueError(f"paged_attention: the kernel takes head_dim up to "
                         f"{MAX_HEAD_DIM}, got {q.shape[2]}")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_attention: pages must be 16-byte aligned")
    if q.data_ptr() % 16:
        raise ValueError("paged_attention: q must be 16-byte aligned")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    context_lens: torch.Tensor) -> torch.Tensor:
    """Decode-time attention of one query token per sequence over a paged
    KV cache.

    q            [B, H, hd]
    k/v_pages    [P, page_size, K, hd]
    block_tables [B, pages_per_seq] int32 (physical page per logical page)
    context_lens [B] int32, each >= 1
    """
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   context_lens)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for {q.device}")
    _check(q, k_pages, v_pages, block_tables, context_lens)
    build.refuse_grad("paged_attention", q, k_pages, v_pages)
    B, H, hd = q.shape
    P, ps, K, _ = k_pages.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    bps = block_tables.shape[1]
    n_split = plan_splits(B, H, K, bps, _sm_count(q.device))
    # fp32 partials (acc [n_split, B, H, hd], then m and l), merged by the
    # second kernel; one split writes the output directly
    scratch = torch.empty(n_split * B * H * (hd + 2) if n_split > 1 else 0,
                          dtype=torch.float32, device=q.device)
    err = _launcher()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                      block_tables.data_ptr(), context_lens.data_ptr(),
                      out.data_ptr(), scratch.data_ptr(), B, H, K, hd, P, ps,
                      bps, n_split, q.device.index,
                      torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_attention")
    global launches
    launches += 1
    return out
