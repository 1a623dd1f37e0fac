"""Paged KV cache (vLLM-style) for dense-attention models.

Device state: k_pages / v_pages [L, P, page_size, K, hd]; host state: the
allocator + per-sequence block tables.  Writes happen through
  - ``write_prefill``: bulk scatter of freshly computed K/V, and
  - ``restore_tokens``: the frame-wise fused dequant+scatter kernel
    (repro_torch.kernels.kv_restore), i.e. the paper's
    Sparse_frame_KV_transfer.

Unlike the JAX cache, which rebuilds a whole layer with ``.at[].set`` on
every write (its arrays are immutable), every write here updates the page
tensors in place through a ``[P * page_size, K, hd]`` view of one layer.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.kv_restore.ops import kv_restore
from repro_torch.paged.allocator import PageAllocator


@dataclasses.dataclass
class SeqInfo:
    seq_id: int
    block_table: List[int]
    context_len: int = 0


class PagedKVCache:
    def __init__(self, cfg: ModelConfig, n_pages: int, page_size: int = 16,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.page_size = page_size
        self.n_pages = n_pages
        self.device = resolve_device(device)
        L = cfg.num_layers
        K, hd = cfg.num_kv_heads, cfg.head_dim
        shape = (L, n_pages, page_size, K, hd)
        self.k_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self.alloc = PageAllocator(n_pages)
        self.seqs: Dict[int, SeqInfo] = {}

    # -- sequence lifecycle ------------------------------------------------
    def add_seq(self, seq_id: int, n_tokens: int) -> SeqInfo:
        n = -(-n_tokens // self.page_size)
        pages = self.alloc.allocate(seq_id, n)
        info = SeqInfo(seq_id, pages, 0)
        self.seqs[seq_id] = info
        return info

    def ensure_capacity(self, seq_id: int, n_tokens: int) -> None:
        info = self.seqs[seq_id]
        need = -(-n_tokens // self.page_size)
        if need > len(info.block_table):
            info.block_table.extend(
                self.alloc.extend(seq_id, need - len(info.block_table)))

    def free_seq(self, seq_id: int) -> None:
        self.alloc.release(seq_id)
        self.seqs.pop(seq_id, None)

    # -- slot math -----------------------------------------------------------
    def slots_for(self, seq_id: int, positions: np.ndarray) -> np.ndarray:
        """Logical token positions -> physical page rows (flat)."""
        info = self.seqs[seq_id]
        bt = np.asarray(info.block_table)
        positions = np.asarray(positions)
        if positions.size and (positions.min() < 0 or positions.max()
                               >= len(bt) * self.page_size):
            raise IndexError(
                f"seq {seq_id}: positions outside its "
                f"{len(bt) * self.page_size} allocated rows")
        return bt[positions // self.page_size] * self.page_size + \
            positions % self.page_size

    def block_table_array(self, seq_ids: List[int],
                          max_pages: Optional[int] = None) -> np.ndarray:
        """[len(seq_ids), max_pages] int32; short tables are zero-padded
        (padded entries point at page 0 and lie past the context)."""
        mp = max_pages or max(len(self.seqs[s].block_table)
                              for s in seq_ids)
        out = np.zeros((len(seq_ids), mp), np.int32)
        for i, s in enumerate(seq_ids):
            bt = self.seqs[s].block_table
            out[i, :len(bt)] = bt
        return out

    # -- device writes -------------------------------------------------------
    def layer_rows(self, pages: torch.Tensor, layer: int) -> torch.Tensor:
        """In-place view [P * page_size, K, hd] of one layer's pages."""
        return pages[layer].view(self.n_pages * self.page_size,
                                 *pages.shape[3:])

    def slots_tensor(self, slots: np.ndarray) -> torch.Tensor:
        """Host page rows -> int32 tensor on the cache's device."""
        return torch.as_tensor(np.asarray(slots, np.int32),
                               device=self.device)

    def write_rows(self, layer: int, slots: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> None:
        """k/v [n, K, hd] into the page rows ``slots`` [n] of ``layer``."""
        idx = slots.long()
        rows_k = self.layer_rows(self.k_pages, layer)
        rows_v = self.layer_rows(self.v_pages, layer)
        rows_k[idx] = k.to(rows_k.dtype)
        rows_v[idx] = v.to(rows_v.dtype)

    def write_prefill(self, layer: int, seq_id: int, k: torch.Tensor,
                      v: torch.Tensor, start_pos: int = 0) -> None:
        """k/v [s, K, hd] computed by a prefill pass."""
        s = k.shape[0]
        positions = np.arange(start_pos, start_pos + s)
        slots = self.slots_tensor(self.slots_for(seq_id, positions))
        self.write_rows(layer, slots, k, v)

    def write_decode_token(self, layer: int, seq_id: int, pos: int,
                           k: torch.Tensor, v: torch.Tensor) -> None:
        self.write_prefill(layer, seq_id, k[None], v[None], start_pos=pos)

    def restore_tokens(self, layer: int, kind: str, seq_id: int,
                       token_ids: np.ndarray, q_tokens: torch.Tensor,
                       scales: torch.Tensor) -> None:
        """Frame-wise restoration: decoded uint8 tokens -> page rows.

        q_tokens [n, K, hd] uint8 (one layer, one frame); scales [K] fp32;
        both on the cache's device.
        """
        slots = self.slots_tensor(self.slots_for(seq_id,
                                                  np.asarray(token_ids)))
        pages = self.k_pages if kind == "k" else self.v_pages
        kv_restore(self.layer_rows(pages, layer), q_tokens, scales, slots)
