"""Paged KV cache (vLLM-style) for dense-attention models.

Device state: k_pages / v_pages [L, P, page_size, K, hd]; host state: the
allocator + per-sequence block tables.  Writes happen through
  - ``write_prefill``: bulk scatter of freshly computed K/V, and
  - ``restore_chunk``: the fused dequant+scatter kernel
    (repro_torch.kernels.kv_restore), i.e. the paper's
    Sparse_frame_KV_transfer, for every layer of a fetched chunk's group
    in one launch; ``restore_tokens`` is the JAX cache's one-layer form.

Unlike the JAX cache, which rebuilds a whole layer with ``.at[].set`` on
every write (its arrays are immutable), every write here updates the page
tensors in place through views of the page tensors.

On the card a chunk's decoded tokens and page rows travel through a small
ring of pinned host buffers (``StagingRing``) with asynchronous copies, so
the host never waits for the card to restore a chunk; it waits only before
it writes a buffer whose last launch has not run yet.

``shard`` lays the pages out over a device mesh: ``k_dtensor`` and
``v_dtensor`` are then ``DTensor`` views of the page tensors (the same
storage), while every write, the kernels and the paged model keep using
the plain tensors ``k_pages``/``v_pages``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.kv_restore.ops import kv_restore_layers
from repro_torch.paged.allocator import PageAllocator


@dataclasses.dataclass
class SeqInfo:
    seq_id: int
    block_table: List[int]
    context_len: int = 0


class StagingRing:
    """A small ring of pinned host buffers that carry chunks' decoded
    tokens (uint8) and page rows (int32) to the card.

    Each buffer is copied on the current stream with ``non_blocking=True``
    and guarded by a CUDA event recorded after the launch that reads it;
    the host waits on that event only before it writes the buffer again.
    A pinned allocation that fails raises."""

    def __init__(self, device: torch.device, depth: int = 2):
        self.device = device
        self.tokens: List[torch.Tensor] = []  # pinned uint8 [capacity]
        self.rows: List[torch.Tensor] = []  # pinned int32 [capacity]
        self.events = [torch.cuda.Event() for _ in range(depth)]
        self._next = 0

    def reserve(self, n_bytes: int, n_rows: int) -> None:
        """Grow every buffer to at least ``n_bytes`` tokens and ``n_rows``
        rows, after the launches that read the old ones."""
        if self.tokens and n_bytes <= self.tokens[0].numel() \
                and n_rows <= self.rows[0].numel():
            return
        for ev in self.events:
            ev.synchronize()
        if self.tokens:
            n_bytes = max(n_bytes, self.tokens[0].numel())
            n_rows = max(n_rows, self.rows[0].numel())
        depth = len(self.events)
        self.tokens = [torch.empty(n_bytes, dtype=torch.uint8,
                                   pin_memory=True) for _ in range(depth)]
        self.rows = [torch.empty(n_rows, dtype=torch.int32, pin_memory=True)
                     for _ in range(depth)]

    def take(self, n_bytes: int, n_rows: int) -> int:
        """The next buffer's index, once its last launch has read it."""
        self.reserve(n_bytes, n_rows)
        i = self._next
        self._next = (i + 1) % len(self.events)
        self.events[i].synchronize()
        return i

    def owner(self, t: torch.Tensor) -> Optional[int]:
        """The buffer that ``t`` is a view of, if any."""
        if t.device.type != "cpu":
            return None
        for i, buf in enumerate(self.tokens):
            if buf.data_ptr() <= t.data_ptr() < buf.data_ptr() + buf.numel():
                return i
        return None

    def release(self, i: int) -> None:
        """Mark buffer ``i`` as read by the work queued so far."""
        self.events[i].record(torch.cuda.current_stream(self.device))


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
        self.staging = (StagingRing(self.device)
                        if self.device.type == "cuda" else None)
        self.k_dtensor: Optional[DTensor] = None
        self.v_dtensor: Optional[DTensor] = None

    def shard(self, mesh, placements) -> None:
        """Expose the pages as ``DTensor``s on ``mesh`` with
        ``placements``, built from the local tensors without a collective
        and sharing their storage.  This rank holds every page, so a dim
        may only be sharded over mesh dims of size 1."""
        split = [mesh.shape[d] for d, p in enumerate(placements)
                 if p.is_shard() and mesh.shape[d] > 1]
        if split:
            raise ValueError(
                f"placements {tuple(placements)} split the pages over mesh "
                f"dims of sizes {split}; this cache holds every page on "
                f"one rank")
        self.k_dtensor = DTensor.from_local(self.k_pages, mesh, placements,
                                            run_check=False)
        self.v_dtensor = DTensor.from_local(self.v_pages, mesh, placements,
                                            run_check=False)

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

    def kind_rows(self, kind: str) -> torch.Tensor:
        """In-place view [L, P * page_size, K, hd] of one kind's pages."""
        pages = self.k_pages if kind == "k" else self.v_pages
        return pages.view(pages.shape[0], self.n_pages * self.page_size,
                          *pages.shape[3:])

    def reserve_staging(self, n_layers: int, n_tokens: int) -> None:
        """Size the staging ring for chunks of up to ``n_layers`` layers x
        ``n_tokens`` tokens (a no-op on the CPU)."""
        if self.staging is not None:
            self.staging.reserve(n_layers * n_tokens * self.cfg.num_kv_heads
                                 * self.cfg.head_dim, n_tokens)

    def staging_buffer(self, n_layers: int, n_tokens: int) -> torch.Tensor:
        """A host buffer [n_layers, n_tokens, K, hd] uint8 for one chunk's
        decoded tokens, layer-major, to hand to ``restore_chunk``: the next
        buffer of the pinned ring when the cache is on the card, else a
        plain tensor on the CPU."""
        shape = (n_layers, n_tokens, self.cfg.num_kv_heads,
                 self.cfg.head_dim)
        if self.staging is None:
            return torch.empty(shape, dtype=torch.uint8)
        n_bytes = n_layers * n_tokens * shape[2] * shape[3]
        i = self.staging.take(n_bytes, n_tokens)
        return self.staging.tokens[i][:n_bytes].view(shape)

    def restore_chunk(self, kind: str, seq_id: int, layers: Sequence[int],
                      token_ids: np.ndarray, q_tokens: torch.Tensor,
                      scales: torch.Tensor) -> None:
        """Restore one fetched chunk into every layer of its group with one
        ``kv_restore_layers`` launch.

        q_tokens [G, n, K, hd] uint8, layer-major: on the cache's device,
        or a ``staging_buffer`` (copied to the card asynchronously);
        scales [G, K] fp32 on the cache's device; token_ids [n] logical
        positions of the sequence, shared by the G layers ``layers``.
        """
        slots = self.slots_for(seq_id, np.asarray(token_ids)).astype(
            np.int32)
        rows = self.kind_rows(kind)
        if self.staging is None:
            kv_restore_layers(rows, layers, q_tokens, scales,
                              torch.from_numpy(slots))
            return
        i = self.staging.owner(q_tokens)
        if i is None:
            i = self.staging.take(0, len(slots))
        host_slots = self.staging.rows[i][:len(slots)]
        host_slots.numpy()[:] = slots
        kv_restore_layers(rows, layers,
                          q_tokens.to(self.device, non_blocking=True),
                          scales, host_slots.to(self.device,
                                                non_blocking=True))
        self.staging.release(i)

    def restore_tokens(self, layer: int, kind: str, seq_id: int,
                       token_ids: np.ndarray, q_tokens: torch.Tensor,
                       scales: torch.Tensor) -> None:
        """Frame-wise restoration of one layer (the JAX cache's method):
        q_tokens [n, K, hd] uint8 (one layer, one frame); scales [K]
        fp32; both on the cache's device."""
        self.restore_chunk(kind, seq_id, (layer,), token_ids, q_tokens[None],
                           scales[None])
