"""Free-list page allocator (host-side bookkeeping for the paged cache)."""
from __future__ import annotations

from typing import Dict, List


class PageAllocator:
    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self.free: List[int] = list(range(n_pages - 1, -1, -1))
        self.owned: Dict[int, List[int]] = {}  # seq id -> pages

    @property
    def n_free(self) -> int:
        return len(self.free)

    def allocate(self, seq_id: int, n: int) -> List[int]:
        if n > len(self.free):
            raise MemoryError(
                f"paged cache OOM: want {n} pages, {len(self.free)} free")
        pages = [self.free.pop() for _ in range(n)]
        self.owned.setdefault(seq_id, []).extend(pages)
        return pages

    def extend(self, seq_id: int, n: int) -> List[int]:
        return self.allocate(seq_id, n)

    def release(self, seq_id: int) -> None:
        for p in self.owned.pop(seq_id, []):
            self.free.append(p)
