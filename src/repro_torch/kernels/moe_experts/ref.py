"""Plain PyTorch versions of the dropless grouped expert op.

``moe_experts_ref`` is the op's function, a loop over the experts chosen:
each chosen (token, choice) pair's SwiGLU expert output times its routing
weight, summed over the token's k choices in choice order.  The CPU takes
it.  ``moe_sort_ref`` and ``moe_experts_grouped_ref`` follow the kernel's
own data flow (``moe_experts.cu``): the stable counting sort with its row
tiles, the gate-up product over sorted rows, the down product written at
each choice's row, the combine; the tests hold them against the loop.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F


def moe_experts_ref(x: torch.Tensor, ids: torch.Tensor, wts: torch.Tensor,
                    wi: torch.Tensor, wo: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [n, d]; ids, wts [n, k] (expert and weight of each choice);
    wi [E, d, 2, ff] (gate, up); wo [E, ff, d] -> (out [n, d], the number
    of distinct experts chosen, a one-element int64 tensor)."""
    n, k = ids.shape
    d = x.shape[1]
    ys = x.new_zeros(n * k, d)
    flat, w = ids.reshape(-1), wts.reshape(-1)
    used = torch.unique(flat)
    for e in used.tolist():
        pairs = torch.nonzero(flat == e)[:, 0]
        xt = x[pairs // k]
        h = F.silu(xt @ wi[e, :, 0]) * (xt @ wi[e, :, 1])
        ys[pairs] = (h @ wo[e]) * w[pairs, None]
    return ys.view(n, k, d).sum(1), torch.tensor([len(used)])


class Sorted(NamedTuple):
    """The sort kernel's outputs (int64 here, int32 on the card)."""
    order: torch.Tensor  # [P] the choice at each sorted row
    offsets: torch.Tensor  # [E + 1] each expert's first sorted row
    tile_e: torch.Tensor  # [tiles] each row tile's expert
    tile_r: torch.Tensor  # [tiles] each row tile's first sorted row
    used: int  # experts chosen


def moe_sort_ref(ids: torch.Tensor, E: int, bm: int) -> Sorted:
    """The stable counting sort of ids [P] (token-major choices) by
    expert, and the tiles of at most ``bm`` rows of one expert each, in
    expert order; an expert with no choice has no tile."""
    ids = ids.reshape(-1)
    counts = torch.bincount(ids, minlength=E)
    offsets = torch.zeros(E + 1, dtype=torch.int64)
    offsets[1:] = torch.cumsum(counts, 0)
    order = torch.sort(ids, stable=True).indices
    tile_e, tile_r = [], []
    for e in range(E):
        for r in range(int(offsets[e]), int(offsets[e + 1]), bm):
            tile_e.append(e)
            tile_r.append(r)
    return Sorted(order, offsets, torch.tensor(tile_e, dtype=torch.int64),
                  torch.tensor(tile_r, dtype=torch.int64),
                  int((counts > 0).sum()))


def max_tiles(P: int, E: int, bm: int) -> int:
    """The host's bound on the tiles of P choices over E experts: each
    expert's ceil(c / bm) is at most floor(c / bm) + 1, and a tile holds a
    row."""
    return min(P, P // bm + min(E, P))


def moe_experts_grouped_ref(x: torch.Tensor, ids: torch.Tensor,
                            wts: torch.Tensor, wi: torch.Tensor,
                            wo: torch.Tensor, bm: int) -> torch.Tensor:
    """The op as the kernel computes it, tile by tile: h in sorted order,
    y at each choice's own row, then each token's k rows summed."""
    n, k = ids.shape
    d, ff = x.shape[1], wo.shape[1]
    s = moe_sort_ref(ids, wi.shape[0], bm)
    w = wts.reshape(-1)
    h = x.new_empty(n * k, ff)
    y = x.new_empty(n * k, d)
    for e, r0 in zip(s.tile_e.tolist(), s.tile_r.tolist()):
        rows = torch.arange(r0, min(r0 + bm, int(s.offsets[e + 1])))
        xt = x[s.order[rows] // k]
        h[rows] = F.silu(xt @ wi[e, :, 0]) * (xt @ wi[e, :, 1])
    for e, r0 in zip(s.tile_e.tolist(), s.tile_r.tolist()):
        rows = torch.arange(r0, min(r0 + bm, int(s.offsets[e + 1])))
        pairs = s.order[rows]
        y[pairs] = w[pairs, None] * (h[rows] @ wo[e])
    return y.view(n, k, d).sum(1)
