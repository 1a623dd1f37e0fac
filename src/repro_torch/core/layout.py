"""Codec-friendly tensor layout (paper §3.2).

Inter-frame layout: a KV chunk is T token-slices of 3 layers; token t maps
to frame ``t % F`` at slot ``t // F`` so consecutive tokens occupy the same
spatial position in consecutive frames (maximal temporal redundancy), and
the 3 layers map to the 3 independently-coded color channels.

Intra-frame layout: per token/layer the [H, D] matrix is tiled as
``(hr, hc) x (dr, dc)`` with ``hr*hc == H``, ``dr*dc == D`` — head blocks
stay contiguous (rule i), within-head element order is preserved (rule ii),
head order is untouched (rule iii), so the search space is the
O(log H x log D) grid of power-of-two splits (paper Fig. 14).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

import numpy as np

# (height, width) pixel budgets; names follow the paper's presets.
RESOLUTIONS: Dict[str, Tuple[int, int]] = {
    "240p": (240, 432),
    "480p": (480, 854),
    "640p": (640, 960),
    "1080p": (1080, 1920),
}
RESOLUTION_ORDER = ("240p", "480p", "640p", "1080p")


@dataclasses.dataclass(frozen=True)
class IntraLayout:
    """Power-of-two split of (H, D) into a (hr*dr, hc*dc) tile."""
    H: int
    D: int
    hr: int  # head rows   (hc = H // hr heads per row)
    dr: int  # dim rows    (dc = D // dr dims per row)

    @property
    def hc(self) -> int:
        return self.H // self.hr

    @property
    def dc(self) -> int:
        return self.D // self.dr

    @property
    def tile(self) -> Tuple[int, int]:
        return self.hr * self.dr, self.hc * self.dc


def pow2_divisors(n: int) -> List[int]:
    out = [1]
    d = 2
    while n % d == 0:
        out.append(d)
        d *= 2
    return out


def intra_candidates(H: int, D: int) -> List[IntraLayout]:
    """The O(log H x log D) candidate grid of rules i-iii."""
    return [IntraLayout(H, D, hr, dr)
            for hr in pow2_divisors(H) for dr in pow2_divisors(D)]


def tile_forward(x: np.ndarray, lay: IntraLayout) -> np.ndarray:
    """[..., H, D] -> [..., hr*dr, hc*dc]."""
    lead = x.shape[:-2]
    x = x.reshape(lead + (lay.hr, lay.hc, lay.dr, lay.dc))
    x = np.moveaxis(x, -3, -2)  # -> [..., hr, dr, hc, dc]
    return x.reshape(lead + (lay.hr * lay.dr, lay.hc * lay.dc))


def tile_inverse(t: np.ndarray, lay: IntraLayout) -> np.ndarray:
    lead = t.shape[:-2]
    t = t.reshape(lead + (lay.hr, lay.dr, lay.hc, lay.dc))
    t = np.moveaxis(t, -2, -3)
    return t.reshape(lead + (lay.H, lay.D))


# ---------------------------------------------------------------------------
# Frame packing (inter-frame layout)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FrameGeometry:
    resolution: str
    tile: Tuple[int, int]
    grid: Tuple[int, int]  # tiles per frame (gh, gw)
    n_frames: int
    n_tokens: int

    @property
    def slots_per_frame(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def frame_shape(self) -> Tuple[int, int, int]:
        th, tw = self.tile
        return self.grid[0] * th, self.grid[1] * tw, 3

    def token_of(self, frame: int, slot: int) -> int:
        return slot * self.n_frames + frame

    def tokens_in_frame(self, frame: int) -> np.ndarray:
        toks = frame + self.n_frames * np.arange(self.slots_per_frame)
        return toks[toks < self.n_tokens]


def layout_fits(lay: IntraLayout, resolution: str) -> bool:
    fh, fw = RESOLUTIONS[resolution]
    th, tw = lay.tile
    return th <= fh and tw <= fw


def frame_geometry(n_tokens: int, lay: IntraLayout,
                   resolution: str) -> FrameGeometry:
    """Frame geometry for a chunk: F frames on a (gh, gw) tile grid.

    The grid is cropped to the slots actually used, so short chunks don't
    pay entropy/transmission for padding pixels (a real encoder would crop
    the canvas the same way; decode-latency tables key on the resolution
    preset, i.e. the upper bound).
    """
    fh, fw = RESOLUTIONS[resolution]
    th, tw = lay.tile
    gh, gw = max(fh // th, 1), max(fw // tw, 1)
    slots = gh * gw
    n_frames = max(1, -(-n_tokens // slots))
    used = -(-n_tokens // n_frames)  # slots needed per frame
    gw = min(gw, used)
    gh = -(-used // gw)
    return FrameGeometry(resolution, (th, tw), (gh, gw), n_frames, n_tokens)


def pack_frames(q_chunk: np.ndarray, lay: IntraLayout,
                geom: FrameGeometry) -> np.ndarray:
    """q_chunk [T, 3, H, D] uint8 -> video [F, FH, FW, 3] uint8."""
    T = q_chunk.shape[0]
    F = geom.n_frames
    gh, gw = geom.grid
    th, tw = geom.tile
    slots = gh * gw
    tiles = tile_forward(q_chunk, lay)  # [T, 3, th, tw]
    pad = slots * F - T
    if pad:
        tiles = np.concatenate(
            [tiles, np.zeros((pad,) + tiles.shape[1:], np.uint8)], axis=0)
    # token t -> (slot=t//F, frame=t%F)
    tiles = tiles.reshape(slots, F, 3, th, tw)
    tiles = tiles.reshape(gh, gw, F, 3, th, tw)
    video = tiles.transpose(2, 0, 4, 1, 5, 3)  # [F, gh, th, gw, tw, 3]
    return np.ascontiguousarray(
        video.reshape(F, gh * th, gw * tw, 3))


def unpack_frames(video: np.ndarray, lay: IntraLayout,
                  geom: FrameGeometry) -> np.ndarray:
    """Inverse of pack_frames -> [T, 3, H, D] uint8."""
    F = geom.n_frames
    gh, gw = geom.grid
    th, tw = geom.tile
    v = video.reshape(F, gh, th, gw, tw, 3)
    tiles = v.transpose(1, 3, 0, 5, 2, 4)  # [gh, gw, F, 3, th, tw]
    tiles = tiles.reshape(gh * gw * F, 3, th, tw)[:geom.n_tokens]
    return tile_inverse(tiles, lay)


def unpack_single_frame(frame: np.ndarray, lay: IntraLayout,
                        geom: FrameGeometry, frame_idx: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """One decoded frame -> (token_ids, q_tokens [n, 3, H, D]).

    This is the frame-wise restoration primitive: memory is one frame.
    """
    gh, gw = geom.grid
    th, tw = geom.tile
    v = frame.reshape(gh, th, gw, tw, 3)
    tiles = v.transpose(0, 2, 4, 1, 3).reshape(gh * gw, 3, th, tw)
    toks = geom.tokens_in_frame(frame_idx)
    slots = (toks - frame_idx) // geom.n_frames
    return toks, tile_inverse(tiles[slots], lay)


# ---------------------------------------------------------------------------
# Baseline layouts (for benchmark comparisons; see bench_slicing)
# ---------------------------------------------------------------------------

def layer_slice_frames(q: np.ndarray) -> np.ndarray:
    """llm.265-style: slice along layers; frame f = layers [3f, 3f+3) as
    [T, H*D, 3]."""
    T, L, H, D = q.shape
    L3 = (L // 3) * 3
    v = q[:, :L3].reshape(T, L3 // 3, 3, H * D)
    return np.ascontiguousarray(v.transpose(1, 0, 3, 2))  # [F, T, HD, 3]


def head_slice_frames(q: np.ndarray) -> np.ndarray:
    """Slice along heads: frame h = head h as [T, L*D] replicated to 3ch."""
    T, L, H, D = q.shape
    v = q.transpose(2, 0, 1, 3).reshape(H, T, L * D)
    return np.repeat(v[..., None], 3, axis=-1)


def token_stitched_single_frame(q_chunk: np.ndarray,
                                lay: IntraLayout) -> np.ndarray:
    """Fig. 12 baseline: all token tiles stitched spatially in ONE frame."""
    tiles = tile_forward(q_chunk, lay)  # [T, 3, th, tw]
    T = tiles.shape[0]
    cols = int(np.ceil(np.sqrt(T)))
    rows = -(-T // cols)
    th, tw = lay.tile
    out = np.zeros((1, rows * th, cols * tw, 3), np.uint8)
    for t in range(T):
        r, c = divmod(t, cols)
        out[0, r * th:(r + 1) * th, c * tw:(c + 1) * tw] = \
            tiles[t].transpose(1, 2, 0)
    return out
