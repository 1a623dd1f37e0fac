"""Predictive coding over video frames (the H.265 lossless analogue).

Per (frame, channel) plane we pick the cheapest prediction mode by entropy
estimate — TEMPORAL (previous frame, i.e. the paper's inter-frame
prediction along the token axis), LEFT (intra-frame left-neighbor), or RAW
(I-plane) — and emit mod-256 residuals plus a mode map. All modes are
bit-exact invertible. Residuals are zigzag-mapped so small +/- deltas land
on small byte values for the entropy coder.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

MODE_RAW = 0
MODE_TEMPORAL = 1
MODE_LEFT = 2
MODE_NAMES = {0: "raw", 1: "temporal", 2: "left"}

# zigzag LUT: interpret byte as signed delta in [-128, 127], interleave
_s = ((np.arange(256) + 128) % 256).astype(np.int16) - 128
ZIGZAG = np.where(_s >= 0, 2 * _s, -2 * _s - 1).astype(np.uint8)
UNZIGZAG = np.zeros(256, np.uint8)
UNZIGZAG[ZIGZAG] = np.arange(256, dtype=np.uint8)


def _left_residual(plane: np.ndarray) -> np.ndarray:
    r = plane.copy()
    r[:, 1:] = plane[:, 1:] - plane[:, :-1]
    return r


def _left_reconstruct(res: np.ndarray) -> np.ndarray:
    # cumulative sum mod 256 along width
    return np.cumsum(res.astype(np.uint64), axis=1).astype(np.uint8)


def _cost(res: np.ndarray) -> float:
    """Entropy proxy of a residual plane (bits)."""
    z = ZIGZAG[res]
    counts = np.bincount(z.reshape(-1), minlength=256).astype(np.float64)
    p = counts / counts.sum()
    nz = p > 0
    return float(-(counts[nz] * np.log2(p[nz])).sum())


def predict_encode(video: np.ndarray,
                   allow_temporal: bool = True,
                   allow_intra: bool = True
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """video [F, H, W, 3] uint8 -> (zigzagged residuals, modes [F, 3])."""
    F, H, W, C = video.shape
    res = np.empty_like(video)
    modes = np.zeros((F, C), np.uint8)
    for f in range(F):
        for c in range(C):
            plane = video[f, :, :, c]
            cands = [(MODE_RAW, plane)]
            if allow_intra:
                cands.append((MODE_LEFT, _left_residual(plane)))
            if allow_temporal and f > 0:
                cands.append((MODE_TEMPORAL, plane - video[f - 1, :, :, c]))
            best = min(cands, key=lambda mr: _cost(mr[1]))
            modes[f, c] = best[0]
            res[f, :, :, c] = best[1]
    return ZIGZAG[res], modes


def predict_decode(zres: np.ndarray, modes: np.ndarray) -> np.ndarray:
    """Inverse of predict_encode."""
    res = UNZIGZAG[zres]
    F, H, W, C = res.shape
    video = np.empty_like(res)
    for f in range(F):
        for c in range(C):
            m = modes[f, c]
            if m == MODE_RAW:
                video[f, :, :, c] = res[f, :, :, c]
            elif m == MODE_LEFT:
                video[f, :, :, c] = _left_reconstruct(res[f, :, :, c])
            else:  # TEMPORAL: reference frame is the previous decoded frame
                video[f, :, :, c] = video[f - 1, :, :, c] + res[f, :, :, c]
    return video


def predict_decode_frame(zres_f: np.ndarray, modes_f: np.ndarray,
                         prev_frame) -> np.ndarray:
    """Single-frame inverse (frame-wise restoration path).

    zres_f [H, W, 3]; prev_frame [H, W, 3] or None. Memory: one reference
    frame — this is the <=4-reference-frames / frame-wise-buffer property.
    """
    res = UNZIGZAG[zres_f]
    out = np.empty_like(res)
    for c in range(res.shape[-1]):
        m = modes_f[c]
        if m == MODE_RAW:
            out[:, :, c] = res[:, :, c]
        elif m == MODE_LEFT:
            out[:, :, c] = _left_reconstruct(res[:, :, c])
        else:
            assert prev_frame is not None
            out[:, :, c] = prev_frame[:, :, c] + res[:, :, c]
    return out
