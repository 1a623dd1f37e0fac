"""CacheGen-style grouped integer quantization for KV tensors.

Per-(layer, head) symmetric int8 quantization stored as uint8 (offset 128).
This is the only lossy step in the pipeline (identical in spirit to
CacheGen/ShadowServe, as the paper states); everything downstream —
layout, prediction, entropy coding — is bit-exact.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

QOFF = 128


def quantize(kv: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """kv [T, L, H, D] float -> (q uint8 [T,L,H,D], scales fp32 [L,H])."""
    kv = np.asarray(kv, np.float32)
    absmax = np.abs(kv).max(axis=(0, 3))  # [L, H]
    scales = np.maximum(absmax, 1e-8) / 127.0
    q = np.clip(np.rint(kv / scales[None, :, :, None]), -127, 127)
    return (q + QOFF).astype(np.uint8), scales.astype(np.float32)


def dequantize(q: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Inverse of quantize (exact for the stored integers)."""
    return (q.astype(np.float32) - QOFF) * scales[None, :, :, None]
